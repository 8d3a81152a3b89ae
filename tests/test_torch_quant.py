"""PyTorch port, the int8 family against the JAX package: the quantize
codec and the quantized ops (``ops/quantize_ops.py``), calibration and
``CalibTable`` (``quant/calib.py``), the quantization passes and the flow
(``quant/``), the reference-signature entry points
(``contrib/quantization.py``), the serving stack's int8 tier and the
``quantize_mlp`` recipe twin.

Tolerances: integer outputs (int8 codes, int32 accumulators) bitwise;
float outputs bitwise where both packages compute the same float
operations in the same order (the codecs, the range scalars: the port
reassociates as XLA does), else within 1e-6 relative; graphs node for
node (name, op, attributes, wiring). The int8 op grid is
``chip_smoke.quant_op_cases`` (the card's test runs the same cases); the
JAX side of it is one ``jax.jit``, computed once a test run.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import interop as jinterop
from mxnet_tpu import quant as jquant
from mxnet_tpu.contrib import quantization as jcq
from mxnet_tpu_torch import interop, quant
from mxnet_tpu_torch.contrib import quantization as cq
from mxnet_tpu_torch.ops import quantize_ops as qops
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke.py", "chip_smoke_quant")


def _jax_cases():
    """Every case of the grid through the JAX registry, in one jit."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get_op
    cases = cs.quant_op_cases()

    def run(all_inputs):
        outs = []
        for (_, op, _, attrs), ins in zip(cases, all_inputs):
            o = get_op(op).fn(*ins, **attrs)
            outs.append(o if isinstance(o, tuple) else (o,))
        return outs

    got = jax.jit(run)([[jnp.asarray(v) for v in c[2]] for c in cases])
    return [[np.asarray(o) for o in outs] for outs in got]


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    return once(tmp_path_factory, "quant-op-cases", _jax_cases)


def _same(got, want, rtol=0.0):
    """dtype and shape equal; integers bitwise, floats within ``rtol`` of
    the largest |value|."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not np.issubdtype(want.dtype, np.floating) or rtol == 0.0:
        return np.array_equal(got, want)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= rtol * scale


def test_int8_ops_match_jax_bitwise(jax_cases):
    """The eight int8 ops over the grid (degenerate and all-negative
    ranges, no bias, groups, dilation, strides, 1-D, channel-last, concat
    of unequal ranges), bitwise against the JAX ops; and the card's exact
    product (im2col + ``torch._int_mm``, padded), run here on the CPU,
    bitwise the float64 product."""
    failed = []
    for (cid, op, inputs, attrs), want in zip(cs.quant_op_cases(),
                                              jax_cases):
        got = cs.run_quant_case(op, inputs, attrs)
        if len(got) != len(want) or not all(
                _same(g, w) for g, w in zip(got, want)):
            failed.append(cid)
        if op == "_contrib_quantized_conv" \
                and attrs.get("layout") in (None, "NCW"):
            nd = len(attrs["kernel"])
            x, w = (torch.from_numpy(np.asarray(v)) for v in inputs[:2])

            def spatial(k, d):
                return tuple(attrs.get(k) or (d,) * nd)

            args = (spatial("stride", 1), spatial("pad", 0),
                    spatial("dilate", 1), int(attrs.get("num_group", 1)))
            if not torch.equal(qops._int_conv_mm(x, w, *args),
                               qops._int_conv(x, w, *args)):
                failed.append(cid + ":int_mm")
        if op == "_contrib_quantized_fully_connected":
            x = torch.from_numpy(inputs[0]).reshape(inputs[0].shape[0], -1)
            w = torch.from_numpy(inputs[1])
            if x.shape[1] == w.shape[1] and not torch.equal(
                    qops._int_mm_card(x, w), qops._int_matmul(x, w)):
                failed.append(cid + ":int_mm")
    assert not failed, failed


# ------------------------------------------------------------- the flow
def _net(S):
    """A small classifier of every quantizable kind: a convolution, a
    grouped and dilated one, pooling, two fully connected layers."""
    h = S.sym.Convolution(S.sym.Variable("data"), num_filter=8,
                          kernel=(3, 3), pad=(1, 1), name="conv0")
    h = S.sym.Activation(h, act_type="relu", name="relu0")
    h = S.sym.Convolution(h, num_filter=8, kernel=(3, 3), pad=(2, 2),
                          dilate=(2, 2), num_group=2, name="conv1")
    h = S.sym.Activation(h, act_type="relu", name="relu1")
    h = S.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool0")
    h = S.sym.FullyConnected(S.sym.Flatten(h, name="flat"), num_hidden=12,
                             name="fc0")
    h = S.sym.Activation(h, act_type="relu", name="relu2")
    return S.sym.FullyConnected(h, num_hidden=5, name="fc1")


def _values():
    rs = np.random.RandomState(7)
    shapes, _, _ = _net(mx).infer_shape(data=(8, 3, 8, 8))
    names = _net(mx).list_arguments()
    vals = {n: rs.uniform(-0.4, 0.4, s).astype("f")
            for n, s in zip(names, shapes) if n != "data"}
    x = rs.uniform(-1, 1, (16, 3, 8, 8)).astype("f")
    return vals, x


def _signature(sym):
    return [(n.name, n.op, sorted((n.attrs or {}).items()),
             [(s.name, i) for s, i in n.inputs]) for n in sym.topo_nodes()]


def _internals(pkg, sym, params, x):
    """Every graph entry of ``sym`` on ``x`` (numpy), on the CPU."""
    internals = sym.get_internals()
    args = {k: v for k, v in params.items()
            if k in internals.list_arguments()}
    args["data"] = pkg.nd.array(x)
    outs = internals.bind(pkg.cpu(), args, grad_req="null").forward()
    return dict(zip(internals.list_outputs(), (o.asnumpy() for o in outs)))


def _params(pkg, vals):
    return {k: pkg.nd.array(v) for k, v in vals.items()}


def test_quantize_flow_matches_jax(tmp_path):
    """Calibration (naive and entropy) against the JAX package's, the
    ``CalibTable`` JSON read both ways, the pass route and the direct
    route against the JAX package's (graphs node for node, extra
    parameters bitwise, every entry of an int8 graph bitwise), the two
    routes equal in the port, a quantized graph's JSON and reference
    ``.params`` carried across both ways, ``evaluate_agreement``, and the
    ``quantize_mlp`` twin against the JAX recipe."""
    vals, x = _values()
    with mx.cpu():
        jsym, psym = _net(jmx), _net(mx)
        jarg, parg = _params(jmx, vals), _params(mx, vals)
        batches = [x[:8], x[8:]]
        tables = {}
        for mode in ("naive", "entropy"):
            jt = jquant.collect(jsym, jarg, {}, [jmx.nd.array(b)
                                                 for b in batches],
                                mode=mode)
            pt = quant.collect(psym, parg, {}, [mx.nd.array(b)
                                                for b in batches],
                               mode=mode)
            assert sorted(jt.ranges) == sorted(pt.ranges)
            for name, (lo, hi) in jt.ranges.items():
                plo, phi = pt.ranges[name]
                # the data itself: equal; later layers: the float layers'
                # rounding (naive), one step of the threshold search
                # (entropy: 8001 // 64 bins of |max|/8001)
                step = 0.0 if mode == "naive" else \
                    abs(hi - lo) / 2 * (8001 // 64) / 8001
                tol = 0.0 if name == "conv0" else \
                    max(step, 1e-6 * max(abs(lo), abs(hi)))
                assert abs(plo - lo) <= tol and abs(phi - hi) <= tol, \
                    (mode, name, (lo, hi), (plo, phi))
            tables[mode] = jt
        # the entropy search itself on one array: equal
        a = np.random.RandomState(3).randn(5000).astype("f")
        assert cq.calib_entropy(a) == jcq.calib_entropy(a)
        assert cq.calib_entropy(a, min_percentile=99.0) == \
            jcq.calib_entropy(a, min_percentile=99.0)
        # CalibTable: the JAX package's file loads in the port and back
        jt = tables["naive"]
        jt.save(str(tmp_path / "jax.json"))
        pt = quant.CalibTable.load(str(tmp_path / "jax.json"))
        assert pt.to_dict() == jt.to_dict()
        pt.save(str(tmp_path / "port.json"))
        assert (tmp_path / "port.json").read_bytes() == \
            (tmp_path / "jax.json").read_bytes()
        assert jquant.CalibTable.load(str(tmp_path / "port.json")) \
            .to_dict() == jt.to_dict()

        # the pass route on the same table: an int8 graph without a float
        # layer, every entry bitwise
        jq, jextra, jres = jquant.quantize_symbol(
            jsym, jarg, table=jt, exclude_first_conv=False,
            exclude_last_fc=False)
        pq, pextra, pres = quant.quantize_symbol(
            psym, parg, table=pt, exclude_first_conv=False,
            exclude_last_fc=False)
        assert pres.counts == jres.counts == \
            {"quantize": 4, "requantize": 4, "dequantize": 4}
        assert _signature(pq) == _signature(jq)
        assert sorted(pextra) == sorted(jextra) and all(
            _same(pextra[k].asnumpy(), jextra[k].asnumpy()) for k in jextra)
        jall = {**jarg, **jextra}
        pall = {**parg, **pextra}
        jout = _internals(jmx, jq, jall, x[:8])
        pout = _internals(mx, pq, pall, x[:8])
        assert sorted(pout) == sorted(jout)
        bad = [k for k in jout if not _same(pout[k], jout[k])]
        assert not bad, bad
        # the default exclusions (first conv, last fc in float) and the
        # direct route, in both packages
        jq2, jextra2, _ = jquant.quantize_symbol(jsym, jarg, table=jt)
        pq2, pextra2, _ = quant.quantize_symbol(psym, parg, table=pt)
        assert _signature(pq2) == _signature(jq2)
        dq, dextra = cq.quantize_graph(psym, parg,
                                       excluded_sym_names=["conv0", "fc1"],
                                       calib_ranges=pt.ranges)
        jdq, jdextra = jcq.quantize_graph(
            jsym, jarg, excluded_sym_names=["conv0", "fc1"],
            calib_ranges=jt.ranges)
        assert _signature(dq) == _signature(pq2) == _signature(jdq)
        assert sorted(dextra) == sorted(pextra2) and all(
            torch.equal(dextra[k]._data, pextra2[k]._data) for k in dextra)
        np.testing.assert_array_equal(
            _internals(mx, dq, {**parg, **dextra}, x[:4])["fc1_output"],
            _internals(mx, pq2, {**parg, **pextra2}, x[:4])["fc1_output"])
        for mode in ("none", "naive"):
            it = [jmx.nd.array(b) for b in batches]
            jm = jcq.quantize_model(jsym, jarg, {}, calib_mode=mode,
                                    calib_data=it)
            pm = cq.quantize_model(psym, parg, {}, calib_mode=mode,
                                   calib_data=[mx.nd.array(b)
                                               for b in batches])
            assert _signature(pm[0]) == _signature(jm[0])
            assert all(_same(pm[1][k].asnumpy(), jm[1][k].asnumpy(),
                             rtol=1e-6) for k in jm[1])

        # the JSON and reference .params carried across, both ways
        for src, dst, qsym, params in (
                (jmx, mx, jq, jall), (mx, jmx, pq, pall)):
            path = str(tmp_path / f"{src.__name__}.params")
            (jinterop if src is jmx else interop).save_reference_params(
                path, {f"arg:{k}": v for k, v in params.items()
                       if k in qsym.list_arguments()})
            loaded = (interop if dst is mx else jinterop) \
                .load_reference_params(path)
            back = dst.sym.load_json(qsym.tojson())
            got = _internals(dst, back, {k[4:]: v for k, v in
                                         loaded.items()}, x[:8])
            want = _internals(src, qsym, params, x[:8])
            bad = [k for k in want if k.endswith("_int8_output0")
                   and not _same(got[k], want[k])]
            assert not bad and np.array_equal(got["fc1_dequantize_output"],
                                              want["fc1_dequantize_output"])

        # the accuracy harness
        evals = [x[:8], x[8:]]
        ja = jquant.evaluate_agreement(jsym, jarg, {}, jq2,
                                       {**jarg, **jextra2}, {}, evals)
        pa = quant.evaluate_agreement(psym, parg, {}, pq2,
                                      {**parg, **pextra2}, {}, evals)
        assert pa == ja

    # the quantize_mlp twin: the JAX recipe's float net (2 epochs) carried
    # into the twin, both quantized with entropy calibration
    jrec = _load("example/quantization/quantize_mlp.py", "qmlp_jax")
    twin = _load("example/quantization/quantize_mlp_torch.py", "qmlp_twin")
    rng = np.random.RandomState(0)
    xd, yd = jrec.make_data(rng)
    jmx.random.seed(0)
    jnet = jrec.train_float(xd, yd, epochs=2)
    jfsym, jfarg, jfaux = jcq._trace_gluon(jnet)
    jqs, jqa, jqx = jcq.quantize_model(
        jfsym, jfarg, jfaux, calib_mode="entropy",
        calib_data=jmx.io.NDArrayIter(xd[:128], yd[:128], 64),
        num_calib_examples=128)
    with mx.cpu():
        pnet = twin.train_float(xd, yd, epochs=0, ctx=mx.cpu())
        pnet(mx.nd.array(xd[:1]))
        for (_, p), (_, q) in zip(sorted(pnet.collect_params().items()),
                                  sorted(jnet.collect_params().items())):
            p.set_data(mx.nd.array(q.data().asnumpy()))
        (_, _, _), (pqs, pqa, pqx) = twin.quantize(pnet, xd, yd, mx.cpu())
        got = twin.accuracy(pqs, pqa, pqx, xd, yd, mx.cpu())
    feed = dict(jqa)
    feed["data"] = jmx.nd.array(xd)
    want = (jqs.bind(jmx.cpu(), feed).forward()[0].asnumpy().argmax(1)
            == yd).mean()
    assert abs(got - want) <= 0.01, (got, want)
    with mx.cpu():
        facc, qacc = twin.run(verbose=False, ctx=mx.cpu())
    # tests/test_examples.py's bar for the JAX recipe
    assert facc > 0.95 and qacc > facc - 0.02, (facc, qacc)


# ------------------------------------------------------- serving tier
def test_int8_serving_tier_matches_jax(monkeypatch):
    """``ModelConfig(tier="int8")`` and ``MXNET_SERVE_TIER``: the server
    quantizes the float model at state build (``ensure_tier``) and serves
    the JAX server's int8 outputs; the knobs carry over, ``stats()`` names
    the tier, ``ensure_tier`` leaves a float or quantized config alone,
    the ledger functions wait for A9."""
    from mxnet_tpu.serving import load as jload
    from mxnet_tpu.serving.server import ModelConfig as JConfig
    from mxnet_tpu.serving.server import ModelServer as JServer
    from mxnet_tpu_torch.serving import ModelConfig, ModelServer
    sym_json, pbytes, feat, _ = jload.tiny_model()
    xs = np.random.RandomState(5).randn(4, *feat).astype("f")
    outs = []
    for Config, Server, kw in ((JConfig, JServer, {}),
                               (ModelConfig, ModelServer, {"dev_type": 1})):
        cfg = Config("tiny", sym_json, pbytes, feature_shape=feat,
                     buckets=(1,), max_queue=16, deadline_ms=0,
                     tier="int8", **kw)
        srv = Server([cfg]).start()
        try:
            outs.append(np.stack([srv.predict("tiny", r, timeout=60)
                                  for r in xs]))
            stats = srv.stats("tiny")
        finally:
            srv.close()
        assert stats["tier"] == "int8" and stats["counts"]["ok"] == len(xs)
    np.testing.assert_array_equal(outs[1], outs[0])

    cfg = ModelConfig("tiny", sym_json, pbytes, feature_shape=feat,
                      buckets=(1, 2), max_queue=16, deadline_ms=2000.0,
                      dev_type=1)
    assert cfg.tier == "f32" and quant.ensure_tier(cfg) is cfg
    qcfg = quant.quantize_model_config(cfg)
    assert qcfg.tier == "int8" and quant.ensure_tier(qcfg) is qcfg
    assert (qcfg.buckets, qcfg.max_queue, qcfg.deadline_ms,
            qcfg.dev_type) == (cfg.buckets, 16, 2000.0, 1)
    assert quant.is_quantized_symbol(mx.sym.load_json(qcfg.symbol_json))
    monkeypatch.setenv("MXNET_SERVE_TIER", "int8")
    assert ModelConfig("tiny", sym_json, pbytes, feature_shape=feat,
                       dev_type=1).tier == "int8"
    monkeypatch.delenv("MXNET_SERVE_TIER")
    with pytest.raises(mx.MXNetError, match="tier"):
        ModelConfig("tiny", sym_json, pbytes, feature_shape=feat,
                    tier="fp4")
    for fn in (quant.compare_latency, quant.quant_rows,
               quant.best_int8_cached):
        with pytest.raises(NotImplementedError, match="A9"):
            fn()
    assert json.loads(qcfg.symbol_json)["mxnet_tpu_version"] == 1

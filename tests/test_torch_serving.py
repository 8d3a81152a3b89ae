"""PyTorch port, the slice as a whole: the causal TransformerLM served
through ``mxnet_tpu_torch.serving.ModelServer`` on the CPU, against the JAX
package's ``ModelServer`` on the same exported files.

The LM is the JAX package's own gluon graph (Embedding, sinusoidal
positions, a causal pre-norm TransformerEncoder, an untied Dense head) at
2 layers, units 256, 2 heads (D = 128, so the JAX side runs the real Pallas
kernel in interpret mode), FFN 512, vocab 64, T 16, hybridized and
exported. ``export()`` writes the Constant ``pos_table`` with an ``aux:``
prefix while the graph lists it as an argument, which neither package's
predictor accepts; the fixture re-prefixes that one key to ``arg:``
(ROADMAP §C). Logits agree to atol = rtol = 1e-4: both float32, in another
summation order.
"""
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib.transformer import (
    SinusoidalPositionalEmbedding, TransformerEncoder)
from mxnet_tpu.native.predict_bridge import Predictor as JaxPredictor
from mxnet_tpu.serving import ModelConfig as JaxModelConfig
from mxnet_tpu.serving import ModelServer as JaxModelServer
from mxnet_tpu_torch import interop
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.native.predict_bridge import Predictor
from mxnet_tpu_torch.serving import (DeadlineExceeded, Draining, ModelConfig,
                                     ModelServer, Overloaded)
from mxnet_tpu_torch.serving.load import model_config_from_files
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import once

VOCAB, UNITS, LAYERS, HEADS, FFN, T = 64, 256, 2, 2, 512, 16
TOL = 1e-4
BUCKETS = (1, 2, 4)

pytestmark = pytest.mark.serve


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def interp():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def exported(interp, tmp_path_factory):
    """The JAX gluon LM, hybridized and exported: (symbol json, param
    bytes, {param name: numpy}, op sequence); once for the session."""
    return once(tmp_path_factory, "serving-exported",
                lambda: _export(tmp_path_factory))


def _export(tmp_path_factory):
    net = jnn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(jnn.Embedding(VOCAB, UNITS, prefix="embed_"))
        net.add(SinusoidalPositionalEmbedding(T, UNITS))
        net.add(TransformerEncoder(LAYERS, UNITS, FFN, HEADS, 0.0,
                                   pre_norm=True, causal=True,
                                   prefix="body_"))
        net.add(jnn.Dense(VOCAB, flatten=False, use_bias=False,
                          prefix="head_"))
    jmx.random.seed(11)
    net.initialize(jmx.init.Normal(0.05))
    net.hybridize()
    net(jmx.nd.array(np.zeros((1, T), "float32")))
    sym_file, par_file = net.export(str(tmp_path_factory.mktemp("lm") / "lm"))
    params = {k: v for k, v in jmx.nd.load(par_file).items()}
    fixed = {("arg:" + k[4:] if k.endswith("_pos_table") else k): v
             for k, v in params.items()}
    assert len(fixed) == len(params) and fixed != params
    jmx.nd.save(par_file, fixed)
    with open(sym_file) as f:
        sym_json = f.read()
    with open(par_file, "rb") as f:
        pbytes = f.read()
    ops = [n["op"] for n in json.loads(sym_json)["nodes"] if n["op"] != "null"]
    return dict(sym_file=sym_file, par_file=par_file, sym_json=sym_json,
                pbytes=pbytes, ops=ops,
                numpy={k: v.asnumpy() for k, v in fixed.items()})


@pytest.fixture(scope="module")
def requests():
    rng = np.random.RandomState(5)
    return [rng.randint(0, VOCAB, size=T).astype("float32")
            for _ in range(3)]


@pytest.fixture(scope="module")
def jax_served(exported, requests, tmp_path_factory):
    return once(tmp_path_factory, "serving-jax-served",
                lambda: _jax_serve(exported, requests))


def _jax_serve(exported, requests):
    cfg = JaxModelConfig("lm", exported["sym_json"], exported["pbytes"],
                         feature_shape=(T,), buckets=BUCKETS,
                         deadline_ms=60000.0, max_wait_ms=50.0)
    srv = JaxModelServer([cfg], drain_on_preemption=False).start()
    try:
        futs = [srv.submit("lm", r) for r in requests]
        return [np.asarray(f.result(120.0)) for f in futs]
    finally:
        srv.close(timeout=10.0)


def _serve(cfg, requests):
    srv = ModelServer([cfg]).start()
    try:
        futs = [srv.submit("lm", r) for r in requests]
        outs = [f.result(60.0) for f in futs]
        return outs, srv.stats("lm")
    finally:
        srv.close(timeout=10.0)


@pytest.mark.parametrize("weights", ["file", "params_from_numpy"])
def test_port_serves_the_exported_lm_like_jax(exported, requests, jax_served,
                                              weights):
    if weights == "file":
        cfg = model_config_from_files(
            exported["sym_file"], params=exported["par_file"],
            feature_shape=str(T), name="lm", buckets="1,2,4", dev_type=1,
            deadline_ms=60000.0, max_wait_ms=50.0)
    else:
        params = interop.params_from_numpy(exported["numpy"], mxt.cpu())
        assert all(k.startswith("arg:") for k in params)
        cfg = ModelConfig("lm", exported["sym_json"], params,
                          feature_shape=(T,), buckets=BUCKETS, dev_type=1,
                          deadline_ms=60000.0, max_wait_ms=50.0)
    outs, st = _serve(cfg, requests)
    assert st["counts"]["ok"] == 3 and st["deadline_violations"] == 0
    assert set(st["buckets_compiled"]) <= set(BUCKETS)
    for got, want in zip(outs, jax_served):
        assert got.shape == (T, VOCAB)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_mxtpu001_files_cross_both_ways(exported, tmp_path):
    """The port reads the JAX package's params file, and the JAX package
    reads the port's (float32 and bfloat16 arrays, dict and list)."""
    with mxt.cpu():
        loaded = mxt.nd.load(exported["par_file"])
    assert sorted(loaded) == sorted(exported["numpy"])
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.asnumpy(), exported["numpy"][k])
    w = np.random.RandomState(3).randn(3, 5).astype("float32")
    bf = torch.from_numpy(w).to(torch.bfloat16)
    path = str(tmp_path / "port.params")
    mxt.nd.save(path, {"w": mxt.nd.NDArray(torch.from_numpy(w)),
                       "bf": mxt.nd.NDArray(bf)})
    back = jmx.nd.load(path)
    np.testing.assert_array_equal(back["w"].asnumpy(), w)
    np.testing.assert_array_equal(back["bf"].asnumpy().astype("float32"),
                                  bf.float().numpy())
    mxt.nd.save(path, [mxt.nd.NDArray(bf)])
    again = mxt.nd.load(path, ctx=mxt.cpu())
    assert isinstance(again, list) and torch.equal(again[0]._data, bf)


def test_smoke_graph_is_the_exported_graph(exported):
    """chip_smoke.py builds its LM with the port's mx.sym; loaded by the JAX
    package it has the op sequence of the gluon export."""
    cs = _chip_smoke()
    port_json = cs.build_lm_symbol(mxt.sym, VOCAB, UNITS, LAYERS, HEADS,
                                   FFN).tojson()
    nodes = jmx.sym.load_json(port_json).topo_nodes()
    assert [n.op for n in nodes if not n.is_var] == exported["ops"]
    assert len(exported["ops"]) == 4 + 19 * LAYERS + 2


def test_smoke_graph_logits_match_jax(interp, tmp_path):
    """Both packages' predictors give the same logits on the smoke's graph
    and weights."""
    cs = _chip_smoke()
    lm = cs.build_lm_symbol(mxt.sym, VOCAB, UNITS, LAYERS, HEADS, FFN)
    shapes, _, _ = lm.infer_shape(data=(3, T), pos_table=(T, UNITS))
    rng = np.random.RandomState(7)
    weights = {"arg:" + n: (rng.randn(*s) * 0.05).astype("float32")
               for n, s in zip(lm.list_arguments(), shapes) if n != "data"}
    weights["arg:pos_table"] = cs.sinusoid_table(T, UNITS)
    par = str(tmp_path / "smoke.params")
    mxt.nd.save(par, interop.params_from_numpy(weights, mxt.cpu()))
    with open(par, "rb") as f:
        pbytes = f.read()
    tokens = rng.randint(0, VOCAB, size=(3, T)).astype("float32")
    jp = JaxPredictor(lm.tojson(), pbytes, 1, 0, {"data": (3, T)})
    pp = Predictor(lm.tojson(), pbytes, 1, 0, {"data": (3, T)})
    want = jp.predict({"data": tokens})[0]
    got = pp.predict({"data": tokens})[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        plain = cs.plain_forward(
            {k[4:]: torch.from_numpy(v) for k, v in weights.items()},
            torch.from_numpy(tokens).long(), VOCAB, UNITS, LAYERS, HEADS)
    np.testing.assert_allclose(got, plain.numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------------ server semantics
@pytest.fixture
def slow_server(exported):
    """A port server over the exported LM whose executor takes ``delay``
    seconds; ``calls`` records every dispatched batch."""
    servers = []

    def make(delay, **kw):
        d = dict(feature_shape=(T,), buckets=BUCKETS, dev_type=1,
                 deadline_ms=60000.0, max_wait_ms=1.0)
        d.update(kw)
        srv = ModelServer([ModelConfig("lm", exported["sym_json"],
                                       exported["pbytes"], **d)])
        st = srv._models["lm"]
        run, calls = st.cache.run, []

        def slow_run(batch):
            calls.append(np.array(batch))
            time.sleep(delay)
            return run(batch)

        st.cache.run = slow_run
        servers.append(srv.start(warm=True))
        return srv, calls

    yield make
    for srv in servers:
        srv.close(timeout=10.0)


def test_full_queue_answers_overloaded(slow_server, requests):
    srv, _ = slow_server(0.3, max_queue=2)
    first = srv.submit("lm", requests[0])
    time.sleep(0.1)                              # the worker holds `first`
    accepted = [srv.submit("lm", r) for r in requests[1:]]
    with pytest.raises(Overloaded):
        srv.submit("lm", requests[0])
    for f in [first] + accepted:
        assert f.result(30.0).shape == (T, VOCAB)
    st = srv.stats("lm")
    assert st["counts"]["shed"] == 1 and st["counts"]["ok"] == 3


def test_expired_request_is_never_dispatched(slow_server, requests):
    srv, calls = slow_server(0.3)
    blocker = srv.submit("lm", requests[0])
    time.sleep(0.1)
    doomed = srv.submit("lm", requests[1] + 0.5, deadline_ms=30)
    blocker.result(30.0)
    with pytest.raises(DeadlineExceeded):
        doomed.result(30.0)
    assert doomed.outcome() == "expired"
    assert not any((b == requests[1] + 0.5).all(axis=1).any()
                   for b in calls)
    st = srv.stats("lm")
    assert st["counts"]["expired"] == 1 and st["deadline_violations"] == 0


def test_close_drains_accepted_work(slow_server, requests):
    srv, _ = slow_server(0.1)
    futs = [srv.submit("lm", r) for r in requests]
    assert srv.close(timeout=30.0)
    assert all(f.outcome() == "ok" for f in futs)
    with pytest.raises(Draining):
        srv.submit("lm", requests[0])


def test_card_is_the_default_and_never_falls_back(exported):
    assert mxt.current_context() == mxt.gpu(0)
    assert ModelConfig("lm", "{}", feature_shape=(T,)).dev_type == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelConfig("lm", "{}", feature_shape=(T,), trace=True)
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA refusal needs a machine without a card")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mxt.nd.zeros((2,))
    srv = ModelServer([ModelConfig("lm", exported["sym_json"],
                                   exported["pbytes"], feature_shape=(T,),
                                   buckets=(1,))])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        srv.start(warm=True)

"""PyTorch port, ``parallel.DataParallelTrainer``'s step knobs against the
JAX package's: ``compute_dtype``, ``remat``, ``loss_scaling``,
``grad_guard`` and ``dynamic_lr_scale``.

Both trainers run on one CPU device (the JAX one on
``local_mesh("dp", devices=jax.devices()[:1])`` with ``passes=False``),
from the same numpy values, three steps. Two nets:

* the LM of ``tests/test_torch_data_parallel.py`` (``TransformerLM`` at 1
  layer, 32 units, 4 heads, FFN 64, vocab 50, 2 × 16 tokens; the port's
  side the ``SymbolBlock`` of its files, the JAX side the JAX package's
  gluon LM, whose ``SymbolBlock`` cannot be trained, ROADMAP C) for
  ``compute_dtype``, optax SGD with momentum 0.9. Its positional table
  is frozen on both sides, so the trainers keep it uncast: set to the
  compute dtype, the whole LM runs in it (LayerNorm, the fused-QKV bias,
  the attention, ``log_softmax``); left in float32, everything after the
  table promotes to float32 in both packages (a standing fault, ROADMAP
  C);
* a small MLP (Dense 10→16 relu, Dense 16→4, ``SoftmaxCrossEntropyLoss``,
  optax SGD with momentum 0.9) on 8 × 10 inputs for the guard, the
  scaler and the lr scale.

Tolerances, relative to each tensor's largest entry:

* float32 steps: ``TOL`` = 1e-5, the same arithmetic in another
  summation order. Anomaly statistics (the gradient norm and its EMA):
  1e-5 relative.
* the LM with a float32 table under ``compute_dtype="bfloat16"`` (float32
  after the table): ``TOL_LOWP`` = 2e-4. Where the packages' float32 sums
  differ in their last bit, a bf16 product's rounding can flip by one
  unit and move single entries: on five seeds of the LM's weights (11 to
  15; 11 is the tests') the port lay at most 6.4e-5 from the JAX
  trainer, and the test asserts that ``2 · TOL_LOWP`` lies under the
  distance to the LM with a bf16 table (2.1e-2 to 8.5e-2).
* the LM wholly in bf16 or float16: no per-entry tolerance can sit under
  half of the JAX package's own gap between its low-precision and its
  float32 step, because that gap is itself rounding of the same size as
  the rounding in which the two packages differ (XLA's and torch's
  reductions and fusions round at other places; switching off XLA's
  excess precision, ``--xla_allow_excess_precision=false``, did not
  narrow it: 2.35e-2 against 1.63e-2 on the largest entry, with a gap of
  8.7e-2). So the test holds the whole step, in the norm over every
  weight: the port's weights after three steps lie closer to the JAX
  trainer's than ``LOWP_RATIO`` = 0.9 of the distance of the port's own
  float32 step, which is where a port that did not cast would land
  (ratio 1). On seeds 11 to 15 the ratio was 0.72-0.81 in bf16 (0.74 on
  seed 11) and 0.45-0.57 in float16 (0.57). Every product's inputs are
  recorded besides, and must all be in the compute dtype.
* the float-id rule: ``TOL_BF16`` = 1e-2 on an Embedding net whose step
  differs only in which rows move.

The guard's and the scaler's functions (``_guard_config``,
``_guard_apply``, ``scaler_config``, ``scaler_apply``) are also held to
the JAX package's on single transitions: equal values.

Remat runs only in the port here against its own run without remat:
bitwise equal on the CPU (the recompute repeats the same ops on the same
values), over the LM's graph with its table fed as a data input, so that
the cast reaches every product and the attention runs in bf16.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.parallel import data_parallel as jdp
from mxnet_tpu.resilience import recovery as jrecovery
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.parallel import data_parallel as pdp
from mxnet_tpu_torch.resilience import recovery as precovery
from test_torch_data_parallel import _lm, lm_files  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import once

TOL = 1e-5
TOL_LOWP = 2e-4
LOWP_RATIO = 0.9
TOL_BF16 = 1e-2
OPT = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})


def _mlp(g):
    net = g.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(g.nn.Dense(16, in_units=10, activation="relu",
                           prefix="fc1_"))
        net.add(g.nn.Dense(4, in_units=16, prefix="fc2_"))
    return net


def _values():
    rng = np.random.RandomState(1)
    shapes = {"mlp_fc1_weight": (16, 10), "mlp_fc1_bias": (16,),
              "mlp_fc2_weight": (4, 16), "mlp_fc2_bias": (4,)}
    return {k: (rng.randn(*s) * 0.3).astype("float32")
            for k, s in shapes.items()}


def _batch(scale=1.0, poison=False):
    rng = np.random.RandomState(2)
    x = rng.randn(8, 10).astype("float32") * scale
    if poison:
        x[3, 4] = np.inf
    return x, rng.randint(0, 4, 8).astype("float32")


def _jax_run(batches, knobs, between=None):
    """Steps of the JAX trainer; (losses, weights, anomaly stats)."""
    net = _mlp(jgluon)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(_values()[k]))
    tr = jparallel.DataParallelTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), OPT[0], dict(OPT[1]),
        mesh=jparallel.local_mesh("dp", devices=jax.devices()[:1]),
        passes=False, **knobs)
    losses = []
    for i, (x, y) in enumerate(batches):
        if between is not None:
            between(tr, i)
        losses.append(float(tr.step(jmx.nd.array(x), jmx.nd.array(y))))
    tr.sync_to_net()
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}, \
        tr.anomaly_stats()


def _port_trainer(knobs):
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(_values()[k])
    return net, parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), OPT[0], dict(OPT[1]),
        mesh=parallel.local_mesh(devices=[mx.cpu()]), **knobs)


def _port_run(batches, knobs, between=None):
    with mx.cpu():
        net, tr = _port_trainer(knobs)
        losses = []
        for i, (x, y) in enumerate(batches):
            if between is not None:
                between(tr, i)
            losses.append(float(tr.step(mx.nd.array(x), mx.nd.array(y))))
        tr.sync_to_net()
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}, \
        tr.anomaly_stats()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _same_run(port, jax_, tol):
    _close(port[0], jax_[0], tol, "losses")
    for k in jax_[1]:
        _close(port[1][k], jax_[1][k], tol, k)
    assert port[2].keys() == jax_[2].keys()
    for k, v in jax_[2].items():
        if isinstance(v, float) and np.isfinite(v):
            _close(port[2][k], v, TOL, k)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(port[2][k]), k
        else:
            assert port[2][k] == v, k


def _record_product_dtypes(monkeypatch):
    """The dtypes every ``FullyConnected`` of the port sees, recorded."""
    op = registry.get_op("FullyConnected")
    seen = []
    orig = op.fn

    def fn(data, weight, bias=None, **kw):
        seen.append({data.dtype, weight.dtype} | (
            set() if bias is None else {bias.dtype}))
        return orig(data, weight, bias, **kw)

    monkeypatch.setattr(op, "fn", fn)
    return seen


def _lm_values(f):
    """The LM's values by the files' names, seeded here: every weight
    matrix N(0, 0.02²) as the JAX LM's initializer draws it; the table,
    the LayerNorm gammas (ones) and the biases (zeros) as the files hold
    them."""
    rng = np.random.RandomState(11)
    out = {}
    for n, full in sorted(f["names"].items()):
        v = f["values"][full]
        if n.endswith("weight"):
            v = (rng.randn(*v.shape) * 0.02).astype("float32")
        out[n] = v
    return out


def _jax_lm_run(f, table_dtype, **knobs):
    """Three steps of the JAX trainer over the JAX package's gluon LM, its
    frozen table in ``table_dtype``: (losses, weights by the files'
    names)."""
    net = _lm(jgluon)
    net.initialize()
    net(jmx.nd.array(f["x"]))
    values = _lm_values(f)
    params = net.collect_params()
    for n, full in f["names"].items():
        params[full].set_data(jmx.nd.array(values[n]))
    params[f["names"]["pos_table"]].cast(table_dtype)
    tr = jparallel.DataParallelTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), OPT[0], dict(OPT[1]),
        mesh=jparallel.local_mesh("dp", devices=jax.devices()[:1]),
        passes=False, **knobs)
    losses = [float(tr.step(jmx.nd.array(f["x"]), jmx.nd.array(f["y"])))
              for _ in range(3)]
    tr.sync_to_net()
    return losses, {n: np.asarray(params[full].data().asnumpy(), "float32")
                    for n, full in f["names"].items() if n != "pos_table"}


def _port_lm_run(f, table_dtype, **knobs):
    """The same three steps of the port's trainer over the ``SymbolBlock``
    of the LM's files, its table frozen in ``table_dtype``."""
    with mx.cpu():
        block = gluon.SymbolBlock.imports(f["prefix"] + "-symbol.json",
                                          ["data"], f["prefix"] +
                                          "-0000.params", ctx=mx.cpu())
        values = _lm_values(f)
        for n, p in block.collect_params().items():
            p.set_data(mx.nd.array(values[n]))
        table = block.collect_params()["pos_table"]
        table.grad_req = "null"
        table.cast(table_dtype)
        tr = parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), OPT[0],
            dict(OPT[1]), mesh=parallel.local_mesh(devices=[mx.cpu()]),
            **knobs)
        losses = [float(tr.step(mx.nd.array(f["x"]), mx.nd.array(f["y"])))
                  for _ in range(3)]
        tr.sync_to_net()
    return losses, {n: p.data().asnumpy() for n, p in
                    block.collect_params().items() if n != "pos_table"}


@pytest.fixture(scope="module")
def jax_lm(lm_files, tmp_path_factory):
    """The JAX LM's runs by (compute dtype, table dtype), each computed
    once in the session."""
    def run(compute, table):
        return once(tmp_path_factory, f"jax-lm-{compute}-{table}",
                    lambda: _jax_lm_run(lm_files, table,
                                        compute_dtype=compute))
    return run


def _gap(run, ref) -> float:
    """The largest distance, relative to the tensor's largest entry,
    between two runs' losses or weights."""
    errs = [np.abs(np.subtract(run[0], ref[0])).max() / np.abs(ref[0]).max()]
    errs += [np.abs(run[1][k] - ref[1][k]).max() / np.abs(ref[1][k]).max()
             for k in ref[1]]
    return float(max(errs))


def _dist(a, b) -> float:
    """The norm, over every weight, of the difference of two runs."""
    return float(np.sqrt(sum(np.sum((a[1][k].astype("float64") - b[1][k])
                                    ** 2) for k in b[1])))


@pytest.mark.parametrize("dtype,remat", [
    ("bfloat16", None), ("bfloat16", "dots"), ("bfloat16", "full"),
    ("float16", None)], ids=["bf16", "bf16-dots", "bf16-full", "f16"])
def test_low_precision_lm_steps_match_jax(lm_files, jax_lm, dtype, remat,
                                          monkeypatch):
    """The LM with its table in the compute dtype, so that it runs wholly
    in it: three steps under each remat mode (``float16`` runs on the CPU
    through the plain versions; on the card the kernels have no float16
    yet, ROADMAP B5) against the JAX trainer's without remat. The port's
    float32 master weights lie closer to the JAX trainer's than
    ``LOWP_RATIO`` of the distance of the port's own float32 step (the
    step of a port that did not cast); every product of the port's step
    sees data, weights and bias in the compute dtype."""
    want = jax_lm(dtype, dtype)
    seen = _record_product_dtypes(monkeypatch)
    got = _port_lm_run(lm_files, dtype, compute_dtype=dtype, remat=remat)
    assert seen and all(s == {getattr(torch, dtype)} for s in seen)
    for k in want[1]:
        assert got[1][k].dtype == np.float32, k
    uncast = _port_lm_run(lm_files, "float32")
    ratio = _dist(got, want) / _dist(uncast, want)
    assert ratio < LOWP_RATIO, ratio


def test_frozen_float32_table_runs_the_lm_in_float32_like_jax(
        lm_files, jax_lm, monkeypatch):
    """A frozen parameter stays float32 under ``compute_dtype="bfloat16"``
    (the trainers cast only what they update), so the LM's table add
    promotes everything after it to float32, in both packages (a standing
    fault, ROADMAP C): the port's products after the table see float32
    data on bf16 weights, and its steps match the JAX trainer's within
    ``TOL_LOWP``, under half of their distance from the port's LM with a
    bf16 table."""
    want = jax_lm("bfloat16", "float32")
    seen = _record_product_dtypes(monkeypatch)
    got = _port_lm_run(lm_files, "float32", compute_dtype="bfloat16")
    assert seen and all(s == {torch.float32, torch.bfloat16} for s in seen)
    _close(got[0], want[0], TOL_LOWP, "losses")
    for k in want[1]:
        _close(got[1][k], want[1][k], TOL_LOWP, k)
    wholly = _port_lm_run(lm_files, "bfloat16", compute_dtype="bfloat16")
    assert 2 * TOL_LOWP < _gap(want, wholly)


def test_bf16_rounds_where_f32_does_not():
    """The cast is real: the port's bf16 step differs from its f32 step
    by more than float32 noise, in losses and weights."""
    batches = [_batch()] * 2
    f32 = _port_run(batches, {})
    bf16 = _port_run(batches, {"compute_dtype": "bfloat16"})
    assert abs(bf16[0][0] - f32[0][0]) > 1e-4
    assert max(np.abs(bf16[1][k] - f32[1][k]).max() for k in f32[1]) > 1e-5


def test_chip_smoke_layer_norm_is_the_ops_rule():
    """``chip_smoke.jax_layer_norm``, the LayerNorm of the card's plain
    bf16 control, is the LayerNorm op's rule in both packages: on bf16
    input, gamma and beta its output equals the JAX op's and the port
    op's, bitwise."""
    from mxnet_tpu.ops.registry import get_op as jax_op
    rng = np.random.RandomState(5)
    x, g, b = (rng.randn(*s).astype("float32")
               for s in ((4, 6, 32), (32,), (32,)))
    want = jax_op("LayerNorm").fn(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (x, g, b)))[0]
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    tx = [torch.from_numpy(a).bfloat16() for a in (x, g, b)]
    port = registry.get_op("LayerNorm").fn(*tx)[0]
    ctl = _chip_smoke().jax_layer_norm(*tx)
    assert port.dtype == ctl.dtype == torch.bfloat16
    assert torch.equal(port.float(), want) and torch.equal(ctl.float(), want)


def test_loss_scaling_matches_jax():
    """Loss scaling with its defaults (the guard turns on with it): three
    clean steps, the scaler's counters and the guard's statistics."""
    batches = [_batch()] * 3
    knobs = {"loss_scaling": {"init_scale": 2.0 ** 12, "growth_interval": 2}}
    got, want = _port_run(batches, knobs), _jax_run(batches, knobs)
    _same_run(got, want, TOL)
    assert got[2]["loss_scale"] == 2.0 ** 13      # grew after two steps
    assert got[2]["scaler_good_steps"] == 1


def test_overflow_skips_the_step_and_halves_the_scale_like_jax():
    """A batch holding an inf: the step is skipped (weights, momentum and
    the update count kept, bitwise on the port's side), the skip counted,
    the scale halved; the next clean step goes on as the JAX one does."""
    batches = [_batch(), _batch(poison=True), _batch()]
    knobs = {"loss_scaling": {"init_scale": 2.0 ** 12}}
    kept = {}

    def watch(tr, i):
        if i == 1:
            kept["w"] = {k: t.clone() for k, t in tr._params.items()}
            kept["m"] = {k: s[0].clone() for k, s in tr._opt_state.items()}
        if i == 2:
            assert all(torch.equal(t, kept["w"][k])
                       for k, t in tr._params.items())
            assert all(torch.equal(s[0], kept["m"][k])
                       for k, s in tr._opt_state.items())
            stats = tr.anomaly_stats()
            assert stats["last_step_skipped"]
            assert stats["loss_scale"] == 2.0 ** 11
            assert stats["scaler_overflows"] == 1

    got = _port_run(batches, knobs, watch)
    want = _jax_run(batches, knobs)
    assert np.isnan(got[0][1]) and np.isnan(want[0][1])
    got_, want_ = (([r[0][0], r[0][2]],) + r[1:] for r in (got, want))
    _same_run(got_, want_, TOL)
    assert got[2]["grad_skipped_steps"] == 1


def test_spike_is_skipped_after_warmup_like_jax():
    """A gradient norm past ``spike_factor``× its EMA skips the step once
    ``warmup`` good steps have passed, not before."""
    big = _batch(scale=60.0)
    batches = [big, _batch(), _batch(), big]
    knobs = {"grad_guard": {"warmup": 2, "spike_factor": 3.0}}
    got, want = _port_run(batches, knobs), _jax_run(batches, knobs)
    _same_run(got, want, TOL)
    assert got[2]["grad_skipped_steps"] == 1 and got[2]["last_step_skipped"]


def test_set_loss_scale_and_lr_scale_like_jax():
    """Host overrides between steps: the loss scale (a power of two,
    clamped) and the multiplier on every update."""
    batches = [_batch()] * 3
    knobs = {"loss_scaling": True, "dynamic_lr_scale": True}

    def between(tr, i):
        if i == 1:
            tr.set_loss_scale(2.0 ** 30)          # clamped to max_scale
            tr.set_lr_scale(0.5)
        if i == 2:
            tr.set_lr_scale(0.25)

    got = _port_run(batches, knobs, between)
    want = _jax_run(batches, knobs, between)
    _same_run(got, want, TOL)
    assert got[2]["loss_scale"] == 2.0 ** 24 and got[2]["lr_scale"] == 0.25


def test_knob_errors_like_jax():
    """The errors both packages raise: loss scaling with the guard
    explicitly off, a scale that is not a power of two, an unknown knob or
    remat mode, and the overrides on a trainer without their knob."""
    x = _batch()[0]
    for pkg, g, par, mesh in (
            (jmx, jgluon, jparallel,
             jparallel.local_mesh("dp", devices=jax.devices()[:1])),
            (mx, gluon, parallel, parallel.local_mesh(devices=[mx.cpu()]))):
        def make(**kw):
            return par.DataParallelTrainer(
                _mlp(g), g.loss.L2Loss(), "sgd", mesh=mesh, passes=False,
                **kw)
        for kw, match in (({"loss_scaling": True, "grad_guard": False},
                           "requires the grad-anomaly guard"),
                          ({"loss_scaling": {"init_scale": 3.0}},
                           "power of two"),
                          ({"loss_scaling": {"bogus": 1}}, "unknown"),
                          ({"remat": "sometimes"}, "unknown remat")):
            with pytest.raises(pkg.base.MXNetError, match=match):
                make(**kw)
        tr = make(loss_scaling=True)
        with pkg.cpu():
            tr._net.initialize()
            tr.step(pkg.nd.array(x), pkg.nd.array(np.zeros((8, 4),
                                                           "float32")))
        with pytest.raises(pkg.base.MXNetError, match="power of two"):
            tr.set_loss_scale(3.0)
        with pytest.raises(pkg.base.MXNetError, match="no dynamic lr"):
            tr.set_lr_scale(0.5)
        assert make().anomaly_stats() == {}


def _embed_net(g):
    net = g.nn.HybridSequential(prefix="emb_")
    with net.name_scope():
        net.add(g.nn.Embedding(512, 8, prefix="embed_"))
        net.add(g.nn.Dense(4, prefix="out_"))
    return net


def test_float_ids_are_rounded_under_bf16_like_jax():
    """The cast rule takes every floating data input but the label: token
    ids fed as float32 become bf16, which keeps 8 significant bits, so
    257 → 256 and 301 → 300 before ``Embedding`` sees them, in both
    packages (a standing fault of the reference's rule; feed integer ids).
    The rows that move are those of the rounded ids, on both sides."""
    ids = np.array([[255, 257, 301, 509], [1, 2, 3, 4]], "float32")
    y = np.array([1, 3], "float32")
    rng = np.random.RandomState(4)
    values = {"emb_embed_weight": rng.randn(512, 8).astype("float32"),
              "emb_out_weight": rng.randn(4, 32).astype("float32") * 0.2,
              "emb_out_bias": np.zeros(4, "float32")}
    res = []
    for pkg, g, par, mesh in (
            (jmx, jgluon, jparallel,
             jparallel.local_mesh("dp", devices=jax.devices()[:1])),
            (mx, gluon, parallel, parallel.local_mesh(devices=[mx.cpu()]))):
        with pkg.cpu():
            net = _embed_net(g)
            net.initialize()
            net(pkg.nd.array(ids))
            for k, p in net.collect_params().items():
                p.set_data(pkg.nd.array(values[k]))
            tr = par.DataParallelTrainer(
                net, g.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 1.0}, mesh=mesh, passes=False,
                compute_dtype="bfloat16")
            tr.step(pkg.nd.array(ids), pkg.nd.array(y))
            tr.sync_to_net()
            res.append({k: p.data().asnumpy()
                        for k, p in net.collect_params().items()})
    for k in res[0]:
        _close(res[1][k], res[0][k], TOL_BF16, k)
    rounded = {1, 2, 3, 4, 255, 256, 300, 508}
    for r in res:
        moved = set(np.nonzero(np.any(
            r["emb_embed_weight"] != values["emb_embed_weight"], 1))[0])
        assert moved == rounded


# ---------------------------------------------------------------- remat
V, UNITS, HEADS, FFN, B, T = 50, 32, 4, 64, 2, 16


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_mixed", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def lm_prefix(tmp_path_factory):
    """The LM's graph (2 layers) and seeded weights, as the card's mixed
    phase reads them."""
    cs = _chip_smoke()
    prefix = str(tmp_path_factory.mktemp("lm") / "lm")
    graph = cs.build_lm_symbol(mx.sym, V, UNITS, 2, HEADS, FFN, max_len=T)
    with mx.cpu():
        rng = np.random.RandomState(7)
        args = {n: mx.nd.array((rng.randn(*s) * 0.05).astype("float32"))
                for n, s in zip(graph.list_arguments(),
                                graph.infer_shape(data=(B, T))[0])
                if n != "data"}
        mx.model.save_checkpoint(prefix, 0, graph, args, {})
    return prefix, cs.sinusoid_table(T, UNITS)


def _lm_run(prefix, table, **knobs):
    """Three bf16 steps over the LM's SymbolBlock (the table an input):
    the losses and the weights."""
    rng = np.random.RandomState(8)
    ids = rng.randint(0, V, (B, T)).astype("int32")
    y = rng.randint(0, V, (B, T)).astype("float32")
    with mx.cpu():
        block = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                          ["data", "pos_table"],
                                          prefix + "-0000.params",
                                          ctx=mx.cpu())
        tr = parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), OPT[0],
            dict(OPT[1]), mesh=parallel.local_mesh(devices=[mx.cpu()]),
            compute_dtype="bfloat16", **knobs)
        losses = [float(tr.step(ids, table, y)) for _ in range(3)]
    return losses, {k: t.detach().clone() for k, t in tr._params.items()}


def _save_mm_else_recompute(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


@pytest.mark.parametrize("remat", ["dots", "full", _save_mm_else_recompute],
                         ids=["dots", "full", "torch-policy"])
def test_remat_is_bitwise_on_cpu(lm_prefix, remat):
    """Each remat mode (and a torch selective-checkpoint policy, the port's
    form of the callable) gives the losses and weights of the run without
    remat, bitwise; the attention runs again in the recompute."""
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    prefix, table = lm_prefix
    calls = []
    orig = hk._fa_fwd_dispatch

    def count(*a, **kw):
        if a[0].device.type == "cpu":
            calls.append(a[0].dtype)
        return orig(*a, **kw)

    base = _lm_run(prefix, table)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(hk, "_fa_fwd_dispatch", count)
        got = _lm_run(prefix, table, remat=remat)
    assert got[0] == base[0]
    assert all(torch.equal(got[1][k], base[1][k]) for k in base[1])
    assert calls and set(calls) == {torch.bfloat16}
    assert len(calls) == 3 * 2 * 2     # 3 steps, 2 layers, forward twice


# ------------------------------------------------ the guard and the scaler


@pytest.mark.parametrize("knob", [
    None, False, 0, {}, True, {"init_scale": 2.0 ** 15},
    {"growth_interval": 7, "backoff": 0.25, "max_scale": 2.0 ** 20},
    {"init_scale": 3.0}, {"min_scale": 0.3}, {"bogus": 2.0}],
    ids=["none", "false", "zero", "empty", "true", "init", "several",
         "init-not-pow2", "min-not-pow2", "unknown"])
def test_scaler_config_like_jax(knob):
    """The port's copy of ``scaler_config``: the same defaults, the same
    overrides and the same refusals."""
    try:
        want = jrecovery.scaler_config(knob)
    except jmx.base.MXNetError as e:
        with pytest.raises(mx.MXNetError) as got:
            precovery.scaler_config(knob)
        assert str(got.value) == str(e)
        return
    assert precovery.scaler_config(knob) == want


def _scalars(state):
    return {k: float(np.asarray(v)) for k, v in state.items()}


@pytest.mark.parametrize("overflow,bad,good,scale", [
    (True, True, 3, 2.0 ** 10), (True, True, 0, 1.0),
    (False, True, 3, 2.0 ** 10), (False, False, 3, 2.0 ** 10),
    (False, False, 4, 2.0 ** 10), (False, False, 4, 2.0 ** 24)],
    ids=["overflow", "overflow-at-min", "spike-skip", "clean", "grow",
         "grow-at-max"])
def test_scaler_apply_like_jax(overflow, bad, good, scale):
    """One scale transition on the device state: halve on overflow (not
    below ``min_scale``), hold on a spike skip, count a clean step and
    double every ``growth_interval`` of them (not above ``max_scale``)."""
    cfg = jrecovery.scaler_config({"growth_interval": 5})
    jstate = {"loss_scale": jnp.float32(scale), "ls_good": jnp.int32(good),
              "ls_overflows": jnp.int32(2)}
    tstate = {"loss_scale": torch.tensor(scale),
              "ls_good": torch.tensor(good, dtype=torch.int32),
              "ls_overflows": torch.tensor(2, dtype=torch.int32)}
    want = jrecovery.scaler_apply(cfg, jstate, jnp.bool_(overflow),
                                  jnp.bool_(bad))
    got = precovery.scaler_apply(cfg, tstate, torch.tensor(overflow),
                                 torch.tensor(bad))
    assert _scalars(got) == _scalars(want)
    assert got["ls_good"].dtype == torch.int32


@pytest.mark.parametrize("gnorm,good,ema,knob", [
    (1.0, 0, 0.0, True), (2.0, 3, 1.0, True), (50.0, 3, 1.0, True),
    (50.0, 7, 1.0, True), (float("nan"), 7, 1.0, True),
    (float("inf"), 0, 0.0, True),
    (50.0, 7, 1.0, {"spike_factor": 0}),
    (4.0, 2, 1.0, {"warmup": 2, "spike_factor": 3.0, "ema_decay": 0.5})],
    ids=["first", "good", "spike-in-warmup", "spike", "nan", "inf-first",
         "spikes-off", "knobs"])
def test_guard_apply_like_jax(gnorm, good, ema, knob):
    """The skip verdict and the guard's counters from one gradient norm:
    NaN/Inf always skip, a spike past ``spike_factor``× the EMA after
    ``warmup`` good steps skips, the EMA starts at the first good norm."""
    cfg = jdp._guard_config(knob)
    assert pdp._guard_config(knob) == cfg
    jstate = {"ema": jnp.float32(ema), "last_norm": jnp.float32(0),
              "skips": jnp.int32(1), "good": jnp.int32(good),
              "steps": jnp.int32(good + 1), "last_skipped": jnp.int32(0)}
    tstate = {k: torch.tensor(np.asarray(v)) for k, v in jstate.items()}
    _, want, jbad = jdp._guard_apply(cfg, jstate, jnp.float32(gnorm), {}, {})
    bad, got = pdp._guard_apply(cfg, tstate, torch.tensor(gnorm))
    assert bool(bad) == bool(jbad)
    w, g = _scalars(want), _scalars(got)
    assert w.keys() == g.keys()
    for k in w:
        assert g[k] == w[k] or (np.isnan(w[k]) and np.isnan(g[k])), k

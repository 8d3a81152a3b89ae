"""PyTorch port, ``parallel.DataParallelTrainer`` and ``gluon.SymbolBlock``
against the JAX package.

The JAX trainer runs on a one-device mesh
(``parallel.local_mesh("dp", devices=jax.devices()[:1])``) with
``passes=False``; the port's on ``local_mesh(devices=[cpu()])``. Both
start from the same numpy values and take three steps; each fused
optimizer is optax's rule on both sides (read from the optax installed
with the JAX package), not MXNet's. Two nets: an MLP with BatchNorm (its
moving statistics are the trainer's auxiliary state) on 8 × 10 inputs,
and ``TransformerLM`` at 1 layer, 32 units, 4 heads, FFN 64, vocab 50,
2 × 16 tokens, whose port side is the ``SymbolBlock`` of its graph and
weights as ``model.save_checkpoint`` writes them (the route of
``chip_smoke.py``'s fused phase). Tolerance: losses, parameters and
moving statistics within 1e-5 relative to the tensor's largest entry.

Adam runs at ε = 1e-6: the attention's key bias has a gradient of exactly
zero (it shifts every score of a query's row by the same ``q·b``, which
the softmax ignores), so both sides hold float32 noise of about 1e-11
there, and at the default ε = 1e-8 Adam turns that noise into steps of a
sizeable share of the learning rate with either sign, unlike on both
sides; at 1e-6 those steps are far below the tolerance.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu_torch import autograd, gluon, parallel

TOL = 1e-5
V, UNITS, HEADS, FFN, B, T = 50, 32, 4, 64, 2, 16
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 1e-3, "epsilon": 1e-6}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("adagrad", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
]
IDS = ["sgd", "sgd-momentum", "nag", "adam", "rmsprop", "adagrad", "sgd-wd"]
# optax's schedule of the update count (0 first), which the JAX trainer
# hands to optax as it is
SCHEDULED = ("sgd", {"learning_rate": lambda count: 0.3 * 0.5 ** count,
                     "momentum": 0.9})


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_dp", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mlp(g):
    net = g.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(g.nn.Dense(16, in_units=10, use_bias=False, prefix="fc1_"))
        net.add(g.nn.BatchNorm(in_channels=16, prefix="bn1_"))
        net.add(g.nn.Activation("relu"))
        net.add(g.nn.Dense(4, in_units=16, prefix="fc2_"))
    return net


def _mlp_values(net):
    rng = np.random.RandomState(1)
    out = {}
    for k, p in net.collect_params().items():
        v = rng.randn(*p.shape).astype("float32") * 0.3
        out[k] = np.abs(v) + 0.5 if k.endswith("_var") else v
    return out


def _batch():
    rng = np.random.RandomState(2)
    return (rng.randn(8, 10).astype("float32"),
            rng.randint(0, 4, 8).astype("float32"))


def _jax_mesh():
    return jparallel.local_mesh("dp", devices=jax.devices()[:1])


def _port_mesh():
    return parallel.local_mesh(devices=[mx.cpu()])


def _jax_mlp_run(opt, params, steps=3):
    net = _mlp(jgluon)
    net.initialize()
    values = _mlp_values(net)
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k]))
    trainer = jparallel.DataParallelTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_jax_mesh(), passes=False)
    x, y = _batch()
    losses = [float(trainer.step(jmx.nd.array(x), jmx.nd.array(y)))
              for _ in range(steps)]
    trainer.sync_to_net()
    return values, losses, {k: p.data().asnumpy()
                            for k, p in net.collect_params().items()}


@pytest.mark.parametrize("opt,params", OPTIMIZERS + [SCHEDULED],
                         ids=IDS + ["sgd-schedule"])
def test_bn_mlp_steps_match_jax(opt, params):
    """Losses, parameters and moving statistics after three steps; the
    net keeps its values until ``sync_to_net``."""
    values, jl, jw = _jax_mlp_run(opt, params)
    with mx.cpu():
        net = _mlp(gluon)
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(values[k])
        trainer = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
            mesh=_port_mesh())
        x, y = _batch()
        losses = [float(trainer.step(mx.nd.array(x), mx.nd.array(y)))
                  for _ in range(3)]
        for k, p in net.collect_params().items():
            np.testing.assert_array_equal(p.data().asnumpy(), values[k])
        trainer.sync_to_net()
    _close(losses, jl, "losses")
    for k, p in net.collect_params().items():
        _close(p.data().asnumpy(), jw[k], k)
        assert not np.array_equal(jw[k], values[k]) or k.endswith("fc1_bias")


def _lm(g):
    return g.contrib.transformer.TransformerLM(
        vocab_size=V, units=UNITS, num_layers=1, num_heads=HEADS,
        hidden_size=FFN, max_len=T, prefix="lm_")


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """The JAX LM with seeded weights, and its graph and weights written
    with the port's ``model.save_checkpoint`` under the graph's names."""
    cs = _chip_smoke()
    net = _lm(jgluon)
    net.initialize(jmx.init.Normal(0.02))
    rng = np.random.RandomState(3)
    x = rng.randint(0, V, (B, T)).astype("float32")
    y = rng.randint(0, V, (B, T)).astype("float32")
    net(jmx.nd.array(x))
    names = {n: p.name for n, p in cs.lm_param_map(net).items()}
    values = {p.name: p.data().asnumpy()
              for p in net.collect_params().values()}
    prefix = str(tmp_path_factory.mktemp("lm") / "lm")
    graph = cs.build_lm_symbol(mx.sym, V, UNITS, 1, HEADS, FFN, max_len=T)
    with mx.cpu():
        mx.model.save_checkpoint(
            prefix, 0, graph,
            {n: mx.nd.array(values[full]) for n, full in names.items()}, {})
    return {"prefix": prefix, "names": names, "values": values, "x": x,
            "y": y}


@pytest.mark.parametrize("opt,params", OPTIMIZERS, ids=IDS)
def test_symbolblock_lm_steps_match_jax_gluon_lm(lm_files, opt, params,
                                                 monkeypatch):
    """The port's trainer over ``SymbolBlock.imports`` of the LM's files
    against the JAX trainer over the JAX package's own gluon LM: the
    trainer's parameter names are the file's, and every weight after
    three steps equals the JAX one (the table, frozen, stays)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    f = lm_files
    net = _lm(jgluon)
    net.initialize()
    net(jmx.nd.array(f["x"]))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(f["values"][k]))
    jt = jparallel.DataParallelTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_jax_mesh(), passes=False)
    jl = [float(jt.step(jmx.nd.array(f["x"]), jmx.nd.array(f["y"])))
          for _ in range(3)]
    jt.sync_to_net()
    block = gluon.SymbolBlock.imports(f["prefix"] + "-symbol.json", ["data"],
                                      f["prefix"] + "-0000.params",
                                      ctx=mx.cpu())
    # the file's table is an argument of the graph; frozen, it is the
    # gluon LM's Constant again
    block.collect_params()["pos_table"].grad_req = "null"
    trainer = parallel.DataParallelTrainer(
        block, gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_port_mesh())
    losses = [float(trainer.step(mx.nd.array(f["x"], ctx=mx.cpu()),
                                 mx.nd.array(f["y"], ctx=mx.cpu())))
              for _ in range(3)]
    assert sorted(trainer._param_names) == sorted(
        n for n in f["names"] if n != "pos_table")
    trainer.sync_to_net()
    _close(losses, jl, "losses")
    params_out = block.collect_params()
    for n, full in f["names"].items():
        _close(params_out[n].data().asnumpy(),
               net.collect_params()[full].data().asnumpy(), n)


def test_sync_to_net_is_bitwise():
    with mx.cpu():
        net = _mlp(gluon)
        net.initialize()
        trainer = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 0.01}, mesh=_port_mesh())
        x, y = _batch()
        trainer.step(mx.nd.array(x), mx.nd.array(y))
        trainer.sync_to_net()
    for name, t in list(trainer._params.items()) + list(
            trainer._aux.items()):
        np.testing.assert_array_equal(
            net.collect_params()[name].data().asnumpy(),
            t.detach().numpy())
    assert "mlp_bn1_running_mean" in trainer._aux


@pytest.mark.parametrize("knob,value,item", [
    ("grad_guard", True, "A9"), ("loss_scaling", "dynamic", "A9"),
    ("remat", "full", "A1"), ("compute_dtype", "bfloat16", "A1"),
    ("passes", "default", "A9"), ("kvstore", "dist_sync", "A1"),
    ("grad_reduce", "reduce_scatter", "A1"), ("bucket_bytes", 1 << 20, "A1"),
    ("compression", {"type": "2bit"}, "A8"),
    ("dynamic_lr_scale", True, "A9"), ("step_attribution", True, "A9"),
    ("grad_reduce_dtype", "bfloat16", "A1"),
])
def test_unported_knobs_raise(knob, value, item):
    with pytest.raises(NotImplementedError, match=item):
        parallel.DataParallelTrainer(
            _mlp(gluon), gluon.loss.L2Loss(), "sgd", mesh=_port_mesh(),
            **{knob: value})


def test_unported_mesh_and_aot_raise():
    with pytest.raises(NotImplementedError, match="A1"):
        parallel.local_mesh(devices=[mx.cpu(0), mx.cpu(1)])
    trainer = parallel.DataParallelTrainer(
        _mlp(gluon), gluon.loss.L2Loss(), "sgd", mesh=_port_mesh())
    with pytest.raises(NotImplementedError, match="A9"):
        trainer.aot_save("x")
    with pytest.raises(mx.MXNetError, match="takes no"):
        parallel.DataParallelTrainer(_mlp(gluon), gluon.loss.L2Loss(), "sgd",
                                     {"beta1": 0.9}, mesh=_port_mesh())


# ------------------------------------------------------------- SymbolBlock
@pytest.fixture(scope="module")
def mlp_files(tmp_path_factory):
    """The BN MLP exported by each package's ``HybridBlock.export``."""
    out = {}
    x, _ = _batch()
    for pkg, g in ((jmx, jgluon), (mx, gluon)):
        with pkg.cpu():
            net = _mlp(g)
            net.initialize()
            values = _mlp_values(net)
            for k, p in net.collect_params().items():
                p.set_data(pkg.nd.array(values[k]) if pkg is jmx
                           else values[k])
            net.hybridize()
            net(pkg.nd.array(x))
            path = str(tmp_path_factory.mktemp(pkg.__name__) / "mlp")
            out[pkg.__name__] = net.export(path)
    return out


def _imports_step(pkg, g, ag, files):
    """Forward, then one recorded step of ``gluon.Trainer`` (SGD): the
    output, the updated weights and the moving statistics."""
    x, y = _batch()
    with pkg.cpu():
        block = g.SymbolBlock.imports(files[0], ["data"], files[1],
                                      ctx=pkg.cpu())
        out0 = block(pkg.nd.array(x)).asnumpy()
        trainer = g.Trainer(block.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        loss_fn = g.loss.SoftmaxCrossEntropyLoss()
        with ag.record():
            loss = loss_fn(block(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        trainer.step(8)
    return out0, {k: p.data().asnumpy()
                  for k, p in block.collect_params().items()}


@pytest.mark.parametrize("writer", ["mxnet_tpu", "mxnet_tpu_torch"])
def test_symbolblock_imports_forward_and_step_match_jax(mlp_files, writer):
    """Files exported by either package: both packages' ``SymbolBlock``
    give the same forward and the same weights and moving statistics
    after one ``gluon.Trainer`` step. The port makes the moving
    statistics ``grad_req="null"`` parameters, as the reference does."""
    files = mlp_files[writer]
    jout, jw = _imports_step(jmx, jgluon, jag, files)
    out, w = _imports_step(mx, gluon, autograd, files)
    _close(out, jout, "forward")
    assert sorted(w) == sorted(jw)
    for k in jw:
        _close(w[k], jw[k], k)
    block = gluon.SymbolBlock.imports(files[0], ["data"], files[1],
                                      ctx=mx.cpu())
    reqs = {k: p.grad_req for k, p in block.collect_params().items()}
    assert reqs["mlp_bn1_running_mean"] == "null"
    assert reqs["mlp_fc1_weight"] == "write"


def test_gluon_batchnorm_trains_like_hybridized_jax():
    """An eager ``gluon.Trainer`` step of the BN MLP: the port's BatchNorm
    folds the batch statistics into its moving ones as the reference's
    imperative one does, as the JAX package's hybridized net does (its
    eager one does not); output, weights and moving statistics agree."""
    x, y = _batch()
    res = []
    for pkg, g, ag in ((jmx, jgluon, jag), (mx, gluon, autograd)):
        with pkg.cpu():
            net = _mlp(g)
            net.initialize()
            values = _mlp_values(net)
            for k, p in net.collect_params().items():
                p.set_data(pkg.nd.array(values[k]) if pkg is jmx
                           else values[k])
            if pkg is jmx:
                net.hybridize()
            trainer = g.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
            with ag.record():
                out = net(pkg.nd.array(x))
                loss = g.loss.SoftmaxCrossEntropyLoss()(out, pkg.nd.array(y))
            loss.backward()
            trainer.step(8)
            res.append((out.asnumpy(), {k: p.data().asnumpy() for k, p in
                                        net.collect_params().items()}))
    _close(res[1][0], res[0][0], "output")
    for k, want in res[0][1].items():
        _close(res[1][1][k], want, k)
    assert not np.allclose(res[1][1]["mlp_bn1_running_mean"],
                           _mlp_values(_mlp(gluon))["mlp_bn1_running_mean"])

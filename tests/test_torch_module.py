"""PyTorch port, the Module route, against the JAX package: ``io``'s
``NDArrayIter``, ``metric``, ``callback``, ``model``'s checkpoints and
``mx.mod.Module`` (``fit``, ``score``, ``predict``, the optimizer states).

Two models: the toy MLP of ``tests/test_module.py`` (FullyConnected 16,
ReLU, FullyConnected 4, ``SoftmaxOutput``) on 64 × 10 inputs, and the
causal LM graph of ``chip_smoke.py`` (2 layers, 32 units, 4 heads, FFN
64, vocab 50, 2 × 16 tokens) under a ``MakeLoss(softmax_cross_entropy)``
head. The JAX package runs with ``passes=False`` (its default pipeline
rewrites nothing on either graph: ``test_jax_default_passes_leave_these_
graphs``). Tolerance: parameters, outputs and scores within 1e-5 relative
to the tensor's largest entry.

The JAX package infers no shape from a variable's ``shape`` hint, so its
Module cannot bind the LM graph from the data shapes alone (the port's,
like the reference's, reads the hint): on the JAX side the positional
table is fed as a second data input, which takes no gradient, and on the
port's it is a fixed parameter.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import interop
from mxnet_tpu.io import DataBatch as JDataBatch
from mxnet_tpu.io import NDArrayIter as JNDArrayIter
from mxnet_tpu.module import Module as JModule
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
V, UNITS, LAYERS, HEADS, FFN, B, T = 50, 32, 2, 4, 64, 2, 16


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mlp_sym(sym):
    fc1 = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    fc2 = sym.FullyConnected(sym.Activation(fc1, act_type="relu"),
                             num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def _toy_data(n=64, d=10, classes=4):
    rng = np.random.RandomState(170)
    x = rng.randn(n, d).astype("float32")
    w = rng.randn(d, classes).astype("float32")
    return x, (x @ w).argmax(axis=1).astype("float32")


def _mlp_params():
    rng = np.random.RandomState(3)
    return {"fc1_weight": rng.randn(16, 10).astype("f") * 0.3,
            "fc1_bias": rng.randn(16).astype("f") * 0.1,
            "fc2_weight": rng.randn(4, 16).astype("f") * 0.3,
            "fc2_bias": rng.randn(4).astype("f") * 0.1}


def _on(pkg, ctx, values):
    return {n: pkg.nd.array(v, ctx=ctx) for n, v in values.items()}


def _np(params):
    return {n: a.asnumpy() for n, a in params.items()}


# ------------------------------------------------------------------- io
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_match_jax(handle):
    """Ten samples in batches of four over three epochs: data, label and
    pad of every batch, and the provided descriptions."""
    x = np.arange(40, dtype="float32").reshape(10, 4)
    y = np.arange(10, dtype="float32")
    its = [pkg(x, y, batch_size=4, last_batch_handle=handle)
           for pkg in (JNDArrayIter, mx.io.NDArrayIter)]
    assert [tuple(d) for d in its[1].provide_data] == \
        [tuple(d) for d in its[0].provide_data]
    assert [tuple(d) for d in its[1].provide_label] == \
        [tuple(d) for d in its[0].provide_label]
    for _ in range(3):
        got = [[(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it] for it in its]
        assert len(got[0]) == len(got[1]) > 0
        for (dj, lj, pj), (dp, lp, pp) in zip(*got):
            np.testing.assert_array_equal(dp, dj)
            np.testing.assert_array_equal(lp, lj)
            assert pp == pj
        for it in its:
            it.reset()
    assert its[1].getdata()[0].context == mx.cpu()


# ------------------------------------------------------------------- metric
def test_metrics_match_jax():
    rng = np.random.RandomState(4)
    probs = rng.rand(12, 5).astype("f")
    probs /= probs.sum(1, keepdims=True)
    label = rng.randint(0, 5, 12).astype("f")
    label[3] = 2.0
    reg = rng.randn(12).astype("f")
    cases = [("acc", {}), ("top_k_accuracy", {"top_k": 2}), ("ce", {}),
             ("perplexity", {"ignore_label": 2}), ("mse", {}),
             ("loss", {}), (["acc", "ce"], {}),
             (lambda lab, p: float((p.argmax(1) == lab).mean()), {})]
    for name, kw in cases:
        got = []
        for pkg in (jmx, mx):
            m = pkg.metric.create(name, **kw)
            for _ in range(2):
                if name == "mse":
                    m.update([pkg.nd.array(reg, ctx=pkg.cpu())],
                             [pkg.nd.array(reg * 0.5, ctx=pkg.cpu())])
                else:
                    m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                             [pkg.nd.array(probs, ctx=pkg.cpu())])
            got.append(m.get_name_value())
        assert [n for n, _ in got[1]] == [n for n, _ in got[0]], name
        _close([v for _, v in got[1]], [v for _, v in got[0]], str(name))


# ------------------------------------------------------------------- model
def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by either package's ``save_checkpoint`` loads
    in the other: the graph's arguments and every value."""
    arg = _mlp_params()
    aux = {"bn_moving_mean": np.arange(3, dtype="f")}
    for writer, reader in ((jmx, mx), (mx, jmx)):
        prefix = str(tmp_path / writer.__name__)
        writer.model.save_checkpoint(prefix, 2, _mlp_sym(writer.sym),
                                     _on(writer, writer.cpu(), arg),
                                     _on(writer, writer.cpu(), aux))
        sym, a, x = reader.model.load_checkpoint(prefix, 2)
        assert sym.list_arguments() == _mlp_sym(mx.sym).list_arguments()
        assert sorted(a) == sorted(arg) and sorted(x) == sorted(aux)
        for n in arg:
            np.testing.assert_array_equal(a[n].asnumpy(), arg[n])
        np.testing.assert_array_equal(x["bn_moving_mean"].asnumpy(),
                                      aux["bn_moving_mean"])
    assert a["fc1_weight"].context == jmx.cpu()


# ------------------------------------------------------------------- module
def _fit(pkg, mod, x, y, epochs, **fit_kw):
    it = pkg.io.NDArrayIter(x, y, batch_size=16, shuffle=False)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=_on(pkg, pkg.cpu(), _mlp_params()), **fit_kw)
    return mod


def test_module_fit_score_predict_match_jax(tmp_path):
    """Two epochs of ``fit`` (MXNet's SGD with momentum, the local store),
    with the callbacks; then ``score`` and ``predict``."""
    x, y = _toy_data()
    jmod = _fit(jmx, JModule(_mlp_sym(jmx.sym), context=jmx.cpu(),
                             passes=False), x, y, 2)
    prefix = str(tmp_path / "fit")
    seen = []
    mod = _fit(mx, mx.mod.Module(_mlp_sym(mx.sym), context=mx.cpu()), x, y,
               2, batch_end_callback=[mx.callback.Speedometer(16, 2),
                                      mx.callback.log_train_metric(2),
                                      seen.append],
               epoch_end_callback=mx.callback.do_checkpoint(prefix))
    assert len(seen) == 8 and seen[-1].epoch == 1
    got, want = _np(mod.get_params()[0]), _np(jmod.get_params()[0])
    for n in want:
        _close(got[n], want[n], n)
        assert not np.allclose(got[n], _mlp_params()[n])
    _, saved, _ = mx.model.load_checkpoint(prefix, 2)
    for n in got:
        np.testing.assert_array_equal(saved[n].asnumpy(), got[n])
    score = [dict(m.score(pkg.io.NDArrayIter(x, y, batch_size=16), "acc"))
             for pkg, m in ((jmx, jmod), (mx, mod))]
    assert score[1]["accuracy"] == score[0]["accuracy"] > 0.5
    # 60 samples in batches of 16: the last batch is padded and cut
    preds = [m.predict(pkg.io.NDArrayIter(x[:60], y[:60], batch_size=16))
             .asnumpy() for pkg, m in ((jmx, jmod), (mx, mod))]
    assert preds[1].shape == (60, 4)
    _close(preds[1], preds[0], "predict")


def test_module_resumes_from_its_checkpoint(tmp_path):
    """``save_checkpoint(save_optimizer_states=True)`` after one epoch and
    ``Module.load(..., load_optimizer_states=True)``: the second epoch
    lands where an uninterrupted two-epoch run does (the momentum and the
    update counts come back)."""
    x, y = _toy_data()
    with mx.cpu():
        whole = _fit(mx, mx.mod.Module(_mlp_sym(mx.sym)), x, y, 2)
        first = _fit(mx, mx.mod.Module(_mlp_sym(mx.sym)), x, y, 1)
        prefix = str(tmp_path / "resume")
        first.save_checkpoint(prefix, 1, save_optimizer_states=True)
        again = mx.mod.Module.load(prefix, 1, load_optimizer_states=True)
        again.fit(mx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                  begin_epoch=1, optimizer="sgd",
                  optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    got, want = _np(again.get_params()[0]), _np(whole.get_params()[0])
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-7)


def test_module_reshape_keeps_the_parameters():
    """``reshape`` to another batch size keeps the trained parameters (the
    JAX package's rebinds zeros: its outputs after ``reshape`` no longer
    depend on the data) and gives the same outputs on the same rows."""
    x, y = _toy_data()
    outs = []
    for pkg, mod in ((jmx, JModule(_mlp_sym(jmx.sym), context=jmx.cpu(),
                                   passes=False)),
                     (mx, mx.mod.Module(_mlp_sym(mx.sym), context=mx.cpu()))):
        _fit(pkg, mod, x, y, 1)
        before = mod.predict(pkg.io.NDArrayIter(x[:16], y[:16],
                                                batch_size=16)).asnumpy()
        mod.reshape([("data", (8, 10))], [("softmax_label", (8,))])
        after = mod.predict(pkg.io.NDArrayIter(x[:16], y[:16],
                                               batch_size=8)).asnumpy()
        outs.append((before, after))
    (jb, ja), (pb, pa) = outs
    _close(pb, jb, "before reshape")
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_allclose(ja, 0.25, rtol=1e-6)


def test_module_refuses_unported_options():
    s = _mlp_sym(mx.sym)
    # passes= is ported; a spelling that names no pass is refused, as the
    # JAX package refuses it
    with pytest.raises(mx.MXNetError, match="unknown graph pass"):
        mx.mod.Module(s, context=mx.cpu(), passes="default")
    with pytest.raises(NotImplementedError, match="A8"):
        mx.mod.Module(s, context=[mx.cpu(0), mx.cpu(1)]).bind(
            [("data", (4, 10))], [("softmax_label", (4,))])
    mod = mx.mod.Module(s, context=mx.cpu())
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))])
    mod.init_params()
    with pytest.raises(NotImplementedError, match="A8"):
        mod.init_optimizer(kvstore="dist_sync")


def test_jax_default_passes_leave_these_graphs():
    """The JAX package's Module with its default pipeline (``passes=None``)
    binds the graphs unchanged, so ``passes=False`` in the parity tests
    changes nothing."""
    mod = JModule(_mlp_sym(jmx.sym), context=jmx.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    assert mod._passes is not None and mod._pass_result is None
    jlm = JModule(_lm_head(jmx.sym, None), data_names=("data", "pos_table"),
                  label_names=("label",), context=jmx.cpu())
    jlm.bind([("data", (B, T)), ("pos_table", (T, UNITS))],
             [("label", (B, T))])
    assert jlm._pass_result is None


def _lm_head(sym, max_len):
    lm = _chip_smoke().build_lm_symbol(sym, V, UNITS, LAYERS, HEADS, FFN,
                                       max_len=max_len)
    return sym.MakeLoss(sym.softmax_cross_entropy(
        sym.reshape(lm, shape=(-1, V)),
        sym.reshape(sym.Variable("label"), shape=(-1,))))


def test_module_lm_makeloss_adam_steps_match_jax(monkeypatch):
    """The LM graph under ``MakeLoss(softmax_cross_entropy)``, two Adam
    steps (``rescale_grad`` 1/(B·T)): the loss output and every parameter
    after each step."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    cs = _chip_smoke()
    lm = cs.build_lm_symbol(mx.sym, V, UNITS, LAYERS, HEADS, FFN, max_len=T)
    arg, _, _ = lm.infer_shape(data=(B, T))
    rng = np.random.RandomState(5)
    params = {n: (rng.randn(*s) * 0.1).astype("f")
              for n, s in zip(lm.list_arguments(), arg)
              if n not in ("data", "pos_table")}
    table = cs.sinusoid_table(T, UNITS)
    batches = [(rng.randint(0, V, (B, T)).astype("f"),
                rng.randint(0, V, (B, T)).astype("f")) for _ in range(2)]
    opt = {"learning_rate": 1e-3, "rescale_grad": 1.0 / (B * T)}

    jmod = JModule(_lm_head(jmx.sym, None), data_names=("data", "pos_table"),
                   label_names=("label",), context=jmx.cpu(), passes=False)
    jmod.bind([("data", (B, T)), ("pos_table", (T, UNITS))],
              [("label", (B, T))])
    jmod.init_params(arg_params=_on(jmx, jmx.cpu(), params))
    jmod.init_optimizer(optimizer="adam", optimizer_params=opt)
    mod = mx.mod.Module(_lm_head(mx.sym, T), data_names=("data",),
                        label_names=("label",), context=mx.cpu(),
                        fixed_param_names=["pos_table"])
    it = mx.io.NDArrayIter({"data": np.concatenate([b[0] for b in batches])},
                           {"label": np.concatenate([b[1] for b in batches])},
                           batch_size=B)
    mod.bind(it.provide_data, it.provide_label)
    arg_params, aux_params = interop.module_params_from_numpy(
        {"arg:" + n: v for n, v in dict(params, pos_table=table).items()},
        mx.cpu())
    assert aux_params == {}
    mod.init_params(arg_params=arg_params)
    mod.init_optimizer(optimizer="adam", optimizer_params=opt)
    for (x, y), batch in zip(batches, it):
        jmod.forward_backward(JDataBatch(
            [jmx.nd.array(x), jmx.nd.array(table)], [jmx.nd.array(y)]))
        jmod.update()
        mod.forward_backward(batch)
        mod.update()
        _close(mod.get_outputs()[0].asnumpy(),
               jmod.get_outputs()[0].asnumpy(), "loss")
        got, want = _np(mod.get_params()[0]), _np(jmod.get_params()[0])
        for n in params:
            _close(got[n], want[n], n)
    np.testing.assert_array_equal(got["pos_table"], table)
    assert not np.allclose(got["head_weight"], params["head_weight"])

"""PyTorch port, the symbolic executor's training half, against the JAX
package: ``simple_bind``/``bind``, ``forward(is_train=True)`` and
``backward`` with ``grad_req`` write/add/null, head gradients, the
BatchNorm moving statistics, ``reshape``, ``copy_params_from``, and the
ops with the reference's own backward (``SoftmaxOutput``, ``MakeLoss``,
``BlockGrad``).

Two graphs: an MLP (FullyConnected, BatchNorm, ReLU, FullyConnected,
``SoftmaxOutput``) on 8 × 10 inputs, and the causal LM graph of
``chip_smoke.py`` at 2 layers, 32 units, 4 heads, FFN 64, vocab 50,
2 × 16 tokens (head dim 8, so the JAX package takes its plain attention
path, as its own CPU tests do). Both packages get the same numpy values.
Tolerance: outputs, gradients and moving statistics within 1e-5 relative
to the tensor's largest entry (both sides float32, another summation
order).
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5
V, UNITS, LAYERS, HEADS, FFN, B, T = 50, 32, 2, 4, 64, 2, 16
PKGS = ((jmx, jmx.cpu), (mx, mx.cpu))


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_exec", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mlp(sym, fix_gamma=False, **head):
    fc1 = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             no_bias=True, name="fc1")
    bn = sym.BatchNorm(fc1, fix_gamma=fix_gamma, name="bn1")
    fc2 = sym.FullyConnected(sym.Activation(bn, act_type="relu"),
                             num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax", **head)


def _values(shapes, seed, skip=("data", "softmax_label")):
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in shapes.items():
        if n in skip:
            continue
        v = rng.randn(*s).astype("float32") * 0.5
        out[n] = np.abs(v) + 0.5 if n.endswith("_var") else v
    return out


def _close(got, want, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _bind(pkg, ctx, sym_fn, shapes, values, grad_req="write"):
    """simple_bind at ``shapes``, then the parameters from ``values``."""
    s = sym_fn(pkg.sym)
    ex = s.simple_bind(ctx(), grad_req=grad_req, **shapes)
    arrays = {n: pkg.nd.array(v, ctx=ctx()) for n, v in values.items()}
    ex.copy_params_from({n: a for n, a in arrays.items()
                         if n in ex.arg_dict},
                        {n: a for n, a in arrays.items()
                         if n in ex.aux_dict})
    return ex


def _state(ex):
    return ([o.asnumpy() for o in ex.outputs],
            {n: g.asnumpy() for n, g in ex.grad_dict.items()},
            {n: a.asnumpy() for n, a in ex.aux_dict.items()})


def _compare(a, b):
    (oa, ga, xa), (ob, gb, xb) = a, b
    for i, (u, v) in enumerate(zip(ob, oa)):
        _close(u, v, f"output {i}")
    assert sorted(ga) == sorted(gb)
    for n in ga:
        _close(gb[n], ga[n], f"grad {n}")
    for n in xa:
        _close(xb[n], xa[n], f"aux {n}")


def _mlp_shapes():
    s = _mlp(mx.sym)
    arg, _, aux = s.infer_shape(data=(8, 10), softmax_label=(8,))
    shapes = dict(zip(s.list_arguments(), arg))
    shapes.update(zip(s.list_auxiliary_states(), aux))
    return shapes


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 10).astype("float32"),
            rng.randint(0, 4, n).astype("float32"))


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_mlp_train_steps_match_jax(fix_gamma):
    """Two train forwards and backwards on other batches: outputs, every
    gradient (gamma's is zero under fix_gamma) and the moving statistics,
    which the second forward folds in again."""
    values = _values(_mlp_shapes(), seed=1)
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, lambda s: _mlp(s, fix_gamma=fix_gamma),
                   {"data": (8, 10), "softmax_label": (8,)}, values)
        steps = []
        for seed in (0, 1):
            x, y = _batch(seed)
            ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()),
                       softmax_label=pkg.nd.array(y, ctx=ctx()))
            ex.backward()
            steps.append(_state(ex))
        res.append(steps)
    for a, b in zip(*res):
        _compare(a, b)
    if fix_gamma:
        assert not res[1][0][1]["bn1_gamma"].any()
    moved = res[1][1][2]["bn1_moving_mean"] - values["bn1_moving_mean"]
    assert np.abs(moved).max() > 1e-3


def test_inference_forward_leaves_moving_statistics():
    values = _values(_mlp_shapes(), seed=1)
    ex = _bind(mx, mx.cpu, _mlp, {"data": (8, 10), "softmax_label": (8,)},
               values)
    x, y = _batch()
    ex.forward(is_train=False, data=mx.nd.array(x, ctx=mx.cpu()))
    for n, a in ex.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), values[n])
    with pytest.raises(MXNetError, match="without forward"):
        ex.backward()


def test_lm_graph_train_step_matches_jax(monkeypatch):
    """The LM graph's logits and every gradient of their sum (the default
    head gradient: ones on every output)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    cs = _chip_smoke()
    lm = cs.build_lm_symbol(mx.sym, V, UNITS, LAYERS, HEADS, FFN)
    arg, _, _ = lm.infer_shape(data=(B, T), pos_table=(T, UNITS))
    shapes = dict(zip(lm.list_arguments(), arg))
    values = _values(shapes, seed=2, skip=("data",))
    values = {n: v * 0.2 for n, v in values.items()}
    values["pos_table"] = cs.sinusoid_table(T, UNITS)
    tokens = np.random.RandomState(3).randint(0, V, (B, T)).astype("f")
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, lambda s: cs.build_lm_symbol(
            s, V, UNITS, LAYERS, HEADS, FFN),
            {"data": (B, T), "pos_table": (T, UNITS)}, values)
        ex.forward(is_train=True, data=pkg.nd.array(tokens, ctx=ctx()))
        ex.backward()
        res.append(_state(ex))
    _compare(*res)
    assert len(res[1][1]) == len(shapes)


def test_grad_req_write_add_null_match_jax():
    """``add`` accumulates over two backwards, ``write`` keeps the last,
    ``null`` takes nothing. The port's ``simple_bind`` makes no buffer for
    a ``null`` argument (the reference's rule); the JAX package's makes
    zeros, which stay zero."""
    values = _values(_mlp_shapes(), seed=4)
    req = dict.fromkeys(_mlp(mx.sym).list_arguments(), "write")
    req.update({"fc1_weight": "add", "bn1_gamma": "add",
                "fc2_bias": "null", "data": "null", "softmax_label": "null"})
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, _mlp, {"data": (8, 10), "softmax_label": (8,)},
                   values, grad_req=req)
        for seed in (0, 1):
            x, y = _batch(seed)
            ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()),
                       softmax_label=pkg.nd.array(y, ctx=ctx()))
            ex.backward()
        res.append(_state(ex))
    nulls = [n for n, r in req.items() if r == "null"]
    assert not set(nulls) & set(res[1][1])
    for n in nulls:
        assert not res[0][1].pop(n).any()
    _compare(*res)


def _two_head(sym):
    """Two plain outputs: no loss head, so the head gradient counts."""
    fc = sym.FullyConnected(sym.Variable("data"), num_hidden=6, name="fc")
    return sym.Group([sym.Activation(fc, act_type="tanh"),
                      sym.square(fc)])


@pytest.mark.parametrize("form", ["list", "one"])
def test_out_grads_match_jax(form):
    rng = np.random.RandomState(5)
    values = {"fc_weight": rng.randn(6, 5).astype("f"),
              "fc_bias": rng.randn(6).astype("f")}
    x = rng.randn(3, 5).astype("f")
    heads = [rng.randn(3, 6).astype("f") for _ in range(2)]
    graph = _two_head if form == "list" else \
        (lambda s: _two_head(s)[0])
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, graph, {"data": (3, 5)}, values)
        ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()))
        hg = [pkg.nd.array(h, ctx=ctx()) for h in heads]
        ex.backward(hg if form == "list" else hg[0])
        res.append(_state(ex))
    _compare(*res)


def test_reshape_and_copy_params_from_match_jax():
    """``reshape`` to batch 4 shares the parameters (and their gradient
    buffers); ``copy_params_from`` then sets new values; a train step on
    each side agrees."""
    values = _values(_mlp_shapes(), seed=6)
    newer = _values(_mlp_shapes(), seed=7)
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, _mlp, {"data": (8, 10), "softmax_label": (8,)},
                   values)
        ex2 = ex.reshape(data=(4, 10), softmax_label=(4,))
        assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        assert ex2.arg_dict["data"].shape == (4, 10)
        ex2.copy_params_from(
            {n: pkg.nd.array(v, ctx=ctx()) for n, v in newer.items()
             if n in ex2.arg_dict},
            {n: pkg.nd.array(v, ctx=ctx()) for n, v in newer.items()
             if n in ex2.aux_dict})
        x, y = _batch(8, n=4)
        ex2.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()),
                    softmax_label=pkg.nd.array(y, ctx=ctx()))
        ex2.backward()
        res.append(_state(ex2))
    _compare(*res)
    assert res[1][0][0].shape == (4, 4)
    with pytest.raises(MXNetError, match="unknown argument"):
        _bind(mx, mx.cpu, _mlp, {"data": (8, 10), "softmax_label": (8,)},
              values).copy_params_from(
            {"nope": mx.nd.array(np.zeros(1), ctx=mx.cpu())})


def _loss_graph(sym, normalization):
    fc = sym.FullyConnected(sym.Variable("data"), num_hidden=4, name="fc")
    target = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                name="tgt")
    diff = sym.square(fc - sym.BlockGrad(target))
    return sym.Group([sym.MakeLoss(diff, grad_scale=0.5,
                                   normalization=normalization,
                                   valid_thresh=0.1),
                      sym.BlockGrad(fc)])


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_makeloss_and_blockgrad_gradients_match_jax(normalization):
    """MakeLoss ignores its head gradient and emits ``grad_scale`` (per
    batch or per valid element); BlockGrad stops the target's gradient
    and takes none from its own output."""
    rng = np.random.RandomState(9)
    values = {n: rng.randn(*s).astype("f") for n, s in
              (("fc_weight", (4, 5)), ("fc_bias", (4,)),
               ("tgt_weight", (4, 5)), ("tgt_bias", (4,)))}
    x = rng.randn(6, 5).astype("f")
    res = []
    for pkg, ctx in PKGS:
        ex = _bind(pkg, ctx, lambda s: _loss_graph(s, normalization),
                   {"data": (6, 5)}, values)
        ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()))
        ex.backward([pkg.nd.array(np.full((6, 4), 7.0, "f"), ctx=ctx()),
                     pkg.nd.array(np.ones((6, 4), "f"), ctx=ctx())])
        res.append(_state(ex))
    _compare(*res)
    assert not res[1][1]["tgt_weight"].any()
    assert res[1][1]["fc_weight"].any()


@pytest.mark.parametrize("head", [
    {"grad_scale": 2.0},
    {"use_ignore": True, "ignore_label": 1.0, "normalization": "valid"},
    {"normalization": "batch"},
    {"multi_output": True},
])
def test_softmax_output_options_match_jax(head):
    rng = np.random.RandomState(11)
    if head.get("multi_output"):
        shapes, lab = {"data": (4, 3, 5)}, rng.randint(0, 3, (4, 5))

        def graph(s):
            return s.SoftmaxOutput(s.Variable("data"),
                                   s.Variable("softmax_label"), **head)
    else:
        shapes, lab = {"data": (6, 4)}, rng.randint(0, 4, 6)

        def graph(s):
            return s.SoftmaxOutput(s.Variable("data"),
                                   s.Variable("softmax_label"), **head)
    x = rng.randn(*shapes["data"]).astype("f")
    res = []
    for pkg, ctx in PKGS:
        ex = graph(pkg.sym).simple_bind(
            ctx(), softmax_label=lab.shape, **shapes)
        ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx()),
                   softmax_label=pkg.nd.array(lab.astype("f"), ctx=ctx()))
        ex.backward()
        res.append(_state(ex))
    _compare(*res)


def test_bind_defaults_to_grad_req_write_like_jax():
    """``bind`` without ``grad_req`` writes gradients into ``args_grad``
    in both packages (the port defaulted to ``null`` before)."""
    rng = np.random.RandomState(12)
    w = rng.randn(3, 4).astype("f")
    x = rng.randn(2, 4).astype("f")
    got = []
    for pkg, ctx in PKGS:
        s = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                   no_bias=True, name="fc")
        args = {"data": pkg.nd.array(x, ctx=ctx()),
                "fc_weight": pkg.nd.array(w, ctx=ctx())}
        grads = {"fc_weight": pkg.nd.zeros((3, 4), ctx=ctx())}
        ex = s.bind(ctx(), args, args_grad=grads)
        ex.forward(is_train=True)
        ex.backward()
        got.append(ex.grad_dict["fc_weight"].asnumpy())
    _close(got[1], got[0], "fc_weight")
    np.testing.assert_allclose(got[1], np.tile(x.sum(0), (3, 1)),
                               rtol=1e-6)


def test_executor_saves_what_gluon_saves(tmp_path):
    """The interpreted graph's training forward keeps for the backward the
    same tensors, by bytes, as the gluon LM's forward under
    ``autograd.record()`` (torch autograd's saved tensors, counted once a
    storage): the executor holds no activation of its own."""
    import torch
    from mxnet_tpu_torch import autograd
    cs = _chip_smoke()
    cs.OPT_6_7B = dict(vocab=V, units=UNITS, heads=HEADS, ffn=FFN,
                       max_len=T, layers=LAYERS)
    cs.TRAIN_BATCH = B
    x, y = cs.train_batch()
    saved = []

    def count(run):
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            run()
        saved.append(sum(storages.values()))

    with mx.cpu():
        net = cs.seeded_lm(mx)
        net(mx.nd.array(x))

        def gluon_forward():
            with autograd.record():
                mx.nd.softmax_cross_entropy(
                    net(mx.nd.array(x)).reshape((-1, V)),
                    mx.nd.array(y).reshape((-1,)))

        count(gluon_forward)
        prefix = str(tmp_path / "lm")
        cs.export_lm(mx, prefix)
        lm, arg, _ = mx.model.load_checkpoint(prefix, 0)
        it = mx.io.NDArrayIter({"data": x}, {"label": y}, batch_size=B)
        mod = mx.mod.Module(cs.lm_loss_head(mx.sym, lm, V),
                            data_names=("data",), label_names=("label",),
                            fixed_param_names=["pos_table"])
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=arg)
        count(lambda: mod.forward(it.next(), is_train=True))
    assert saved[0] > 0 and saved[1] == saved[0]

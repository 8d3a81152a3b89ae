"""PyTorch port, the recurrent family against the JAX package: the ``RNN``
op, ``gluon.rnn``'s layers and cells, ``mx.rnn``'s symbolic cells (and
``FusedRNNCell``'s packing), ``BucketSentenceIter``, the RNN checkpoints,
the new initializers and ``gluon.utils``.

The same numpy inputs (and weights, carried across by name) go through
both packages. Tolerance: float32 within 1e-5 of the reference's largest
entry (the same arithmetic; the port folds the two biases of a step into
the input projection, the JAX op adds them one after the other). Dropout
and zoneout cannot reproduce JAX's threefry bits: their parity runs at
p = 0, and p > 0 is held by what the mask must do.
"""
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch import interop
from mxnet_tpu_torch.ops.registry import get_op as torch_op
from mxnet_tpu_torch.ops.rnn import rnn_packed_param_size
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
T, B, I, H, L = 5, 3, 4, 6, 2
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _seeded(name, shape, scale=0.3):
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    return (rs.uniform(-scale, scale, shape)).astype("float32")


class _JaxSeeded(jmx.init.Initializer):
    """Weights from the parameter's name, the same in both packages."""

    def _init_weight(self, name, arr):
        arr[:] = _seeded(name, arr.shape)

    _init_bias = _init_weight


class _PortSeeded(mx.init.Initializer):
    def _init_weight(self, name, arr):
        arr.copy_(torch.from_numpy(_seeded(name, tuple(arr.shape))))

    _init_bias = _init_weight


# ---------------------------------------------------------------- the op
def _op_inputs(mode, bi, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = rnn_packed_param_size(mode, L, bi, I, H)
    ins = [rs.randn(T, B, I).astype("float32"),
           (rs.randn(n) * 0.3).astype("float32"),
           rs.randn(L * d, B, H).astype("float32")]
    if mode == "lstm":
        ins.append(rs.randn(L * d, B, H).astype("float32"))
    cts = [rs.randn(T, B, d * H).astype("float32")] + \
        [rs.randn(L * d, B, H).astype("float32") for _ in ins[3:] + [0]]
    return ins, cts


def _attrs(mode, bi, **kw):
    return dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
                state_outputs=True, is_train=False, **kw)


def _jax_rnn_vjp(mode, bi, ins, cts):
    outs, vjp = jax.vjp(lambda *a: jax_op("RNN").fn(*a, **_attrs(mode, bi)),
                        *ins)
    return outs, vjp(tuple(cts))


_jax_rnn_vjp_jit = jax.jit(_jax_rnn_vjp, static_argnums=(0, 1))


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_outputs_and_grads_match_jax(mode, bi):
    """Outputs, ``hn`` (and ``cn``), and the gradients with respect to the
    data, the packed parameters and the states (``jax.vjp`` against torch
    autograd, the same cotangents), 2 layers."""
    ins, cts = _op_inputs(mode, bi)
    want, want_grads = _jax_rnn_vjp_jit(mode, bi, [jnp.asarray(a) for a in
                                                  ins],
                                        [jnp.asarray(c) for c in cts])
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = torch_op("RNN").fn(*ts, **_attrs(mode, bi))
    assert len(got) == len(want) == (3 if mode == "lstm" else 2)
    grads = torch.autograd.grad(got, ts, [torch.from_numpy(c) for c in cts])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy(), w, what=f"output {i}")
    for name, g, w in zip(("data", "parameters", "state", "state_cell"),
                          grads, want_grads):
        _close(g.numpy(), w, what=f"d{name}")


@pytest.mark.parametrize("mode,layers,bi,size", [
    ("lstm", 1, False, 7), ("gru", 2, True, 4), ("rnn_relu", 3, False, 5),
    ("rnn_tanh", 2, True, 1)])
def test_rnn_packed_param_size_matches_jax(mode, layers, bi, size):
    from mxnet_tpu.ops.rnn import rnn_packed_param_size as jax_size
    assert rnn_packed_param_size(mode, layers, bi, size, 6) == \
        jax_size(mode, layers, bi, size, 6)


def test_rnn_op_one_row_state_and_single_output_match_jax():
    """A ``(1, H)`` initial state is broadcast to the batch;
    ``state_outputs=False`` gives the output alone."""
    rs = np.random.RandomState(3)
    n = rnn_packed_param_size("lstm", 1, False, I, H)
    ins = [rs.randn(T, B, I).astype("float32"),
           (rs.randn(n) * 0.3).astype("float32"),
           rs.randn(1, 1, H).astype("float32"),
           rs.randn(1, 1, H).astype("float32")]
    attrs = dict(state_size=H, num_layers=1, mode="lstm", is_train=False)
    want = jax_op("RNN").fn(*[jnp.asarray(a) for a in ins], **attrs)
    got = torch_op("RNN").fn(*[torch.from_numpy(a) for a in ins], **attrs)
    assert isinstance(got, torch.Tensor) and got.shape == (T, B, H)
    _close(got.numpy(), want)


def test_rnn_op_dropout_falls_between_layers():
    """With p > 0 in training, layer 1 sees layer 0's output through a
    keep-mask scaled by 1/keep, drawn from the op's generator; nothing
    after the last layer, and nothing at inference. Layer 1 is made the
    identity (relu of positive inputs, ``W_ih = I``), so the op's output
    is the masked layer-0 output itself."""
    rs = np.random.RandomState(4)
    h, t, b, p = 16, 20, 8, 0.25
    w0 = [rs.uniform(0.1, 0.5, (h, 3)), rs.uniform(0.0, 0.1, (h, h)),
          np.zeros(h), np.zeros(h)]
    w1 = [np.eye(h), np.zeros((h, h)), np.zeros(h), np.zeros(h)]
    x = torch.from_numpy(rs.uniform(0.5, 1.0, (t, b, 3)).astype("float32"))
    flat = [torch.from_numpy(np.asarray(a, "float32").ravel())
            for a in w0[:2] + w1[:2] + w0[2:] + w1[2:]]
    params = torch.cat(flat)
    zeros = torch.zeros(2, b, h)
    one = torch.cat([flat[0], flat[1], flat[4], flat[5]])
    attrs = dict(state_size=h, mode="rnn_relu", p=p)
    layer0 = torch_op("RNN").fn(x, one, zeros[:1], num_layers=1,
                                is_train=True,
                                rng=torch.Generator().manual_seed(0),
                                **attrs)
    assert torch.equal(layer0, torch_op("RNN").fn(
        x, one, zeros[:1], num_layers=1, is_train=False, **attrs))
    out = torch_op("RNN").fn(x, params, zeros, num_layers=2, is_train=True,
                             rng=torch.Generator().manual_seed(5), **attrs)
    again = torch_op("RNN").fn(x, params, zeros, num_layers=2,
                               is_train=True,
                               rng=torch.Generator().manual_seed(5), **attrs)
    assert torch.equal(out, again)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.03
    torch.testing.assert_close(out[kept], (layer0 / (1 - p))[kept],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(
        torch_op("RNN").fn(x, params, zeros, num_layers=2, is_train=False,
                           **attrs), layer0, rtol=1e-6, atol=1e-7)


def test_rnn_op_clips_only_the_final_cell_state_like_jax():
    """``lstm_state_clip_min/max`` clip ``cn`` alone, after the last step
    (``mxnet_tpu/ops/rnn.py:205-207``), where the reference clips the cell
    state at every step: the port follows the JAX package."""
    ins, _ = _op_inputs("lstm", False, seed=6)
    ins[3] = ins[3] * 4
    attrs = dict(_attrs("lstm", False), lstm_state_clip_min=-0.5,
                 lstm_state_clip_max=0.5)
    want = jax_op("RNN").fn(*[jnp.asarray(a) for a in ins], **attrs)
    got = torch_op("RNN").fn(*[torch.from_numpy(a) for a in ins], **attrs)
    free = torch_op("RNN").fn(*[torch.from_numpy(a) for a in ins],
                              **_attrs("lstm", False))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert torch.equal(got[0], free[0]) and torch.equal(got[1], free[1])
    assert float(got[2].abs().max()) <= 0.5 < float(free[2].abs().max())


def test_rnn_op_ignores_projection_and_sequence_length_like_jax():
    """``projection_size`` and ``use_sequence_length`` are accepted and
    ignored by the JAX op (a standing fault, ROADMAP C), and by the
    port's: the output is the op's without them."""
    ins, _ = _op_inputs("lstm", False, seed=5)
    attrs = _attrs("lstm", False)
    odd = dict(attrs, projection_size=3, use_sequence_length=True)
    want = jax_op("RNN").fn(*[jnp.asarray(a) for a in ins], **odd)
    plain = torch_op("RNN").fn(*[torch.from_numpy(a) for a in ins], **attrs)
    got = torch_op("RNN").fn(*[torch.from_numpy(a) for a in ins], **odd)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        _close(g.numpy(), w)


# ----------------------------------------------------------- gluon layers
def _layer(g, kind, **kw):
    cls = {"lstm": g.rnn.LSTM, "gru": g.rnn.GRU}.get(kind)
    if cls is None:
        return g.rnn.RNN(H, L, activation=kind.split("_")[1],
                         prefix=f"{kind}_", **kw)
    return cls(H, L, prefix=f"{kind}_", **kw)


@pytest.mark.parametrize("kind", MODES)
def test_gluon_layer_names_shapes_and_states_match_jax(kind):
    """Per-layer parameter names and shapes (bidirectional, 2 layers, a
    given input size and a deferred one), ``state_info`` and
    ``begin_state``."""
    for kw in ({"input_size": I}, {}):
        jl = _layer(jmx.gluon, kind, bidirectional=True, **kw)
        pl = _layer(mx.gluon, kind, bidirectional=True, **kw)
        jp, pp = jl.collect_params(), pl.collect_params()
        assert list(pp.keys()) == list(jp.keys())
        assert [p.shape for p in pp.values()] == \
            [p.shape for p in jp.values()]
        assert pl.state_info(3) == jl.state_info(3)
    with mx.cpu():
        states = pl.begin_state(3)
    assert [s.shape for s in states] == \
        [tuple(i["shape"]) for i in jl.state_info(3)]


def _layer_inputs(layout, bi, n_states):
    rs = np.random.RandomState(7)
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    d = 2 if bi else 1
    return (rs.randn(*shape).astype("float32"),
            [rs.randn(L * d, B, H).astype("float32")
             for _ in range(n_states)],
            rs.randn(*(shape[:2] + (d * H,))).astype("float32"))


def _run_layer(m, layer, x, s0, ct, zero=True):
    """(outputs and new states, parameter gradients, the output without
    states) of ``sum(out·ct) + sum(states)`` under ``autograd.record()``."""
    xs = m.nd.array(x)
    states = [m.nd.array(s) for s in s0]
    with m.autograd.record():
        out, new = layer(xs, states)
        loss = (out * m.nd.array(ct)).sum() + sum(s.sum() for s in new)
    loss.backward()
    return ([out.asnumpy()] + [s.asnumpy() for s in new],
            {k: p.grad.asnumpy() for k, p in layer.collect_params().items()},
            layer(xs).asnumpy() if zero else None)


def _port_layer(kind, layout, bi, x, weights):
    with mx.cpu():
        pl = _layer(mx.gluon, kind, layout=layout, bidirectional=bi)
        pl.initialize()
        pl(mx.nd.array(x))          # the deferred input size
        interop.load_block_params(pl, weights)
    return pl


def _check(got, want):
    for g, w in zip(got[0], want[0]):
        _close(g, w, what="outputs")
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        _close(got[1][k], want[1][k], what=k)
    if want[2] is not None:
        _close(got[2], want[2], what="zero states")


def test_gluon_layer_forward_and_grads_match_jax():
    """An LSTM layer on the JAX layer's weights (the deferred input size
    taken from the data): the output and states with explicit states,
    their gradients under ``autograd.record()``, and the output alone when
    called without states (zero states), against the JAX layer itself,
    hybridized (in TNC, where its hybridized gradients are right)."""
    x, s0, ct = _layer_inputs("TNC", False, 2)
    jl = _layer(jmx.gluon, "lstm")
    jl.initialize(jmx.init.Uniform(0.4))
    jl.hybridize()
    want = _run_layer(jmx, jl, x, s0, ct)
    pl = _port_layer("lstm", "TNC", False, x, {
        k: p.data().asnumpy() for k, p in jl.collect_params().items()})
    with mx.cpu():
        _check(_run_layer(mx, pl, x, s0, ct), want)


def _op_reference(kind, layout, bi, jl, x, s0, ct):
    """What the JAX layer computes, the ``RNN`` op on its packed vector (the
    layer's ``_pack_params`` order: every weight, then every bias), through
    one ``jax.vjp``: (outputs and states, gradients by parameter name)."""
    names = list(jl.collect_params().keys())
    values = {k: p.data().asnumpy() for k, p in jl.collect_params().items()}
    keys = [k for k in names if k.endswith("weight")] + \
        [k for k in names if k.endswith("bias")]
    packed = np.concatenate([values[k].ravel() for k in keys])
    xt = x if layout == "TNC" else x.transpose(1, 0, 2)
    ctt = ct if layout == "TNC" else ct.transpose(1, 0, 2)
    cts = [ctt] + [np.ones_like(s) for s in s0]
    outs, grads = _jax_rnn_vjp_jit(kind, bi, [jnp.asarray(a) for a in
                                              [xt, packed] + s0],
                                   [jnp.asarray(c) for c in cts])
    outs = [np.asarray(o) for o in outs]
    if layout == "NTC":
        outs[0] = outs[0].transpose(1, 0, 2)
    flat = np.asarray(grads[1])
    sizes = np.cumsum([0] + [values[k].size for k in keys])
    return outs, {k: flat[a:b].reshape(values[k].shape)
                  for k, a, b in zip(keys, sizes, sizes[1:])}


def test_hybridized_jax_layer_in_ntc_has_wrong_gradients():
    """Hybridized, the JAX package's layer in NTC gives the right outputs
    and wrong parameter gradients (a standing fault, ROADMAP C), against
    the op it packs for; the port's layer gives the op's."""
    x, s0, ct = _layer_inputs("NTC", False, 2)
    jl = _layer(jmx.gluon, "lstm", layout="NTC", input_size=I)
    jl.initialize(jmx.init.Uniform(0.4))
    outs, grads = _op_reference("lstm", "NTC", False, jl, x, s0, ct)
    jl.hybridize()
    hybrid = _run_layer(jmx, jl, x, s0, ct, zero=False)
    _close(hybrid[0][0], outs[0], what="hybridized outputs")
    worst = max(float(np.abs(hybrid[1][k] - grads[k]).max() /
                      np.abs(grads[k]).max()) for k in grads)
    assert worst > 0.1
    pl = _port_layer("lstm", "NTC", False, x, {
        k: p.data().asnumpy() for k, p in jl.collect_params().items()})
    with mx.cpu():
        _check(_run_layer(mx, pl, x, s0, ct, zero=False),
               (outs, grads, None))


@pytest.mark.parametrize("kind,layout,bi", [
    ("rnn_relu", "NTC", True), ("lstm", "TNC", True), ("gru", "TNC", False),
    ("rnn_tanh", "NTC", False)])
def test_layer_matches_the_jax_op_on_jax_weights(kind, layout, bi):
    """A layer on the JAX layer's weights against what the JAX layer
    computes (``_op_reference``): outputs, states and every parameter's
    gradient."""
    x, s0, ct = _layer_inputs(layout, bi, 2 if kind == "lstm" else 1)
    jl = _layer(jmx.gluon, kind, layout=layout, bidirectional=bi,
                input_size=I)
    jl.initialize(jmx.init.Uniform(0.4))
    want = _op_reference(kind, layout, bi, jl, x, s0, ct)
    pl = _port_layer(kind, layout, bi, x, {
        k: p.data().asnumpy() for k, p in jl.collect_params().items()})
    with mx.cpu():
        got = _run_layer(mx, pl, x, s0, ct, zero=False)
    _check(got, want + (None,))


@pytest.mark.parametrize("kind", ["gru", "rnn_tanh"])
def test_hybridized_layer_traces_where_jax_does_not(kind):
    """Hybridized, the JAX package's GRU and RNN layers fail to trace (their
    graph asks for a ``state_cell`` they do not have: a standing fault,
    ROADMAP C); the port's trace its packed ``RNN`` node and run it like
    the unhybridized layer."""
    x, s0, ct = _layer_inputs("TNC", False, 1)
    jl = _layer(jmx.gluon, kind)
    jl.initialize(jmx.init.Uniform(0.4))
    jl.hybridize()
    with pytest.raises(KeyError, match="state_cell"):
        jl(jmx.nd.array(x), [jmx.nd.array(s) for s in s0])
    with mx.cpu():
        pl = _layer(mx.gluon, kind)
        pl.initialize(mx.init.Uniform(0.4))
        plain = _run_layer(mx, pl, x, s0, ct, zero=False)
        pl.hybridize()
        hybrid = _run_layer(mx, pl, x, s0, ct, zero=False)
        nodes = [n.op for n in pl._graph.topo_nodes() if not n.is_var]
    assert nodes.count("RNN") == 1 and "Concat" in nodes
    for a, b in zip(plain[0], hybrid[0]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ gluon cells
def _gluon_cells(g, which):
    r = g.rnn
    if which == "sequential":
        cell = r.SequentialRNNCell(prefix="seq_")
        with cell.name_scope():
            cell.add(r.LSTMCell(H, input_size=I, prefix="a_"))
            cell.add(r.DropoutCell(0.0))
            cell.add(r.ResidualCell(r.GRUCell(H, input_size=H, prefix="b_")))
            cell.add(r.ZoneoutCell(r.RNNCell(H, input_size=H, prefix="c_"),
                                   zoneout_outputs=0.0, zoneout_states=0.0))
        return cell
    if which == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.GRUCell(H, prefix="r_"), prefix="bi_")
    cls = {"rnn": r.RNNCell, "lstm": r.LSTMCell, "gru": r.GRUCell}[which]
    return cls(H, prefix=f"{which}_")


@pytest.mark.parametrize("which,merge,valid", [
    ("rnn", False, False), ("lstm", True, False), ("gru", True, True),
    ("sequential", True, False), ("bidirectional", True, False)])
def test_gluon_cell_unroll_matches_jax(which, merge, valid):
    """``unroll`` (NTC) of each gluon cell on the same weights: the
    outputs, merged or a list, masked by ``valid_length`` through
    ``SequenceMask``, and the final states; a stack with dropout and
    zoneout at 0 (their masks are torch's, not JAX's)."""
    rs = np.random.RandomState(8)
    x = rs.randn(B, T, I).astype("float32")
    lens = np.array([2, 5, 3], "float32")

    def run(m, cell, init):
        cell.initialize(init)
        with m.autograd.train_mode():
            out, states = cell.unroll(
                T, m.nd.array(x), layout="NTC", merge_outputs=merge,
                valid_length=m.nd.array(lens) if valid else None)
        outs = [out] if merge or valid else out
        return [o.asnumpy() for o in outs], [s.asnumpy() for s in states]

    want = run(jmx, _gluon_cells(jmx.gluon, which), _JaxSeeded())
    with mx.cpu():
        cell = _gluon_cells(mx.gluon, which)
        got = run(mx, cell, _PortSeeded())
    assert sorted(cell.collect_params().keys()) == sorted(
        _gluon_cells(jmx.gluon, which).collect_params().keys())
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w)


# ---------------------------------------------------------- symbolic cells
def _sym_stack(m, which):
    r = m.rnn
    if which == "stepped":
        stack = r.SequentialRNNCell()
        stack.add(r.LSTMCell(H, prefix="l0_"))
        stack.add(r.ResidualCell(r.GRUCell(H, prefix="l1_")))
        stack.add(r.DropoutCell(0.0, prefix="d_"))
        stack.add(r.ZoneoutCell(r.RNNCell(H, prefix="l2_"),
                                zoneout_outputs=0.0, zoneout_states=0.0))
        return stack
    if which == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="fl_"),
                                   r.LSTMCell(H, prefix="fr_"))
    mode, bi = {"fused_lstm": ("lstm", False),
                "fused_gru_bi": ("gru", True)}[which]
    return r.FusedRNNCell(H, num_layers=2, mode=mode, bidirectional=bi,
                          get_next_state=True, prefix=f"{which}_")


def _sym_run(m, which, values, x, ctx):
    cell = _sym_stack(m, which)
    data = m.sym.Variable("data")
    out, states = cell.unroll(T, data, layout="NTC", merge_outputs=True)
    graph = m.sym.Group([out] + list(states))
    names = graph.list_arguments()
    args = {n: m.nd.array(x if n == "data" else values(n, graph, x), ctx=ctx)
            for n in names}
    outs = graph.bind(ctx, args).forward()
    return names, [o.asnumpy() for o in outs]


@pytest.mark.parametrize("which", ["stepped", "bidirectional", "fused_lstm",
                                   "fused_gru_bi"])
def test_symbolic_cell_unroll_matches_jax(which):
    """``mx.rnn`` cells unrolled to a graph and bound (the JAX executor
    against the port's): the argument names, the merged outputs and the
    final states; the begin states are zeros of batch 1, broadcast."""
    x = np.random.RandomState(9).randn(B, T, I).astype("float32")
    shapes = {}

    def values(name, graph, xv):
        if not shapes:
            arg_shapes = graph.infer_shape(data=xv.shape)[0]
            shapes.update(zip(graph.list_arguments(), arg_shapes))
        return _seeded(name, shapes[name])

    want_names, want = _sym_run(jmx, which, values, x, jmx.cpu())
    got_names, got = _sym_run(mx, which, values, x, mx.cpu())
    assert got_names == want_names
    for g, w in zip(got, want):
        _close(g, w)


def test_fused_cell_packing_round_trip_and_unfused_stack():
    """``FusedRNNCell.unpack_weights`` gives the JAX cell's per-gate
    arrays; ``pack_weights`` inverts it bitwise; the fused graph on the
    packed vector equals ``unfuse()``'s stack on the unpacked weights."""
    n = rnn_packed_param_size("lstm", 2, True, I, H)
    packed = _seeded("packed", (n,))
    jcell = jmx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True,
                                 prefix="f_")
    want = jcell.unpack_weights({"f_parameters": jmx.nd.array(packed)})
    with mx.cpu():
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True,
                                   prefix="f_")
        got = cell.unpack_weights({"f_parameters": mx.nd.array(packed)})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].asnumpy(),
                                          want[k].asnumpy())
        back = cell.pack_weights(got)["f_parameters"].asnumpy()
        np.testing.assert_array_equal(back, packed)
        carried, _ = interop.module_params_from_numpy(
            {"arg:f_parameters": packed}, mx.cpu())
        np.testing.assert_array_equal(carried["f_parameters"].asnumpy(),
                                      packed)

        x = np.random.RandomState(10).randn(B, T, I).astype("float32")
        outs = []
        stack = cell.unfuse()
        for c, vals in ((cell, {"f_parameters": packed}),
                        (stack, {k: v.asnumpy() for k, v in
                                 stack.pack_weights(got).items()})):
            sym, _ = c.unroll(T, mx.sym.Variable("data"), layout="NTC",
                              merge_outputs=True)
            args = {k: mx.nd.array(v) for k, v in vals.items()}
            args["data"] = mx.nd.array(x)
            args = {k: args[k] for k in sym.list_arguments()}
            outs.append(sym.bind(mx.cpu(), args).forward()[0].asnumpy())
    _close(outs[1], outs[0])


def _sentences():
    rs = np.random.RandomState(11)
    words = [f"w{i}" for i in range(20)]
    return [[words[j] for j in rs.randint(0, 20, rs.randint(2, 12))]
            for _ in range(60)]


def test_bucket_sentence_iter_batches_match_jax():
    """``encode_sentences``' codes and vocabulary, and every batch of
    ``BucketSentenceIter`` (data, label, bucket key, shapes) for the same
    seeds of Python's and numpy's streams, in both layouts."""
    sents = _sentences()
    jenc, jvocab = jmx.rnn.encode_sentences(sents, invalid_label=0,
                                            start_label=1)
    enc, vocab = mx.rnn.encode_sentences(sents, invalid_label=0,
                                         start_label=1)
    assert enc == jenc and vocab == jvocab

    def batches(m, layout):
        random.seed(12)
        np.random.seed(12)
        it = m.rnn.BucketSentenceIter(enc, 4, buckets=[4, 8, 12],
                                      invalid_label=0, layout=layout)
        out = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                b.provide_data[0].shape) for b in it]
        assert it.provide_data[0].shape == (
            (4, 12) if layout == "NT" else (12, 4))
        return out

    for layout in ("NT", "TN"):
        want, got = batches(jmx, layout), batches(mx, layout)
        assert len(got) == len(want) > 5
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[3] == w[3]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])


def test_rnn_checkpoints_round_trip_and_load_in_jax(tmp_path, monkeypatch):
    """``save_rnn_checkpoint`` writes the per-gate weights; the port's
    ``load_rnn_checkpoint`` packs them back bitwise, and the JAX
    package's reads the same file into the same packed vector."""
    n = rnn_packed_param_size("gru", 1, False, I, H)
    packed = _seeded("ckpt", (n,))
    with mx.cpu():
        cell = mx.rnn.FusedRNNCell(H, mode="gru", prefix="g_")
        sym, _ = cell.unroll(T, mx.sym.Variable("data"), layout="NTC",
                             merge_outputs=True)
        prefix = str(tmp_path / "rnn")
        mx.rnn.save_rnn_checkpoint(cell, prefix, 3, sym,
                                   {"g_parameters": mx.nd.array(packed)}, {})
        loaded_sym, arg, aux = mx.rnn.load_rnn_checkpoint(cell, prefix, 3)
    assert loaded_sym.list_arguments() == sym.list_arguments() and not aux
    np.testing.assert_array_equal(arg["g_parameters"].asnumpy(), packed)
    saved = mx.nd.load(f"{prefix}-0003.params", ctx=mx.cpu())
    assert "arg:g_l0_i2h_r_weight" in saved and "arg:g_parameters" \
        not in saved
    jcell = jmx.rnn.FusedRNNCell(H, mode="gru", prefix="g_")
    _, jarg, _ = jmx.rnn.load_rnn_checkpoint(jcell, prefix, 3)
    np.testing.assert_array_equal(jarg["g_parameters"].asnumpy(), packed)
    calls = []
    monkeypatch.setattr(mx.rnn.rnn, "save_rnn_checkpoint",
                        lambda *a: calls.append(a[2]))
    cb = mx.rnn.do_rnn_checkpoint(cell, prefix, period=2)
    for epoch in range(4):
        cb(epoch, sym, {}, {})
    assert calls == [2, 4]


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("name,shape,make", [
    ("lstm_i2h_bias", (16,), lambda m: m.init.LSTMBias(forget_bias=2.5)),
    ("up_weight", (2, 3, 4, 4), lambda m: m.init.Bilinear()),
    ("up_odd_weight", (1, 2, 3, 5), lambda m: m.init.Bilinear())])
def test_deterministic_initializers_match_jax(name, shape, make):
    want = np.zeros(shape, "float32")
    make(jmx)(name, want)
    got = torch.zeros(shape)
    make(mx)(name, got)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_initializers_by_their_properties():
    """``Orthogonal``'s rows are orthonormal times ``scale`` (its columns
    where there are fewer); ``MSRAPrelu`` draws a normal of variance
    2/((1 + slope²)·fan_avg); ``Mixed`` takes the first pattern that
    matches and raises when none does."""
    mx.random.seed(13)
    for shape in ((8, 20), (20, 8), (6, 2, 3, 3)):
        w = torch.empty(shape)
        mx.init.Orthogonal(scale=1.5)("w_weight", w)
        q = w.reshape(shape[0], -1)
        gram = q @ q.t() if q.shape[0] <= q.shape[1] else q.t() @ q
        torch.testing.assert_close(gram, 2.25 * torch.eye(gram.shape[0]),
                                   rtol=0, atol=1e-4)
    w = torch.empty(400, 300)
    mx.init.MSRAPrelu(slope=0.5)("p_weight", w)
    want = 2.0 / (1 + 0.25) / 350.0
    assert abs(w.var().item() / want - 1) < 0.05 and abs(w.mean()) < 1e-3
    mixed = mx.init.Mixed([".*mult$", ".*"], [mx.init.Constant(3.0),
                                             mx.init.One()])
    b, v = torch.empty(4), torch.empty(2, 2)
    mixed("fc_mult", b)
    mixed("fc_weight", v)
    assert (b == 3).all() and (v == 1).all()
    with pytest.raises(mx.MXNetError, match="no initializer"):
        mx.init.Mixed(["^x"], [mx.init.One()])("y", b)


# ------------------------------------------------------------ gluon.utils
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    """The norm it returns and the arrays it scales in place (a tighter
    bound than their norm scales them all, a looser one leaves them)."""
    rs = np.random.RandomState(14)
    values = [rs.randn(3, 4).astype("float32"),
              rs.randn(5).astype("float32")]
    jarrs = [jmx.nd.array(v) for v in values]
    jnorm = jmx.gluon.utils.clip_global_norm(jarrs, max_norm)
    with mx.cpu():
        arrs = [mx.nd.array(v) for v in values]
        aliases = list(arrs)
        norm = mx.gluon.utils.clip_global_norm(arrs, max_norm)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
    for a, alias, j, v in zip(arrs, aliases, jarrs, values):
        assert a is alias
        np.testing.assert_allclose(a.asnumpy(), j.asnumpy(), rtol=1e-6)
        assert np.array_equal(a.asnumpy(), v) == (max_norm > 10)


def test_split_and_load_and_files_like_jax(tmp_path):
    x = np.arange(20, dtype="float32").reshape(10, 2)
    want = [s.asnumpy() for s in jmx.gluon.utils.split_data(
        jmx.nd.array(x), 3, even_split=False)]
    with mx.cpu():
        got = [s.asnumpy() for s in mx.gluon.utils.split_data(
            mx.nd.array(x), 3, even_split=False)]
        with pytest.raises(mx.MXNetError, match="divisible"):
            mx.gluon.utils.split_data(mx.nd.array(x), 3)
        loaded = mx.gluon.utils.split_and_load(x, [mx.cpu()])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(loaded[0].asnumpy(), x)
    f = tmp_path / "blob"
    f.write_bytes(b"recurrent" * 1000)
    import hashlib
    digest = hashlib.sha1(f.read_bytes()).hexdigest()
    assert mx.gluon.utils.check_sha1(str(f), digest)
    assert not mx.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(mx.MXNetError, match="network"):
        mx.gluon.utils.download("http://localhost/x")

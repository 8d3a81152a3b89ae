"""PyTorch port, op library: each of the 12 ops of the served LM graph
against its JAX registry op, on the same numpy inputs at tiny shapes
(every Reshape code, an out-of-range Embedding id). Tolerance 1e-5 in
float32: the same arithmetic, in another summation order where there is a
reduction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import get_op as torch_op
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# (case id, op name, numpy inputs, attrs)
CASES = [
    ("embedding_clip", "Embedding",
     [np.array([[0, 3, 7, -3, 70], [2.7, 5, 1, 6, 4]], "float32"),
      _r(8, 6)], {"input_dim": 8, "output_dim": 6}),
    ("expand_dims_0", "expand_dims", [_r(4, 5)], {"axis": 0}),
    ("expand_dims_neg", "expand_dims", [_r(4, 5)], {"axis": -1}),
    ("slice_like_axis1", "slice_like", [_r(1, 9, 4), _r(2, 5, 4)],
     {"axes": (1,)}),
    ("slice_like_all", "slice_like", [_r(6, 9), _r(3, 5)], {}),
    ("broadcast_add", "broadcast_add", [_r(2, 3, 4), _r(1, 3, 4, seed=1)],
     {}),
    ("layernorm_last", "LayerNorm", [_r(2, 3, 8) * 3 + 1, _r(8, seed=1),
                                     _r(8, seed=2)], {"axis": -1,
                                                      "eps": 1e-5}),
    ("layernorm_axis1", "LayerNorm", [_r(2, 5, 3), _r(5, seed=1),
                                      _r(5, seed=2)], {"axis": 1,
                                                       "eps": 1e-3}),
    ("fc_flatten_false", "FullyConnected", [_r(2, 3, 4), _r(5, 4, seed=1),
                                            _r(5, seed=2)],
     {"num_hidden": 5, "flatten": False}),
    ("fc_flatten_true", "FullyConnected", [_r(2, 3, 4), _r(5, 12, seed=1),
                                           _r(5, seed=2)],
     {"num_hidden": 5}),
    ("fc_no_bias", "FullyConnected", [_r(2, 3, 4), _r(5, 4, seed=1)],
     {"num_hidden": 5, "no_bias": True, "flatten": False}),
    ("reshape_0_0_split", "Reshape", [_r(2, 3, 12)],
     {"shape": (0, 0, 6, 2)}),
    ("reshape_infer", "reshape", [_r(2, 3, 6, 2)], {"shape": (0, 0, -1)}),
    ("reshape_copy_rest", "reshape", [_r(2, 3, 4, 5)], {"shape": (-3, -2)}),
    ("reshape_merge", "reshape", [_r(2, 3, 4, 5)], {"shape": (-3, -3)}),
    ("reshape_split", "reshape", [_r(6, 4)], {"shape": (-4, 2, -1, 4)}),
    ("reshape_reverse", "reshape", [_r(2, 3, 4)],
     {"shape": (-1, 0), "reverse": True}),
    ("transpose_axes", "transpose", [_r(2, 3, 4, 5)], {"axes": (0, 2, 1, 3)}),
    ("transpose_default", "transpose", [_r(2, 3, 4)], {}),
    ("slice_axis", "slice_axis", [_r(2, 6, 4)],
     {"axis": 1, "begin": 2, "end": 4}),
    ("slice_axis_open", "slice_axis", [_r(2, 6, 4)],
     {"axis": -1, "begin": -3, "end": None}),
    ("flash_causal", "contrib_flash_attention",
     [_r(1, 2, 8, 16), _r(1, 2, 8, 16, seed=1), _r(1, 2, 8, 16, seed=2)],
     {"causal": True}),
    ("flash_scale_offsets", "_contrib_flash_attention",
     [_r(1, 2, 8, 16), _r(1, 2, 12, 16, seed=1), _r(1, 2, 12, 16, seed=2)],
     {"causal": True, "scale": 0.3, "q_offset": 4, "k_offset": 2}),
    ("relu", "Activation", [_r(3, 4)], {"act_type": "relu"}),
    ("sigmoid", "Activation", [_r(3, 4)], {"act_type": "sigmoid"}),
    ("tanh", "Activation", [_r(3, 4)], {"act_type": "tanh"}),
    ("softrelu", "Activation", [_r(3, 4)], {"act_type": "softrelu"}),
    ("softsign", "Activation", [_r(3, 4)], {"act_type": "softsign"}),
    ("dropout_inference", "Dropout", [_r(3, 4)],
     {"p": 0.5, "is_train": False}),
    ("dropout_p0_train", "Dropout", [_r(3, 4)],
     {"p": 0.0, "axes": (), "is_train": True}),
    # the recurrent slice's ops
    ("swapaxes", "SwapAxis", [_r(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    ("squeeze_all", "squeeze", [_r(1, 3, 1)], {}),
    ("squeeze_axis", "squeeze", [_r(1, 3, 1)], {"axis": 2}),
    ("stack_axis1", "stack", [_r(2, 3), _r(2, 3, seed=1)], {"axis": 1}),
    ("slicechannel", "SliceChannel", [_r(2, 6, 3)],
     {"num_outputs": 3, "axis": 1}),
    ("split_squeeze", "split", [_r(4, 2, 3)],
     {"num_outputs": 4, "axis": 0, "squeeze_axis": True}),
    ("split_v2_indices", "split_v2", [_r(7, 2)],
     {"indices": (2, 5), "axis": 0}),
    ("flip", "flip", [_r(3, 4, 2)], {"axis": (0, 2)}),
    ("reverse", "reverse", [_r(3, 4)], {"axis": 1}),
    ("where", "where", [np.array([[1, 0, 2], [0, 0, -1]], "float32"),
                        _r(2, 3), _r(2, 3, seed=1)], {}),
    ("sequence_mask_t", "SequenceMask",
     [_r(4, 3, 2), np.array([1, 4, 2.7], "float32")],
     {"use_sequence_length": True, "value": -1.0}),
    ("sequence_mask_n", "SequenceMask",
     [_r(3, 4, 2), np.array([1, 4, 2], "float32")],
     {"use_sequence_length": True, "axis": 1}),
    ("sequence_mask_off", "SequenceMask",
     [_r(4, 3), np.array([1, 2, 3], "float32")], {}),
    ("sequence_last", "SequenceLast",
     [_r(4, 3, 2), np.array([1, 4, 2], "float32")],
     {"use_sequence_length": True}),
    ("sequence_last_n", "SequenceLast",
     [_r(3, 4, 2), np.array([1, 4, 2], "float32")],
     {"use_sequence_length": True, "axis": 1}),
    ("sequence_last_off", "SequenceLast", [_r(4, 3, 2)], {}),
    ("sequence_reverse", "SequenceReverse",
     [_r(4, 3, 2), np.array([1, 4, 2], "float32")],
     {"use_sequence_length": True}),
    ("sequence_reverse_off", "SequenceReverse", [_r(4, 3, 2)], {}),
    ("zeros_like", "zeros_like", [_r(2, 3)], {}),
    ("ones_like", "ones_like", [_r(2, 3)], {}),
    ("tanh_op", "tanh", [_r(3, 4)], {}),
    ("broadcast_to", "broadcast_to", [_r(1, 3, 1)], {"shape": (2, 0, 4)}),
    ("broadcast_mod", "broadcast_mod", [_r(2, 3) * 3, _r(1, 3, seed=1)],
     {}),
    ("mod_scalar", "_mod_scalar", [_r(2, 3) * 3], {"scalar": 1.5}),
    ("rmod_scalar", "_rmod_scalar", [_r(2, 3)], {"scalar": 2.0}),
    ("broadcast_greater", "broadcast_greater", [_r(2, 3), _r(1, 3, seed=1)],
     {}),
    ("equal_scalar", "_equal_scalar",
     [np.array([1, 2, 3], "float32")], {"scalar": 2.0}),
]


@pytest.mark.parametrize("name,inputs,attrs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(name, inputs, attrs):
    # the JAX op as one jitted program: one compile, where its primitives
    # would each compile eagerly
    want = jax.jit(lambda *a: jax_op(name).fn(*a, **attrs))(
        *[jnp.asarray(a) for a in inputs])
    got = torch_op(name).fn(*[torch.from_numpy(a) for a in inputs], **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_nd_namespace_and_dropout_generator():
    """``mx.nd.<op>`` is generated from the registry; Dropout in training
    mode draws its mask from an explicit generator (torch's bits are not
    JAX's, so only the contract is checked: kept ~ 1 - p, scaled 1/keep,
    reproducible from the seed)."""
    with mxt.cpu():
        x = mxt.nd.array(np.ones((200, 50), "float32"))
        y = mxt.nd.Reshape(x, shape=(0, -4, 5, -1))
        assert y.shape == (200, 5, 10) and y.context == mxt.cpu()
    from mxnet_tpu_torch._imperative import invoke_raw
    t = torch.ones(200, 50)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = invoke_raw("Dropout", [t], {"p": 0.25, "rng": g1}, is_train=True)
    b = invoke_raw("Dropout", [t], {"p": 0.25, "rng": g2}, is_train=True)
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03
    assert torch.allclose(a[a != 0], torch.full((), 1 / 0.75))
    assert torch.equal(invoke_raw("Dropout", [t], {"p": 0.25}), t)


def test_shape_inference_on_meta():
    s = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=7,
                               flatten=False, name="fc")
    s = mxt.sym.LayerNorm(s, name="ln")
    args, outs, aux = s.infer_shape(data=(2, 3, 4))
    assert dict(zip(s.list_arguments(), args)) == {
        "data": (2, 3, 4), "fc_weight": (7, 4), "fc_bias": (7,),
        "ln_gamma": (7,), "ln_beta": (7,)}
    assert outs == [(2, 3, 7), (2, 3), (2, 3)] and aux == []


@pytest.mark.parametrize("data_shape,index,axis,keepdims", [
    ((2, 3), [[1]], 1, False),
    ((2, 3), [0, 2], 1, False),
    ((2, 3, 4), [[0], [3]], 2, True),
    ((2, 3), [[0, 2], [1, 1]], 1, True),
], ids=["broadcast-row", "per-row", "3d-broadcast", "several-keepdims"])
def test_pick_broadcasts_the_index_like_jax(data_shape, index, axis,
                                            keepdims):
    """The index broadcasts to the data on every axis but ``axis``, as
    ``take_along_axis`` broadcasts it; indices clip."""
    data = _r(*data_shape)
    idx = np.asarray(index, "float32")
    want = jax_op("pick").fn(jnp.asarray(data), jnp.asarray(idx), axis=axis,
                             keepdims=keepdims)
    got = torch_op("pick").fn(torch.from_numpy(data), torch.from_numpy(idx),
                              axis=axis, keepdims=keepdims)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("data_shape,index,axis,keepdims", [
    ((2, 3), [0, 2], 0, False),
    ((2, 3), [[0, 2], [1, 1]], 1, False),
    ((2, 3), [0, 1, 2], 1, False),
], ids=["wrong-axis", "several-squeezed", "too-many-rows"])
def test_pick_raises_where_jax_raises(data_shape, index, axis, keepdims):
    data = _r(*data_shape)
    idx = np.asarray(index, "float32")
    with pytest.raises(Exception):
        jax_op("pick").fn(jnp.asarray(data), jnp.asarray(idx), axis=axis,
                          keepdims=keepdims)
    with pytest.raises(mxt.MXNetError, match="pick"):
        torch_op("pick").fn(torch.from_numpy(data), torch.from_numpy(idx),
                            axis=axis, keepdims=keepdims)


def test_embedding_backward_sums_repeated_ids_in_a_fixed_order():
    """``Embedding``'s gradient goes through ``embedding_dense_backward``
    (on the card: sorted ids, a fixed order of the sums over repeated
    ids), not the ``index_add_`` of ``index_select``'s backward, whose
    CUDA atomics sum the rows of repeated ids in a changing order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    ids = torch.tensor([[1.0, 1.0, 3.0, 9.5]])
    w = torch.randn(8, 4, requires_grad=True)
    with Ops() as ops:
        out = torch_op("Embedding").fn(ids, w, input_dim=8, output_dim=4)
        out.sum().backward()
    assert "embedding_dense_backward" in ops.seen
    assert not {"index_add", "index_add_", "index_select_backward"} & ops.seen
    want = np.zeros((8, 4), "float32")
    for i in (1, 1, 3, 7):
        want[i] += 1.0
    np.testing.assert_array_equal(w.grad.numpy(), want)


def test_fully_connected_promotes_like_jnp_dot():
    """bf16 data on float32 weights (the LM's products after its float32
    table, under the trainer's bf16 cast) run in float32, as ``jnp.dot``
    promotes them; bf16 on bf16 stays bf16."""
    x, w, b = _r(2, 3, 4), _r(5, 4, seed=1), _r(5, seed=2)
    attrs = {"num_hidden": 5, "flatten": False}
    want = jax_op("FullyConnected").fn(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w), jnp.asarray(b), **attrs)
    got = torch_op("FullyConnected").fn(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(w),
                                        torch.from_numpy(b), **attrs)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    both = torch_op("FullyConnected").fn(
        *(torch.from_numpy(a).bfloat16() for a in (x, w, b)), **attrs)
    assert both.dtype == torch.bfloat16
    # a float32 bias (a frozen parameter under the bf16 cast): the bf16
    # product, then the float32 sum
    want = jax_op("FullyConnected").fn(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16),
                                       jnp.asarray(b), **attrs)
    got = torch_op("FullyConnected").fn(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(w).bfloat16(),
                                        torch.from_numpy(b), **attrs)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# The NDArray sugar and the op that the JAX package has and the port
# lacked: each case runs on both packages' NDArrays; 1e-6 relative.
def _set(a, key, value):
    c = a.copy()
    c[key] = value
    return c


SUGAR = {
    "pow_scalar": lambda a, b: a ** 2.5,
    "pow_int_scalar": lambda a, b: a ** 3,
    "rpow_scalar": lambda a, b: 1.7 ** a,
    "pow_array": lambda a, b: a ** b,
    "abs": lambda a, b: abs(a - 0.5),
    "softmax": lambda a, b: a.softmax(axis=1),
    "softmax_temperature": lambda a, b: a.softmax(axis=0, temperature=2.0),
    # indexing, comparisons, % and the methods the recurrent slice uses
    "getitem_row": lambda a, b: a[1],
    "getitem_slice": lambda a, b: a[1:3],
    "getitem_tuple": lambda a, b: a[1:, 2],
    "getitem_float_index": lambda a, b: a[b * 0 + 1.9],
    "setitem_row": lambda a, b: _set(a, 1, 7.0),
    "setitem_slice_broadcast": lambda a, b: _set(a, slice(None), b),
    "setitem_range_array": lambda a, b: _set(a, slice(0, 1), b),
    "slice_assign": lambda a, b: a.copy().slice_assign(b * 2, (1, 0),
                                                        (2, 5)),
    "transpose_T": lambda a, b: a.T,
    "greater": lambda a, b: a > b,
    "greater_equal_scalar": lambda a, b: a >= 1.0,
    "lesser": lambda a, b: a < b,
    "lesser_equal_scalar": lambda a, b: a <= 1.0,
    "equal": lambda a, b: a == a,
    "not_equal": lambda a, b: a != b,
    "mod_scalar": lambda a, b: a % 0.7,
    "mod_array": lambda a, b: a % b,
    "rmod_scalar": lambda a, b: 2.0 % a,
    "expand_squeeze": lambda a, b: a.expand_dims(1).squeeze(axis=1),
    "transpose_axes": lambda a, b: a.expand_dims(0).transpose((2, 0, 1)),
    "flatten": lambda a, b: a.expand_dims(2).flatten(),
    "broadcast_to_method": lambda a, b: b.broadcast_to((3, 5)),
    "numpy_operand": lambda a, b: a + np.arange(5, dtype="float32"),
}


@pytest.mark.parametrize("name", sorted(SUGAR))
def test_power_abs_and_softmax_match_jax(name):
    import mxnet_tpu as jmx
    rng = np.random.RandomState(4)
    a = rng.uniform(0.2, 2.0, (3, 5)).astype("float32")
    b = rng.uniform(-1.5, 1.5, (1, 5)).astype("float32")
    want = SUGAR[name](jmx.nd.array(a), jmx.nd.array(b)).asnumpy()
    with mxt.cpu():
        got = SUGAR[name](mxt.nd.array(a), mxt.nd.array(b)).asnumpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_softmax_with_lengths_matches_jax():
    """The ``softmax`` op with ``length`` and ``use_length``: the first
    ``length[i]`` entries of row ``i`` take part, the rest are 0."""
    x = _r(3, 6)
    lens = np.array([2, 6, 1], "int32")
    want = np.asarray(jax_op("softmax").fn(
        jnp.asarray(x), length=jnp.asarray(lens), use_length=True, axis=-1))
    got = torch_op("softmax").fn(torch.from_numpy(x),
                                 length=torch.from_numpy(lens),
                                 use_length=True, axis=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[0, 2:] == 0).all() and (got[2, 1:] == 0).all()


def test_inplace_arithmetic_writes_through_like_jax():
    """``b = a; b op= s`` leaves ``a`` holding the result, and
    ``p.grad[...] op= s`` writes into a ``Parameter``'s gradient buffer,
    as in the JAX package (whose ``_inplace`` rebinds the array): a
    gradient clipped this way (``gluon.utils.clip_global_norm``) is the
    one the trainer reads. Each of ``+=``, ``-=``, ``*=``, ``/=`` with a
    scalar and with an NDArray (one item; it names the failing case)."""
    failed = []
    for op in ("+=", "-=", "*=", "/="):
        for rhs in ("scalar", "ndarray"):
            try:
                _inplace_case(op, rhs)
            except AssertionError as e:
                failed.append(f"{op} {rhs}: {e}")
    assert not failed, failed


def _inplace_case(op, rhs):
    import mxnet_tpu as jmx
    rng = np.random.RandomState(5)
    a0 = rng.uniform(0.5, 2.0, (2, 3)).astype("float32")
    s0 = 0.75 if rhs == "scalar" else \
        rng.uniform(0.5, 2.0, (1, 3)).astype("float32")
    x = rng.randn(4, 3).astype("float32")
    w = rng.randn(2, 3).astype("float32")

    def run(m):
        s = s0 if rhs == "scalar" else m.nd.array(s0)
        ns = {"b": m.nd.array(a0), "s": s}
        a = ns["b"]
        exec(f"b {op} s", {}, ns)
        dense = m.gluon.nn.Dense(2, in_units=3, use_bias=False,
                                 prefix="inplace_")
        dense.initialize()
        dense.weight.set_data(m.nd.array(w))
        with m.autograd.record():
            loss = dense(m.nd.array(x)).sum()
        loss.backward()
        grad = dense.weight.grad
        before = grad.asnumpy()
        exec(f"g[...] {op} s", {}, {"g": grad, "s": s})
        return a.asnumpy(), before, dense.weight.grad.asnumpy()

    want = run(jmx)
    with mxt.cpu():
        got = run(mxt)
    assert not np.array_equal(want[0], a0)
    assert not np.array_equal(want[2], want[1])
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, rtol=1e-6, atol=0)


def test_ndarray_host_methods_and_bool():
    """``tolist``, ``item``, ``copyto``, ``wait_to_read`` and the truth
    value of a one-element array; a larger one has none, as in the JAX
    package."""
    with mxt.cpu():
        a = mxt.nd.array(np.arange(6, dtype="float32").reshape(2, 3))
        assert a.tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
        assert a[1, 2].item() == 5.0 and bool(a[0, 1]) and not a[0, 0]
        a.wait_to_read()
        b = mxt.nd.zeros((2, 3))
        assert a.copyto(b) is b
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        c = a.copyto(mxt.cpu())
        c[0, 0] = 9.0
        assert a[0, 0].item() == 0.0
        with pytest.raises(mxt.MXNetError, match="ambiguous"):
            bool(a)


def test_nd_split_stack_and_keyword_inputs_like_jax():
    """``nd.split``/``nd.stack``/``nd.concat`` (list or varargs) and an
    op input passed by keyword (``SequenceMask(x, sequence_length=l)``),
    as the JAX package's ``mx.nd`` takes them."""
    import mxnet_tpu as jmx
    x = _r(4, 3, 2)
    lens = np.array([1, 4, 2], "float32")

    def run(m):
        d = m.nd.array(x)
        parts = m.nd.split(d, 2, axis=0)
        out = [m.nd.stack(parts, axis=1), m.nd.concat(*parts, dim=2),
               m.nd.split(d, [1, 3], axis=0)[1],
               m.nd.SequenceMask(d, sequence_length=m.nd.array(lens),
                                 use_sequence_length=True)]
        return [o.asnumpy() for o in out]

    want = run(jmx)
    with mxt.cpu():
        got = run(mxt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_zeros_op_on_the_current_context_and_in_graphs():
    """``_zeros``/``_ones`` have no input: imperatively they land on the
    current context, in a graph beside its inputs (the symbolic cells'
    ``begin_state``)."""
    with mxt.cpu():
        z = mxt.nd._zeros(shape=(2, 3))
        assert z.context == mxt.cpu() and z.asnumpy().sum() == 0
    s = mxt.sym.Variable("x") + mxt.sym.ones((1, 3))
    assert s.infer_shape(x=(2, 3))[1] == [(2, 3)]
    ex = s.bind(mxt.cpu(), {"x": mxt.nd.array(np.ones((2, 3)),
                                               ctx=mxt.cpu())})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  np.full((2, 3), 2.0))


def test_indexing_under_record_carries_the_gradient_where_jax_drops_it():
    """``x[1:]`` under ``autograd.record()`` is recorded in the port, as in
    the reference; the JAX package's ``__getitem__`` leaves its result off
    the tape, so the gradient through it is silently zero there (a
    standing JAX-side fault the port does not copy, ROADMAP C)."""
    import mxnet_tpu as jmx

    def grad(m):
        x = m.nd.array(np.arange(4, dtype="float32"))
        x.attach_grad()
        with m.autograd.record():
            y = (x[1:] * 2).sum()
        y.backward()
        return x.grad.asnumpy()

    np.testing.assert_array_equal(grad(jmx), np.zeros(4, "float32"))
    with mxt.cpu():
        np.testing.assert_array_equal(grad(mxt),
                                      np.array([0, 2, 2, 2], "float32"))

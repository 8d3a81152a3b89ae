"""PyTorch port, op library: each of the 12 ops of the served LM graph
against its JAX registry op, on the same numpy inputs at tiny shapes
(every Reshape code, an out-of-range Embedding id). Tolerance 1e-5 in
float32: the same arithmetic, in another summation order where there is a
reduction."""
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
]


@pytest.mark.parametrize("name,inputs,attrs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(name, inputs, attrs):
    want = jax_op(name).fn(*[jnp.asarray(a) for a in inputs], **attrs)
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

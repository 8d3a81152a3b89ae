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

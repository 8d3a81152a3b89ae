"""PyTorch port, convolution family: the ``Convolution``, ``Deconvolution``
and ``Pooling`` ops, the array ops the vision zoo calls (``Flatten``,
``Concat``, ``Pad``, ``space_to_depth``, ``depth_to_space``, ``clip``)
and every layer of ``gluon.nn.conv_layers`` with ``Flatten``, ``Lambda``
and ``HybridLambda``, against the JAX package on the same numpy inputs.

Ops: the output and the gradient of every input under the cotangent
``cos(0, 1, 2, ...)`` (``jax.vjp`` against torch autograd). The grids
cover 1-, 2- and 3-D, groups, dilation, channel-first and channel-last
layouts, the "full" pooling convention with a window that lies wholly in
padding (−inf for max, 0 or 0/0 for avg, as in the JAX package),
``count_include_pad`` on and off, padding wider than half the kernel, lp
and global pooling. Layers: the JAX layer's weights carried across by
name, the output, and for the layers with parameters the gradients of
the input and every parameter under ``autograd.record``.

Tolerance: ``max|port − jax| ≤ 1e-5 · max|jax|`` in float32 (the same
arithmetic in another summation order), with infinities and NaNs at the
same places. Each JAX result is computed once a process, in the
module-scoped ``jax_ref`` cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch import autograd, gluon, interop
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import get_op as torch_op
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    odd = ~np.isfinite(want)
    np.testing.assert_array_equal(got[odd], want[odd], err_msg=what)
    if (~odd).any():
        scale = max(float(np.abs(want[~odd]).max()), 1e-30)
        err = float(np.abs(got[~odd] - want[~odd]).max()) / scale
        assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


@pytest.fixture(scope="module")
def jax_ref():
    """key -> the JAX result, computed at the first request."""
    cache = {}

    def get(key, compute):
        if key not in cache:
            cache[key] = compute()
        return cache[key]

    return get


def _cotangent(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype="float32")).reshape(
        shape)


def _jax_vjp(op, inputs, attrs):
    fn = jax_op(op).fn

    @jax.jit
    def run(*xs):
        out, vjp = jax.vjp(lambda *a: fn(*a, **attrs), *xs)
        ct = jnp.cos(jnp.arange(out.size, dtype=jnp.float32)).reshape(
            out.shape)
        return out, vjp(ct)

    out, grads = run(*[jnp.asarray(x) for x in inputs])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_vjp(op, inputs, attrs):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = torch_op(op).fn(*ts, **attrs)
    out.backward(torch.from_numpy(_cotangent(out.shape)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check_op(jax_ref, key, op, inputs, attrs):
    want, wgrads = jax_ref(key, lambda: _jax_vjp(op, inputs, attrs))
    got, grads = _port_vjp(op, inputs, attrs)
    _close(got, want, f"{key} out")
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        _close(g, w, f"{key} grad {i}")


def _conv_inputs(data, attrs, deconv=False):
    """data, weight (and bias) for a channel-first or -last conv."""
    g = attrs.get("num_group", 1)
    f, k = attrs["num_filter"], tuple(attrs["kernel"])
    last = str(attrs.get("layout") or "").endswith("C")
    c = data[-1] if last else data[1]
    if deconv:
        w = (c, f // g) + k
    else:
        w = (f,) + k + (c // g,) if last else (f, c // g) + k
    ins = [_r(*data), _r(*w, seed=1)]
    if not attrs.get("no_bias", deconv):
        ins.append(_r(f, seed=2))
    return ins


CONV = {
    "1d_ncw_s2_p1_d2": ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,),
                                         dilate=(2,), num_filter=4)),
    "1d_nwc_g2": ((2, 9, 4), dict(kernel=(3,), num_filter=4, num_group=2,
                                  layout="NWC", no_bias=True)),
    "2d_nchw_p1": ((2, 3, 7, 6), dict(kernel=(3, 3), pad=(1, 1),
                                      num_filter=5)),
    "2d_nchw_s2_d2_g2": ((2, 4, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                            dilate=(2, 2), num_filter=6,
                                            num_group=2, no_bias=True)),
    "2d_nhwc_s2_p1": ((2, 8, 7, 3), dict(kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1), num_filter=4,
                                         layout="NHWC")),
    "2d_nhwc_depthwise": ((2, 6, 6, 4), dict(kernel=(3, 3), pad=(1, 1),
                                             num_filter=4, num_group=4,
                                             layout="NHWC", no_bias=True)),
    "3d_ncdhw": ((1, 2, 4, 6, 5), dict(kernel=(2, 3, 3), stride=(1, 2, 2),
                                       pad=(1, 1, 1), num_filter=3)),
    "3d_ndhwc_g2": ((1, 4, 5, 5, 4), dict(kernel=(3, 3, 3), num_filter=4,
                                          num_group=2, layout="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(jax_ref, case):
    data, attrs = CONV[case]
    _check_op(jax_ref, "conv_" + case, "Convolution",
              _conv_inputs(data, attrs), attrs)


DECONV = {
    "1d_s2_p1_adj1": ((2, 3, 5), dict(kernel=(3,), stride=(2,), pad=(1,),
                                      adj=(1,), num_filter=4)),
    "2d_k4_s2_p1_g2_bias": ((2, 4, 5, 5), dict(kernel=(4, 4), stride=(2, 2),
                                               pad=(1, 1), num_filter=4,
                                               num_group=2, no_bias=False)),
    # adj beyond pad: the output reads zeros past the transposed output
    "2d_adj_past_pad": ((1, 2, 4, 4), dict(kernel=(3, 3), stride=(2, 2),
                                           adj=(1, 1), num_filter=3)),
    # adj not below the stride: torch's output_padding would refuse it
    "2d_adj_past_stride": ((1, 2, 4, 3), dict(kernel=(3, 3), stride=(2, 1),
                                              pad=(1, 1), adj=(2, 1),
                                              num_filter=2)),
    "2d_dilate2": ((1, 2, 5, 5), dict(kernel=(3, 3), dilate=(2, 2),
                                      pad=(2, 1), num_filter=3)),
    "3d_s2": ((1, 2, 3, 3, 3), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                    num_filter=2)),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_matches_jax(jax_ref, case):
    data, attrs = DECONV[case]
    _check_op(jax_ref, "deconv_" + case, "Deconvolution",
              _conv_inputs(data, attrs, deconv=True), attrs)


def test_deconvolution_refuses_channel_last_like_jax():
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(2, 3, 3, 3)
    with pytest.raises(MXNetError, match="channel-first"):
        torch_op("Deconvolution").fn(x, w, kernel=(3, 3), num_filter=3,
                                     layout="NHWC")


def _pool(**kw):
    return dict(kw)


POOL = {
    "max_valid_p1": ((2, 3, 9, 9), _pool(kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1))),
    "max_valid_nhwc": ((2, 9, 8, 3), _pool(kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), layout="NHWC")),
    "max_pad_past_half": ((1, 2, 7, 7), _pool(kernel=(3, 3), pad=(2, 2))),
    "avg_valid_p1_cip": ((2, 3, 9, 9), _pool(kernel=(3, 3), stride=(2, 2),
                                             pad=(1, 1), pool_type="avg")),
    "avg_valid_p1_nocip": ((2, 3, 9, 9), _pool(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "avg_pad_past_half_nocip": ((1, 2, 6, 6), _pool(
        kernel=(3, 3), pad=(2, 2), pool_type="avg",
        count_include_pad=False)),
    "max_full": ((2, 3, 8, 8), _pool(kernel=(3, 3), stride=(2, 2),
                                     pooling_convention="full")),
    # size 5, kernel 2, stride 3, pad 1: the last window is all padding
    "max_full_all_padding": ((1, 2, 5, 5), _pool(
        kernel=(2, 2), stride=(3, 3), pad=(1, 1),
        pooling_convention="full")),
    "avg_full_all_padding_cip": ((1, 2, 5, 5), _pool(
        kernel=(2, 2), stride=(3, 3), pad=(1, 1), pool_type="avg",
        pooling_convention="full")),
    "avg_full_all_padding_nocip": ((1, 2, 5, 5), _pool(
        kernel=(2, 2), stride=(3, 3), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "sum_full": ((1, 2, 7, 6), _pool(kernel=(2, 3), stride=(2, 2),
                                     pool_type="sum",
                                     pooling_convention="full")),
    "lp2": ((1, 2, 6, 6), _pool(kernel=(2, 2), stride=(2, 2),
                                pool_type="lp", p_value=2)),
    "lp3_p1": ((1, 2, 7, 7), _pool(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                   pool_type="lp", p_value=3)),
    "global_max_nhwc": ((2, 5, 6, 3), _pool(global_pool=True,
                                            layout="NHWC")),
    "global_avg": ((2, 3, 5, 6), _pool(kernel=(1, 1), global_pool=True,
                                       pool_type="avg")),
    "global_avg_1d_nwc": ((2, 7, 3), _pool(global_pool=True, pool_type="avg",
                                           layout="NWC")),
    "max_1d_full_nwc": ((2, 8, 3), _pool(kernel=(3,), stride=(2,),
                                         pooling_convention="full",
                                         layout="NWC")),
    "avg_1d_p1": ((2, 3, 8), _pool(kernel=(3,), stride=(2,), pad=(1,),
                                   pool_type="avg")),
    "max_3d_full_all_padding": ((1, 2, 5, 4, 5), _pool(
        kernel=(2, 2, 2), stride=(3, 2, 3), pad=(1, 0, 1),
        pooling_convention="full")),
    "avg_3d_ndhwc_nocip": ((1, 5, 4, 5, 2), _pool(
        kernel=(2, 2, 3), stride=(2, 2, 2), pad=(1, 1, 1), pool_type="avg",
        count_include_pad=False, layout="NDHWC")),
    "global_max_3d": ((1, 2, 3, 4, 3), _pool(global_pool=True)),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_matches_jax(jax_ref, case):
    data, attrs = POOL[case]
    _check_op(jax_ref, "pool_" + case, "Pooling", [_r(*data)], attrs)


def test_full_window_in_padding_gives_jax_values():
    """The all-padding window of the "full" convention: −inf (max), 0
    (avg counting the padding), 0/0 (avg not counting it); torch's
    ``ceil_mode`` would have dropped the window."""
    x = torch.from_numpy(_r(1, 1, 5, 5))
    kw = dict(kernel=(2, 2), stride=(3, 3), pad=(1, 1),
              pooling_convention="full")
    pool = torch_op("Pooling").fn
    assert pool(x, **kw).shape == (1, 1, 3, 3)
    assert torch.isneginf(pool(x, **kw)[..., 2, :]).all()
    assert (pool(x, pool_type="avg", **kw)[..., 2, :] == 0).all()
    assert pool(x, pool_type="avg", count_include_pad=False,
                **kw)[..., 2, :].isnan().all()


ARRAY = {
    "flatten": ("Flatten", [_r(2, 3, 2, 2)], {}),
    "concat_dim1": ("Concat", [_r(2, 3, 4), _r(2, 2, 4, seed=1),
                               _r(2, 1, 4, seed=2)], {"dim": 1}),
    "concat_last": ("concat", [_r(2, 3, 4), _r(2, 3, 2, seed=1)],
                    {"dim": -1}),
    "pad_constant_nhwc": ("Pad", [_r(1, 3, 4, 2)],
                          {"mode": "constant", "constant_value": 0.5,
                           "pad_width": (0, 0, 3, 3, 2, 1, 0, 0)}),
    "pad_edge": ("pad", [_r(1, 2, 3, 4)],
                 {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "pad_reflect": ("Pad", [_r(1, 2, 4, 5)],
                    {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 3, 2)}),
    "space_to_depth": ("space_to_depth", [_r(2, 3, 4, 6)],
                       {"block_size": 2}),
    "depth_to_space": ("depth_to_space", [_r(2, 8, 3, 2)],
                       {"block_size": 2}),
    "clip_relu6": ("clip", [_r(3, 5) * 5], {"a_min": 0.0, "a_max": 6.0}),
}


@pytest.mark.parametrize("case", sorted(ARRAY))
def test_array_op_matches_jax(jax_ref, case):
    op, inputs, attrs = ARRAY[case]
    _check_op(jax_ref, "array_" + case, op, inputs, attrs)


def test_reflect_and_edge_refuse_batch_axes():
    with pytest.raises(MXNetError, match="last three axes"):
        torch_op("Pad").fn(torch.zeros(2, 3, 4, 5), mode="reflect",
                           pad_width=(1, 1, 0, 0, 1, 1, 1, 1))


# layer -> (constructor over a package's gluon, input shape)
LAYERS = {
    "conv1d": (lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1,
                                     prefix="c_"), (2, 3, 9)),
    "conv2d_relu_groups": (lambda g: g.nn.Conv2D(
        6, (3, 2), padding=(1, 0), groups=3, activation="relu",
        prefix="c_"), (2, 3, 6, 5)),
    "conv2d_nhwc_deferred": (lambda g: g.nn.Conv2D(
        4, 3, strides=2, padding=1, layout="NHWC", use_bias=False,
        prefix="c_"), (2, 7, 6, 3)),
    "conv3d": (lambda g: g.nn.Conv3D(2, (2, 3, 3), dilation=(1, 2, 1),
                                     in_channels=2, prefix="c_"),
               (1, 2, 3, 6, 4)),
    "conv1d_transpose": (lambda g: g.nn.Conv1DTranspose(
        3, 3, strides=2, output_padding=1, prefix="c_"), (2, 2, 5)),
    "conv2d_transpose": (lambda g: g.nn.Conv2DTranspose(
        4, 4, strides=2, padding=1, groups=2, prefix="c_"), (1, 4, 3, 3)),
    "maxpool1d": (lambda g: g.nn.MaxPool1D(3, 2, ceil_mode=True), (2, 3, 8)),
    "maxpool2d": (lambda g: g.nn.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
    "maxpool3d_nhwc": (lambda g: g.nn.MaxPool3D(2, layout="NDHWC"),
                       (1, 4, 4, 4, 2)),
    "avgpool1d": (lambda g: g.nn.AvgPool1D(2, padding=1,
                                           count_include_pad=False),
                  (2, 3, 7)),
    "avgpool2d_ceil": (lambda g: g.nn.AvgPool2D(2, 3, 1, ceil_mode=True),
                       (1, 2, 5, 5)),
    "avgpool3d": (lambda g: g.nn.AvgPool3D((1, 2, 2)), (1, 2, 2, 4, 4)),
    "global_max1d": (lambda g: g.nn.GlobalMaxPool1D(), (2, 3, 5)),
    "global_max2d_nhwc": (lambda g: g.nn.GlobalMaxPool2D(layout="NHWC"),
                          (2, 4, 3, 5)),
    "global_max3d": (lambda g: g.nn.GlobalMaxPool3D(), (1, 2, 2, 3, 2)),
    "global_avg1d": (lambda g: g.nn.GlobalAvgPool1D(layout="NWC"),
                     (2, 5, 3)),
    "global_avg2d": (lambda g: g.nn.GlobalAvgPool2D(), (2, 3, 4, 5)),
    "global_avg3d": (lambda g: g.nn.GlobalAvgPool3D(), (1, 2, 2, 3, 2)),
    "reflection_pad2d": (lambda g: g.nn.ReflectionPad2D(2), (1, 2, 4, 5)),
    "flatten": (lambda g: g.nn.Flatten(), (2, 3, 2, 2)),
    "lambda_name": (lambda g: g.nn.Lambda("abs"), (2, 3)),
    "hybrid_lambda_name": (lambda g: g.nn.HybridLambda("Flatten"),
                           (2, 2, 3)),
    "hybrid_lambda_fn": (lambda g: g.nn.HybridLambda(
        lambda F, x: F.clip(x, a_min=-0.5, a_max=0.5)), (2, 3)),
}


def _layer_run(pkg, ag, blk, x):
    """Output, and for a layer with parameters the gradients of ``sum(out
    · cos)`` for the input and every parameter (a layer without any is a
    wrapper of an op whose gradients the grids above hold)."""
    ctx = {} if pkg is jmx else {"ctx": mx.cpu()}
    xa = pkg.nd.array(x, **ctx)
    if not len(blk.collect_params()):
        return blk(xa).asnumpy(), {}
    xa.attach_grad()
    with ag.record():
        out = blk(xa)
        loss = (out * pkg.nd.array(_cotangent(out.shape), **ctx)).sum()
    loss.backward()
    grads = {k: p.grad.asnumpy() for k, p in blk.collect_params().items()}
    grads["data"] = xa.grad.asnumpy()
    return out.asnumpy(), grads


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layer_matches_jax(jax_ref, name):
    make, shape = LAYERS[name]
    x = _r(*shape, seed=3)

    def jax_side():
        blk = make(jmx.gluon)
        blk.initialize(jmx.init.Xavier())
        if len(blk.collect_params()):
            blk.hybridize()     # one program for the conv and its bias
        run = _layer_run(jmx, jag, blk, x)    # finishes deferred shapes
        return {k: p.data().asnumpy()
                for k, p in blk.collect_params().items()}, run

    weights, (want, wgrads) = jax_ref("layer_" + name, jax_side)
    with mx.cpu():
        blk = make(gluon)
        blk.initialize()
        interop.load_block_params(blk, weights)   # deferred shapes too
    got, grads = _layer_run(mx, autograd, blk, x)
    _close(got, want, name)
    assert grads.keys() == wgrads.keys()
    for k, w in wgrads.items():
        _close(grads[k], w, k)


def test_channel_last_weight_is_drawn_channel_first():
    """An NHWC conv weight (O, kh, kw, I) is drawn as (O, I, kh, kw) and
    permuted, so its fan-out is O·kh·kw, as its NCHW twin's (drawn on the
    stored shape it would be O·kw·I): ``Xavier(factor_type="out")``
    bounds it by √(3 / (O·kh·kw))."""
    with mx.cpu():
        conv = gluon.nn.Conv2D(8, (3, 1), layout="NHWC", in_channels=64,
                               use_bias=False, prefix="c_")
        conv.initialize(mx.init.Xavier(factor_type="out"))
        w = conv.weight.data().asnumpy()
    assert w.shape == (8, 3, 1, 64)
    bound = np.sqrt(3.0 / (8 * 3))
    assert bound * 0.9 < np.abs(w).max() <= bound

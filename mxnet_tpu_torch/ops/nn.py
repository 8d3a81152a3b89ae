"""Neural-network ops of the LM, the conv nets, their losses and the
symbolic heads.

Counterpart of ``FullyConnected``, ``Convolution``, ``Deconvolution``,
``Pooling``, ``LayerNorm``, ``BatchNorm``, ``Activation``, ``Dropout``,
``InstanceNorm``, ``LRN``, ``LeakyReLU``, ``softmax``, ``log_softmax``,
``softmin``, ``SoftmaxActivation``, ``softmax_cross_entropy``,
``SoftmaxOutput``, the regression outputs, ``SVMOutput``, ``UpSampling``,
the spatial transformer (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``) and ``_contrib_flash_attention`` in
``mxnet_tpu/ops/nn.py``, and
``MakeLoss`` in ``mxnet_tpu/ops/parity_ops.py``
(reference ``src/operator/nn/``, ``src/operator/loss_binary_op.cc``,
``softmax_output.cc``, ``make_loss.cc``). Matrix products
go to ``torch`` (cuBLAS on the card, in full float32: TF32 stays off);
convolutions and pooling go to ``torch.nn.functional`` (cuDNN on the
card), where the JAX package lowers them through XLA; attention and the
fused cross-entropy go to the hand-written Hopper kernels in
:mod:`.hopper_kernels`.

Channel-last layouts (NWC, NHWC, NDHWC, weights O*kI) reach cuDNN as
permuted views: an NHWC tensor permuted to NCHW order is a
``channels_last`` tensor, with no copy, and cuDNN runs its NHWC kernels on
it; the result is permuted back, again a view.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected", arg_names=("data", "weight", "bias"))
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    """out = X·Wᵀ + b, weight (num_hidden, input_dim); with
    ``flatten=False`` a 3-D input keeps its leading axes. Mixed input
    types promote as the JAX op's ``jnp.dot(X, Wᵀ) + b`` promotes them:
    the product in the type of X and W (bf16 data on a float32 weight runs
    in float32), then a bias of another type promotes the sum."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    bias = None if no_bias else bias
    dt = torch.promote_types(data.dtype, weight.dtype)
    data, weight = data.to(dt), weight.to(dt)
    if bias is None or bias.dtype == dt:
        return F.linear(data, weight, bias)
    return F.linear(data, weight) + bias


# ------------------------------------------------------- convolution, pooling
_DEFAULT_LAYOUT = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _pair(v, n):
    """A per-axis tuple: None or () is all ones, an int is repeated."""
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _channel_last(nd, layout) -> bool:
    """Whether ``layout`` (None: NCW/NCHW/NCDHW) puts the channels last;
    the weight follows the data (OIHW for NCHW, OHWI for NHWC)."""
    lhs = _DEFAULT_LAYOUT[nd] if layout in (None, "None", "") \
        else str(layout)
    if lhs not in (_DEFAULT_LAYOUT[nd], "N" + _DEFAULT_LAYOUT[nd][2:] + "C"):
        raise MXNetError(f"layout {lhs!r} for a {nd}-D op: the port takes "
                         f"{_DEFAULT_LAYOUT[nd]} or its channel-last form")
    return lhs.endswith("C")


def _to_first(x):
    """N*C (or O*kI) -> NC* (OI*k) as a view."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _to_last(x):
    return x.permute(0, *range(2, x.ndim), 1)


def _add_bias(out, bias, last):
    """``out + bias`` on the channel axis, promoting as ``jnp`` does."""
    shape = [1] * out.ndim
    shape[-1 if last else 1] = -1
    return out + bias.reshape(shape)


@register("Convolution", arg_names=("data", "weight", "bias"))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=1, num_group=1, no_bias=False,
                 workspace=1024, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """1-, 2- or 3-D convolution, weight (num_filter, C/g, *kernel) or,
    channel-last, (num_filter, *kernel, C/g); data and weight in the type
    they promote to."""
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError(f"Convolution: kernel {kernel!r} is not 1-, 2- or "
                         f"3-D")
    last = _channel_last(nd, layout)
    dt = torch.promote_types(data.dtype, weight.dtype)
    data, weight = data.to(dt), weight.to(dt)
    if last:
        data, weight = _to_first(data), _to_first(weight)
    out = _CONV[nd](data, weight, None, _pair(stride, nd),
                    _pair(pad, nd) if pad else 0, _pair(dilate, nd),
                    int(num_group))
    if last:
        out = _to_last(out)
    if not no_bias and bias is not None:
        out = _add_bias(out, bias, last)
    return out


@register("Deconvolution", arg_names=("data", "weight", "bias"))
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=1,
                   num_group=1, no_bias=True, workspace=512, cudnn_tune=None,
                   cudnn_off=False, layout=None):
    """Transposed convolution, weight (C, num_filter/g, *kernel),
    channel-first only (as in the JAX package). The whole transposed
    output (no padding) is cut at ``pad`` on each side and grown by
    ``adj`` at the high end, where it reads zeros past its end: that
    holds for any ``adj``, where torch's ``output_padding`` must stay
    below the stride or the dilation."""
    nd = len(kernel)
    if nd not in _CONV_T:
        raise MXNetError(f"Deconvolution: kernel {kernel!r} is not 1-, 2- "
                         f"or 3-D")
    if layout not in (None, "None", "") and not str(layout).startswith("NC"):
        raise MXNetError(
            f"Deconvolution supports channel-first layouts only (got "
            f"{layout!r}); the reference restricts NHWC deconv to cuDNN too")
    pad = _pair(pad, nd) if pad else (0,) * nd
    adj = _pair(adj, nd) if adj else (0,) * nd
    dt = torch.promote_types(data.dtype, weight.dtype)
    full = _CONV_T[nd](data.to(dt), weight.to(dt), None, _pair(stride, nd),
                       0, 0, int(num_group), _pair(dilate, nd))
    cut = tuple(slice(p, n - p + a) for p, a, n in
                zip(pad, adj, full.shape[2:]))
    grow = [max(0, a - p) for p, a in zip(pad, adj)]
    if any(grow):
        full = F.pad(full, [v for g in reversed(grow) for v in (0, g)])
    out = full[(slice(None), slice(None)) + cut]
    if not no_bias and bias is not None:
        out = _add_bias(out, bias, False)
    return out


def _pool_window(x, kernel, stride, pad, hi, pool_type, count_include_pad,
                 p_value):
    """Pooling of a channel-first 2- or 3-D (spatial) tensor with low pad
    ``pad`` and high pad ``hi``: torch pads the windows itself where both
    sides are equal and at most half the kernel; otherwise the input is
    padded first (−inf for max, 0 otherwise) and pooled with none, so a
    window that lies wholly in padding gives −inf (max) or 0/0 (avg
    without the padding counted), as in the JAX package."""
    two = len(kernel) == 2
    max_pool = F.max_pool2d if two else F.max_pool3d
    avg_pool = F.avg_pool2d if two else F.avg_pool3d
    native = list(hi) == list(pad) and all(
        2 * p <= k for p, k in zip(pad, kernel))
    padding = list(pad) if native else 0
    widths = [v for lo, h in zip(reversed(pad), reversed(hi))
              for v in (lo, h)]
    fill = float("-inf") if pool_type == "max" else 0.0

    def padded(t):
        return t if native else F.pad(t, widths, value=fill)

    def window_sum(t):
        return avg_pool(padded(t), kernel, stride, padding,
                        divisor_override=1)

    if pool_type == "max":
        return max_pool(padded(x), kernel, stride, padding)
    if pool_type == "sum":
        return window_sum(x)
    if pool_type == "lp":
        p = float(p_value)
        return window_sum(x.abs() ** p) ** (1.0 / p)
    if pool_type != "avg":
        raise MXNetError(f"bad pool_type {pool_type}")
    if count_include_pad or native:
        return avg_pool(padded(x), kernel, stride, padding,
                        count_include_pad=bool(count_include_pad))
    return window_sum(x) / window_sum(torch.ones_like(x))


@register("Pooling", arg_names=("data",))
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", cudnn_off=False, p_value=2,
             count_include_pad=True, layout=None):
    """max / avg / sum / lp pooling over the 1-, 2- or 3-D spatial axes.
    ``pooling_convention="full"`` sizes the output with the ceiling and
    pads the high side by what the last window needs (at least ``pad``);
    avg with ``count_include_pad`` divides by the whole kernel; lp is
    ``(Σ|x|^p)^(1/p)``."""
    nd = data.ndim - 2
    if nd not in _CONV:
        raise MXNetError(f"Pooling: a {data.ndim}-D input has no 1-, 2- or "
                         f"3-D spatial axes")
    last = _channel_last(nd, layout)
    x = _to_first(data) if last else data
    if global_pool:
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    kernel = _pair(kernel, nd)
    stride = _pair(stride, nd) if stride else (1,) * nd
    pad = _pair(pad, nd) if pad else (0,) * nd
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(nd):
            size = x.shape[2 + i]
            out_sz = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            need = (out_sz - 1) * stride[i] + kernel[i] - size - pad[i]
            hi[i] = max(need, pad[i])
    if nd == 1:          # as 2-D, with a unit axis
        out = _pool_window(x.unsqueeze(-1), kernel + (1,), stride + (1,),
                           pad + (0,), hi + [0], pool_type,
                           count_include_pad, p_value).squeeze(-1)
    else:
        out = _pool_window(x, kernel, stride, pad, hi, pool_type,
                           count_include_pad, p_value)
    return _to_last(out) if last else out


@register("LayerNorm", num_outputs=3, arg_names=("data", "gamma", "beta"))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """One-pass statistics in float32: var = E[x²] − E[x]², clamped at 0.
    Outputs (out, mean, var) like the JAX package."""
    ax = int(axis) % data.ndim
    xf = data.float()
    mean = xf.mean(dim=ax, keepdim=True)
    var = ((xf * xf).mean(dim=ax, keepdim=True) - mean * mean).clamp_min(0.0)
    shape = [data.shape[ax] if i == ax else 1 for i in range(data.ndim)]
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(data.dtype) \
        * gamma.reshape(shape) + beta.reshape(shape)
    return (out, mean.squeeze(ax).to(data.dtype),
            var.squeeze(ax).to(data.dtype))


@register("InstanceNorm", arg_names=("data", "gamma", "beta"))
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Per sample and channel over the spatial axes: one-pass float32
    statistics (``var = E[x²] − E[x]²`` clamped at 0), normalised in
    float32, cast back to the data's type, then scaled and shifted (the
    JAX package's order; ``F.instance_norm`` differs in all three)."""
    red = tuple(range(2, data.ndim))
    xf = data.float()
    mean = xf.mean(dim=red, keepdim=True)
    var = ((xf * xf).mean(dim=red, keepdim=True) - mean * mean).clamp_min(0.0)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return ((xf - mean) * torch.rsqrt(var + float(eps))).to(data.dtype) \
        * gamma.reshape(shape) + beta.reshape(shape)


@register("LRN", num_outputs=2, arg_names=("data",))
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response norm across channels (reference
    ``src/operator/nn/lrn.cc``): ``x / (k + α/n · Σ x²)^β`` over a window
    of ``nsize`` channels; outputs (out, the denominator).
    ``F.local_response_norm`` scales the sum otherwise."""
    n = int(nsize)
    half = n // 2
    padded = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    windows = sum(padded[:, i:i + data.shape[1]] for i in range(n))
    norm = (float(knorm) + (float(alpha) / n) * windows) ** float(beta)
    return data / norm, norm


@register("Activation", arg_names=("data",))
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1.0 + data.abs())
    raise MXNetError(f"bad act_type {act_type}")


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", needs_rng=True, arg_names=("data", "gamma"))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, rng=None,
                is_train=True):
    """The leaky family: ``x`` where ``x >= 0``, else ``slope·x`` (leaky),
    ``gamma·x`` per channel (prelu), ``slope·expm1(x)`` (elu), SELU's
    scaled ELU, exact-erf GELU, or (rrelu) ``x`` times a slope drawn
    uniformly from [lower, upper] per element from ``rng`` in training and
    their mean otherwise."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, float(slope) * data)
    if act_type == "prelu":
        shape = (1, -1) + (1,) * (data.ndim - 2) if data.ndim > 1 else (-1,)
        return torch.where(data >= 0, data, gamma.reshape(shape) * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, float(slope) * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data >= 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        lo, hi = float(lower_bound), float(upper_bound)
        if is_train and rng is not None:
            sl = torch.empty_like(data).uniform_(lo, hi, generator=rng)
        else:
            sl = (lo + hi) / 2.0
        return torch.where(data >= 0, data, sl * data)
    raise MXNetError(f"bad act_type {act_type}")


@register("Dropout", needs_rng=True, arg_names=("data",))
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             rng=None, is_train=True):
    """Identity at inference; in training mode a Bernoulli keep-mask drawn
    from the ``torch.Generator`` passed as ``rng``, scaled by 1/keep."""
    if (not is_train and mode != "always") or p <= 0.0 or rng is None:
        return data
    shape = list(data.shape)
    for ax in (axes or ()):
        shape[int(ax)] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device)
    mask.bernoulli_(keep, generator=rng)
    return data * (mask / keep)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """An affine ``data`` (N, 6) maps the target's (x, y) grid, spaced
    evenly over [-1, 1] (``F.affine_grid`` with ``align_corners=True``),
    to source coordinates: (N, 2, H, W) with x in channel 0, y in 1. The
    ``warp`` type returns ``data`` itself as the grid, as the JAX package
    does."""
    if transform_type != "affine":
        return data
    h, w = int(target_shape[0]), int(target_shape[1])
    ys = torch.linspace(-1.0, 1.0, h, dtype=data.dtype, device=data.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])
    return torch.matmul(data.reshape(-1, 2, 3), base).reshape(-1, 2, h, w)


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False):
    """``data`` (N, C, H, W) read at ``grid``'s (x, y) in [-1, 1]: the
    four neighbours' bilinear mix, each neighbour's index clamped to the
    image, and the whole sample zero where the point lies outside
    [0, W-1] x [0, H-1] (``F.grid_sample`` would pad each neighbour with
    zeros instead)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    bidx = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(yi, xi):
        yi = yi.to(torch.int64).clamp(0, h - 1)
        xi = xi.to(torch.int64).clamp(0, w - 1)
        return data[bidx, :, yi, xi].permute(0, 3, 1, 2)

    out = (((x1 - gx) * (y1 - gy)).unsqueeze(1) * gather(y0, x0)
           + ((x1 - gx) * (gy - y0)).unsqueeze(1) * gather(y1, x0)
           + ((gx - x0) * (y1 - gy)).unsqueeze(1) * gather(y0, x1)
           + ((gx - x0) * (gy - y0)).unsqueeze(1) * gather(y1, x1))
    inside = ((gx >= 0) & (gx <= w - 1) & (gy >= 0) & (gy <= h - 1))
    return out * inside.to(data.dtype).unsqueeze(1)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """``BilinearSampler`` over the affine grid of ``loc``."""
    return _bilinear_sampler(data, _grid_generator(
        loc, transform_type="affine", target_shape=target_shape))


@register("_contrib_flash_attention", aliases=["contrib_flash_attention"],
          arg_names=("query", "key", "value"))
def _flash_attention_op(query, key, value, causal=False, scale=None,
                        q_offset=0, k_offset=0):
    """Flash attention on (B, H, T, D); the Hopper kernel on the card."""
    from .hopper_kernels import flash_attention
    return flash_attention(query, key, value, causal=bool(causal),
                           scale=None if scale is None else float(scale),
                           q_offset=int(q_offset), k_offset=int(k_offset))


@register("softmax", arg_names=("data",))
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False,
             dtype=None):
    """Softmax over ``axis``; with ``use_length`` only the first
    ``length[i]`` entries of row ``i`` (batch axis 0) take part, the rest
    are 0 (and ``dtype`` is not applied, as in the JAX package)."""
    from ..ndarray.ndarray import torch_dtype
    x = data / temperature if temperature else data
    ax = int(axis) % data.ndim
    if use_length and length is not None:
        pos = torch.arange(data.shape[ax], device=data.device).reshape(
            [data.shape[ax] if i == ax else 1 for i in range(data.ndim)])
        lens = length.reshape([-1 if i == 0 else 1 for i in range(data.ndim)])
        mask = pos < lens
        out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=ax)
        return out.masked_fill(~mask, 0.0)
    out = torch.softmax(x, dim=ax)
    return out.to(torch_dtype(dtype)) if dtype else out


@register("log_softmax", arg_names=("data",))
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    from ..ndarray.ndarray import torch_dtype
    x = data / temperature if temperature else data
    out = torch.log_softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("softmin", arg_names=("data",))
def _softmin(data, axis=-1, temperature=None, dtype=None):
    return _softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    """Softmax over the channels (``mode="channel"``, axis 1) or over
    everything but the batch axis."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("UpSampling", arg_names=("data",))
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                num_args=1, multi_input_mode="concat", workspace=512):
    """The first input scaled by ``scale`` on both spatial axes: each
    pixel repeated (nearest) or resampled bilinearly at half-pixel centres
    (``jax.image.resize``'s upsampling); further inputs (the bilinear
    mode's learned weight, or more maps to concatenate) are ignored, as in
    the JAX package."""
    data = args[0]
    s = int(scale)
    if sample_type == "nearest":
        return data.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
    return F.interpolate(data, scale_factor=s, mode="bilinear",
                         align_corners=False)


@register("softmax_cross_entropy", arg_names=("data", "label"))
def _softmax_cross_entropy(data, label):
    """Total softmax CE over the batch, shape (1,) (reference
    ``loss_binary_op.cc``: out = Σ_i CE(row_i)); the per-row CE is the
    fused Hopper kernel on the card, its gradient ``(softmax − onehot)·g``."""
    from .hopper_kernels import softmax_cross_entropy
    return softmax_cross_entropy(data, label.reshape(-1)).sum().reshape(1)


# ------------------------------------------------------------ symbolic heads
# The ops below carry the reference's own backward rules, each a
# ``torch.autograd.Function`` in plain torch (none is a TPU kernel).

@register("BatchNorm", num_outputs=3,
          arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
          aux_args=("moving_mean", "moving_var"))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                is_train=True):
    """Batch statistics in training (one float32 pass: ``var = E[x²] −
    E[x]²`` clamped at 0, the biased variance; float64 data keeps float64),
    the moving ones otherwise or under ``use_global_stats``; ``fix_gamma``
    scales by 1 (gamma gets no gradient). Outputs (out, mean, var) like
    the JAX package; the executor folds mean and var into the moving
    statistics (``executor._bn_aux_update``)."""
    ax = int(axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    bshape = [data.shape[ax] if i == ax else 1 for i in range(data.ndim)]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    st = torch.promote_types(data.dtype, torch.float32)
    if is_train and not use_global_stats:
        xf = data.to(st)
        mean = xf.mean(dim=red)
        var = ((xf * xf).mean(dim=red) - mean * mean).clamp_min(0.0)
    else:
        mean, var = moving_mean.to(st), moving_var.to(st)
    scale = torch.rsqrt(var + eps) * g.to(st)
    shift = beta.to(st) - mean * scale
    out = data * scale.to(data.dtype).reshape(bshape) \
        + shift.to(data.dtype).reshape(bshape)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient and emits
    ``(p − onehot(label))·scale`` (reference ``softmax_output.cc``)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        multi = attrs["multi_output"]
        out = torch.softmax(data, dim=1) if multi else torch.softmax(
            data.reshape(data.shape[0], -1), dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        lab = label.to(torch.int64)
        # jax.nn.one_hot: a label outside [0, C) (the ignore label −1)
        # gives a row of zeros
        if a["multi_output"]:            # data (N, C, ...), label (N, ...)
            classes = torch.arange(out.shape[1], device=lab.device)
            oh = (lab.unsqueeze(1) == classes.reshape(
                (1, -1) + (1,) * (lab.ndim - 1))).to(out.dtype)
        else:
            flat = out.reshape(out.shape[0], -1)
            classes = torch.arange(flat.shape[-1], device=lab.device)
            oh = (lab.reshape(-1, 1) == classes).to(out.dtype).reshape(
                out.shape)
        alpha = a["smooth_alpha"]
        if alpha:
            k = oh.shape[1] if a["multi_output"] else \
                oh.reshape(oh.shape[0], -1).shape[-1]
            oh = oh * (1.0 - alpha) + alpha / (k - 1) * (1.0 - oh)
        grad = out - oh
        keep = label != a["ignore_label"]
        if a["use_ignore"]:
            mask = keep.to(out.dtype)
            mask = mask.unsqueeze(1) if a["multi_output"] else \
                mask.reshape((-1,) + (1,) * (out.ndim - 1))
            grad = grad * mask
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / out.shape[0]
        elif a["normalization"] == "valid" and a["use_ignore"]:
            grad = grad / keep.to(out.dtype).sum().clamp_min(1.0)
        return grad * scale, torch.zeros_like(label), None


@register("SoftmaxOutput", aliases=["Softmax"], arg_names=("data", "label"))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Softmax with the implicit cross-entropy gradient: the head gradient
    is ignored, ``(p − onehot)·grad_scale`` flows back, normalised by
    ``batch`` or by the ``valid`` (not ignored) labels."""
    return _SoftmaxOutput.apply(data, label, {
        "grad_scale": float(grad_scale), "ignore_label": float(ignore_label),
        "multi_output": bool(multi_output), "use_ignore": bool(use_ignore),
        "normalization": str(normalization),
        "smooth_alpha": float(smooth_alpha)})


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and emits
    ``grad_scale`` (reference ``make_loss.cc``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        # the loss itself is kept only where its values set the scale
        if normalization == "valid":
            ctx.save_for_backward(data)
        ctx.like = torch.empty_like(data, device="meta")
        ctx.attrs = (grad_scale, valid_thresh, normalization)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        # built on the device (a fill, no copy from the host): a host
        # scalar copied in would wait for the whole forward to finish
        grad_scale, valid_thresh, normalization = ctx.attrs
        like = ctx.like
        if normalization == "batch":
            grad_scale /= like.shape[0]
        grad = torch.full(like.shape, grad_scale, dtype=like.dtype,
                          device=g.device)
        if normalization == "valid":
            (d,) = ctx.saved_tensors
            grad /= (d > valid_thresh).to(d.dtype).sum().clamp_min(1.0)
        return grad, None, None, None


@register("MakeLoss", arg_names=("data",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Marks a loss head: forward passes ``data`` through, backward emits
    ``grad_scale`` (normalised by ``valid`` elements or ``batch``) whatever
    the head gradient."""
    return _MakeLoss.apply(data, float(grad_scale), float(valid_thresh),
                           str(normalization))


class _RegressionOutput(torch.autograd.Function):
    """The regression heads: the forward is ``data`` (linear, MAE) or its
    sigmoid (logistic); the backward ignores the head gradient and emits
    ``(out − label)·grad_scale``, or its sign for MAE (the JAX package's
    rules, reference ``regression_output.cc``)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.view_as(
            data)
        ctx.save_for_backward(out, label)
        ctx.attrs = (kind, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.attrs
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if kind == "mae" else diff
        return grad * grad_scale, torch.zeros_like(label), None, None


def _regression(name, kind):
    register(name, arg_names=("data", "label"))(
        lambda data, label, grad_scale=1.0: _RegressionOutput.apply(
            data, label, kind, float(grad_scale)))


_regression("LinearRegressionOutput", "linear")
_regression("LogisticRegressionOutput", "logistic")
_regression("MAERegressionOutput", "mae")


class _SVMOutput(torch.autograd.Function):
    """Identity on the scores; the backward ignores the head gradient and
    writes the hinge's gradient (reference ``svm_output.cc``): L1 with
    ``use_linear``, else squared, scaled by the regularization
    coefficient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        k = label.reshape(-1).to(torch.int64)
        is_true = k.unsqueeze(-1) == torch.arange(d.shape[1],
                                                  device=d.device)
        if use_linear:
            g_true = -(margin > d).to(d.dtype) * reg
            g_other = (margin > -d).to(d.dtype) * reg
        else:
            g_true = -2.0 * torch.clamp_min(margin - d, 0.0) * reg
            g_other = 2.0 * torch.clamp_min(margin + d, 0.0) * reg
        return (torch.where(is_true, g_true, g_other),
                torch.zeros_like(label), None, None, None)


@register("SVMOutput", arg_names=("data", "label"))
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))

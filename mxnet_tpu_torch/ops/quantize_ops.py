"""The int8 family: the quantize codec and the quantized compute ops.

Counterpart of ``mxnet_tpu/ops/quantize_ops.py`` (``_contrib_quantize``,
``_contrib_dequantize``, ``_contrib_requantize``,
``_contrib_quantized_fully_connected``) and of the four quantized ops of
``mxnet_tpu/ops/parity_ops.py`` (``_contrib_quantized_conv``,
``_contrib_quantized_pooling``, ``_contrib_quantized_flatten``,
``_contrib_quantized_concat``); reference
``src/operator/quantization/``. Registered at import, so a quantized
graph binds like any other.

Bitwise parity with the JAX package, which runs these through XLA:

* the codecs keep its order of operations — ``round(x * (127 / amax))``
  with the scale formed first, in float32, by a true division (torch's
  ``scalar / tensor`` is a reciprocal times the scalar, and a CUDA tensor
  divided by a host scalar is multiplied by its reciprocal, so every
  division here is tensor by tensor on one device; a product with a
  float32 constant may take it as a Python scalar, which rounds alike);
  a division by the constant 127 is a product with float32(1/127), as
  XLA rewrites it; rounding half to even; ``_amax`` floored at
  ``_RANGE_EPS`` where the JAX package floors it and nowhere else;
* a float converted to an integer saturates and takes NaN to 0, as XLA's
  conversion does (:func:`_to_int`);
* the int32 accumulators are exact. On the CPU the product runs in
  float64 (``|Σ| ≤ 127²·K`` stays far below 2^53, so every partial sum is
  an exact integer); on the card it is ``torch._int_mm`` (cuBLASLt's int8
  tensor-core product) over an int8 im2col, with the rows, the reduction
  length and the columns padded with zeros to what it takes. An integer
  product is never run in float32, and a CUDA tensor never goes to the
  CPU.

Degenerate ranges (``min == max``) are floored at ``_RANGE_EPS`` so every
op of an island has a finite scale.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import get_op, register

#: floor of the half-range max(|min|, |max|): a range of width zero still
#: gives a finite scale; far below any activation scale
_RANGE_EPS = 1e-8
#: float32(0x7FFFFFFF): the int32 accumulator's full scale, 2^31
_INT32_SCALE = 2147483647.0
#: x / 127 as XLA computes it: x times the float32 reciprocal
_INV_127 = float(np.float32(1) / np.float32(127))
#: (a / 127) * (b / 127) as XLA computes it, where a and b have one
#: shape: (a * b) * float32(inv²)
_INV_127_SQ = float(np.float32(_INV_127) * np.float32(_INV_127))


def _full(v, like):
    """A 0-d float32 tensor of ``v`` beside ``like``."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _f32(t):
    return t.to(torch.float32)


def _to_int(x, dtype):
    """``x.astype(dtype)`` as XLA converts: toward zero, saturating at the
    type's bounds, NaN to 0 (torch's conversion of an out-of-range value
    is undefined)."""
    info = torch.iinfo(dtype)
    out = torch.where(torch.isnan(x), torch.zeros_like(x), x).to(dtype)
    out = torch.where(x >= float(info.max), torch.full_like(out, info.max),
                      out)
    return torch.where(x <= float(info.min), torch.full_like(out, info.min),
                       out)


def _amax(min_range, max_range):
    """max(|min|, |max|) floored at ``_RANGE_EPS``."""
    return torch.clamp_min(torch.maximum(min_range.abs(), max_range.abs()),
                           _RANGE_EPS)


def _div127(x):
    return x * _INV_127


def _codec(f, amax):
    """``clip(round(f * (127 / amax)), -127, 127)`` as int8 (in range
    after the clip: only NaN needs XLA's conversion, to 0)."""
    q = torch.round(f * (_full(127.0, amax) / amax)).clamp(-127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8)


@register("_contrib_quantize", aliases=["contrib_quantize"], num_outputs=3,
          differentiable=False)
def _quantize(data, min_range, max_range, out_type="int8"):
    """Affine-quantize float -> int8 over the range widened to hold 0
    (reference ``quantization/quantize.cc``)."""
    mn = torch.clamp_max(_f32(min_range), 0.0)
    mx = torch.clamp_min(_f32(max_range), 0.0)
    amax = _amax(mn, mx)
    return _codec(data, amax), -amax, amax


@register("_contrib_dequantize", aliases=["contrib_dequantize"],
          differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    amax = torch.maximum(_f32(min_range).abs(), _f32(max_range).abs())
    return data.to(torch.float32) * _div127(amax)


@register("_contrib_requantize", aliases=["contrib_requantize"],
          num_outputs=3, differentiable=False)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None, out_type="int8"):
    """int32 accumulator -> int8 over the calibrated output range, or the
    batch's own range without one."""
    rng = torch.maximum(_f32(min_range).abs(), _f32(max_range).abs())
    f = data.to(torch.float32) * (rng * 2.0 ** -31)
    if min_calib_range is not None:
        mn = _full(float(min_calib_range), f)
        mx = _full(float(max_calib_range), f)
    else:
        mn, mx = torch.amin(f), torch.amax(f)
    amax = _amax(mn, mx)
    return _codec(f, amax), -amax, amax


# ---------------------------------------------------------- int32 products
_MM_ROWS = 17          # torch._int_mm: more than 16 rows
_MM_ALIGN = 8          # ... and a reduction length and columns of 8s


def _ceil_to(n, m):
    return -(-n // m) * m


def _int_mm_card(rows, weight):
    """``rows (M, K) int8 · weight (N, K)ᵀ int8`` -> int32 (M, N) on the
    card by ``torch._int_mm``: zero rows, reduction columns and output
    columns padded in as it requires; mat2 column-major (the ``TN`` form
    of cuBLASLt's int8 product)."""
    M, K = rows.shape
    N = weight.shape[0]
    Mp, Kp, Np = max(_MM_ROWS, M), _ceil_to(K, _MM_ALIGN), \
        _ceil_to(N, _MM_ALIGN)
    a = rows.contiguous() if (Mp, Kp) == (M, K) else \
        F.pad(rows, (0, Kp - K, 0, Mp - M))
    b = weight.contiguous() if (Np, Kp) == (N, K) else \
        F.pad(weight, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a, b.t())
    return out[:M, :N]


def _check_int8(*ts):
    for t in ts:
        if t.dtype != torch.int8:
            raise MXNetError(f"a quantized product takes int8 data and "
                             f"weights, got {t.dtype}")


def _int_matmul(data, weight):
    """Exact ``data (M, K) · weight (N, K)ᵀ`` of int8 values as int32."""
    if data.device.type == "cuda":
        _check_int8(data, weight)
        return _int_mm_card(data, weight)
    if data.device.type == "meta":
        return torch.empty((data.shape[0], weight.shape[0]),
                           dtype=torch.int32, device="meta")
    return _to_int(torch.matmul(data.to(torch.float64),
                                weight.to(torch.float64).t()), torch.int32)


def _im2col(x, kernel, stride, dilate, pad):
    """Channel-first int8 ``x`` (B, C, *spatial) -> rows (B·L, C·Πk) in
    the weight's (c, *k) order, and the output's spatial shape: zero
    padding, then ``Tensor.unfold`` views (no float copy), one copy into
    the rows."""
    nd = len(kernel)
    x = F.pad(x, [v for p in reversed(pad) for v in (p, p)]) \
        if any(pad) else x
    for i, (k, s, d) in enumerate(zip(kernel, stride, dilate)):
        span = (k - 1) * d + 1
        x = x.unfold(2 + i, span, s)
        if d > 1:
            x = x[..., ::d]
    # (B, C, *out, *k) -> (B, *out, C, *k)
    out_sp = tuple(x.shape[2:2 + nd])
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) + \
        tuple(range(2 + nd, 2 + 2 * nd))
    rows = x.permute(*perm).reshape(-1, x.shape[1] * math.prod(kernel))
    return rows, out_sp


def _int_conv_mm(data, weight, stride, pad, dilate, groups):
    """The card's exact int32 convolution of channel-first int8 data (B,
    C, *sp) and weight (O, C/g, *k): an im2col and ``torch._int_mm`` a
    group. Returns a channels-last view (B, O, *out), no copy."""
    _check_int8(data, weight)
    nd = weight.ndim - 2
    B, O = data.shape[0], weight.shape[0]
    cg, og = data.shape[1] // groups, O // groups
    outs = []
    for g in range(groups):
        rows, out_sp = _im2col(data[:, g * cg:(g + 1) * cg],
                               tuple(weight.shape[2:]), stride, dilate, pad)
        w = weight[g * og:(g + 1) * og].reshape(og, -1)
        outs.append(_int_mm_card(rows, w))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    acc = acc.reshape((B,) + out_sp + (O,))
    return acc.permute(0, nd + 1, *range(1, nd + 1))


def _int_conv(data, weight, stride, pad, dilate, groups):
    """Exact int32 convolution: :func:`_int_conv_mm` on the card, float64
    elsewhere (every partial sum an exact integer)."""
    if data.device.type == "cuda":
        return _int_conv_mm(data, weight, stride, pad, dilate, groups)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[weight.ndim - 2]
    out = conv(data.to(torch.float64), weight.to(torch.float64), None,
               stride, pad, dilate, groups)
    return out.to(torch.int32) if data.device.type == "meta" else \
        _to_int(out, torch.int32)


def _out_scale(min_data, max_data, min_weight, max_weight):
    """``(amax_d / 127) * (amax_w / 127)`` as XLA computes it: where the
    two ranges have one shape its simplifier gathers the constants,
    ``(amax_d · amax_w) · float32(1/127²)``; a broadcast between them (a
    0-d range against a (1,) one, as reference ``.params`` store scalars)
    keeps the products as written."""
    ad = _amax(_f32(min_data), _f32(max_data))
    aw = _amax(_f32(min_weight), _f32(max_weight))
    if ad.shape != aw.shape:
        return _div127(ad) * _div127(aw)
    prod = ad * aw
    return prod * _INV_127_SQ


def _bias_int32(bias, min_bias, max_bias, out_scale):
    """``round(bias · (scale_b / out_scale))`` as int32 (the bias scale is
    not floored, as in the JAX package)."""
    scale_b = _div127(torch.maximum(_f32(min_bias).abs(),
                                    _f32(max_bias).abs()))
    return _to_int(torch.round(bias.to(torch.float32)
                               * (scale_b / out_scale)), torch.int32)


def _acc_range(out_scale):
    rng = out_scale * _INT32_SCALE
    return -rng, rng


@register("_contrib_quantized_fully_connected", num_outputs=3,
          differentiable=False,
          arg_names=("data", "weight", "bias", "min_data", "max_data",
                     "min_weight", "max_weight", "min_bias", "max_bias"))
def _quantized_fc(data, weight, bias, min_data, max_data, min_weight,
                  max_weight, min_bias=None, max_bias=None, num_hidden=1,
                  no_bias=False, flatten=True):
    """int8 × int8 -> int32 ``data · weightᵀ`` plus the requantized bias
    (reference ``quantized_fully_connected.cc``); outputs the accumulator
    and its float range."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    acc = _int_matmul(data.reshape(-1, data.shape[-1]), weight)
    acc = acc.reshape(tuple(lead) + (weight.shape[0],))
    out_scale = _out_scale(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        acc = acc + _bias_int32(bias, min_bias, max_bias, out_scale)
    return (acc,) + _acc_range(out_scale)


def _spatial(v, nd, default):
    if v is None or tuple(v) == ():
        return (default,) * nd
    return tuple(int(x) for x in v)


@register("_contrib_quantized_conv", num_outputs=3, differentiable=False,
          arg_names=("data", "weight", "bias", "min_data", "max_data",
                     "min_weight", "max_weight", "min_bias", "max_bias"))
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=(),
                    stride=(), dilate=(), pad=(), num_filter=1, num_group=1,
                    no_bias=False, layout="NCHW"):
    """int8 convolution accumulating exactly in int32
    (``quantized_conv.cc``); grouped and dilated as the float op, and
    channel-last through views as :func:`.nn._convolution` does."""
    from .nn import _channel_last, _to_first, _to_last
    nd = len(kernel)
    last = _channel_last(nd, layout)
    if last:
        data, weight = _to_first(data), _to_first(weight)
    acc = _int_conv(data, weight, _spatial(stride, nd, 1),
                    _spatial(pad, nd, 0), _spatial(dilate, nd, 1),
                    int(num_group))
    out_scale = _out_scale(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        q = _bias_int32(bias, min_bias, max_bias, out_scale)
        acc = acc + q.reshape((1, -1) + (1,) * nd)
    if last:
        acc = _to_last(acc)
    return (acc,) + _acc_range(out_scale)


@register("_contrib_quantized_pooling", num_outputs=3, differentiable=False,
          arg_names=("data", "min_data", "max_data"))
def _quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                       stride=(), pad=(), global_pool=False,
                       pooling_convention="valid", layout=None):
    """Pooling of int8 data in float32, converted back (toward zero); the
    range passes through (``quantized_pooling.cc``)."""
    out = get_op("Pooling").fn(
        data.to(torch.float32), kernel=kernel, pool_type=pool_type,
        stride=stride, pad=pad, global_pool=global_pool,
        pooling_convention=pooling_convention, layout=layout)
    out = out.to(data.dtype) if data.is_floating_point() \
        else _to_int(out, data.dtype)
    return out, min_data, max_data


@register("_contrib_quantized_flatten", num_outputs=3, differentiable=False,
          arg_names=("data", "min_data", "max_data"))
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_concat", num_outputs=3, differentiable=False)
def _quantized_concat(*args, dim=1, num_args=None):
    """Concatenate int8 inputs rescaled to the widest range
    (``quantized_concat.cc``); ``args`` are the n arrays, then each one's
    min and max."""
    n = len(args) // 3
    datas, ranges = args[:n], args[n:]
    amaxs = [torch.maximum(_f32(mn).abs(), _f32(mx).abs())
             for mn, mx in zip(ranges[0::2], ranges[1::2])]
    amax = amaxs[0]
    for a in amaxs[1:]:
        amax = torch.maximum(amax, a)
    scaled = [_to_int(torch.round(d.to(torch.float32) * (a / amax))
                      .clamp(-127, 127), torch.int8)
              for d, a in zip(datas, amaxs)]
    return torch.cat(scaled, dim=int(dim)), -amax, amax

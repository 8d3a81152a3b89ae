"""Shape-manipulation ops of the served graph and the vision zoo.

Counterpart of the ``Reshape``/``reshape``, ``Flatten``, ``transpose``,
``expand_dims``, ``slice_axis``, ``slice_like``, ``reshape_like``,
``Concat``, ``Pad``, ``depth_to_space``, ``space_to_depth`` and ``dot``
ops of ``mxnet_tpu/ops/matrix.py``
(reference ``src/operator/tensor/matrix_op.cc``). Views are returned where
PyTorch can give one; consumers that need contiguous memory make it so.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


def infer_reshape(src_shape, target, reverse=False):
    """MXNet reshape special codes (reference matrix_op.cc
    InferReshapeShape): 0 copy dim; -1 infer one dim; -2 copy all remaining
    dims; -3 merge next two source dims; -4 split a dim into the next two
    target values."""
    src = list(src_shape)
    tgt = list(target)
    if reverse:
        src, tgt = src[::-1], tgt[::-1]
    out = []
    si = ti = 0
    infer_idx = -1
    while ti < len(tgt):
        t = tgt[ti]
        if t == 0:
            out.append(src[si])
            si += 1
        elif t == -1:
            if infer_idx >= 0:
                raise MXNetError("reshape: at most one -1 allowed")
            infer_idx = len(out)
            out.append(1)
            si += 1 if si < len(src) else 0
        elif t == -2:
            out.extend(src[si:])
            si = len(src)
        elif t == -3:
            out.append(src[si] * src[si + 1])
            si += 2
        elif t == -4:
            d1, d2 = tgt[ti + 1], tgt[ti + 2]
            ti += 2
            cur = src[si]
            si += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
        else:
            out.append(t)
            if si < len(src):
                si += 1
        ti += 1
    known = math.prod(d for i, d in enumerate(out) if i != infer_idx)
    if infer_idx >= 0:
        out[infer_idx] = math.prod(src_shape) // max(known, 1)
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", aliases=["reshape"])
def _reshape(x, shape=None, reverse=False, target_shape=None,
             keep_highest=False):
    tgt = shape if shape is not None else target_shape
    return x.reshape(infer_reshape(tuple(x.shape), tgt,
                                   reverse=bool(reverse)))


@register("Flatten", aliases=["flatten"])
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def _transpose(x, axes=None):
    if axes is None or tuple(axes) == ():
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(*[int(a) for a in axes])


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(int(axis))


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    idx = [slice(None)] * x.ndim
    idx[int(axis)] = slice(begin, end)
    return x[tuple(idx)]


@register("slice_like")
def _slice_like(x, like, axes=()):
    axes = tuple(axes) if axes else tuple(range(min(x.ndim, like.ndim)))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[int(a)] = slice(0, like.shape[int(a)])
    return x[tuple(idx)]


@register("reshape_like")
def _reshape_like(x, like):
    return x.reshape(like.shape)


@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """Reduces the last axis of ``lhs`` with the first of ``rhs``
    (reference ``tensor/dot-inl.h``); ``transpose_*`` move a >2-D
    operand's first axis last (a), or its last axis first (b)."""
    if transpose_a:
        lhs = lhs.permute(*range(1, lhs.ndim), 0)
    if transpose_b:
        rhs = rhs.permute(rhs.ndim - 1, *range(rhs.ndim - 1))
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("Concat", aliases=["concat"])
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=int(dim))


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=["pad"])
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is (before, after) for every axis, flat. ``edge`` and
    ``reflect`` pad at most the last three axes, of an input with one or
    two more (the reference pads only the spatial axes of a 4-D or 5-D
    input)."""
    pairs = list(zip(pad_width[::2], pad_width[1::2]))
    if len(pairs) != x.ndim:
        raise MXNetError(f"Pad: pad_width {tuple(pad_width)} is not two "
                         f"values for each of {x.ndim} axes")
    padded = [i for i, p in enumerate(pairs) if any(p)]
    widths = [int(v) for lo, hi in reversed(pairs[padded[0]:])
              for v in (lo, hi)] if padded else []
    if mode == "constant":
        return F.pad(x, widths, value=float(constant_value))
    if mode not in _PAD_MODES:
        raise MXNetError(f"bad pad mode {mode}")
    k = len(widths) // 2
    if k and (k > 3 or x.ndim - k not in (1, 2)):
        raise MXNetError(f"Pad: {mode} pads at most the last three axes of "
                         f"an input with one or two more; got pad_width "
                         f"{tuple(pad_width)} on {x.ndim} axes")
    return F.pad(x, widths, mode=_PAD_MODES[mode]) if k else x


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)

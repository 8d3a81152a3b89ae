"""Shape-manipulation ops of the served graph and the vision zoo.

Counterpart of the ``Reshape``/``reshape``, ``Flatten``, ``transpose``,
``SwapAxis``/``swapaxes``, ``expand_dims``, ``squeeze``, ``slice_axis``,
``slice_like``, ``reshape_like``, ``Concat``, ``stack``,
``SliceChannel``/``split``, ``split_v2``, ``flip``/``reverse``, ``Pad``,
``depth_to_space``, ``space_to_depth``, ``dot``, ``batch_dot``,
``slice``/``crop``, ``tile``, ``repeat``, ``diag``, ``shape_array`` and
``size_array`` ops of ``mxnet_tpu/ops/matrix.py``
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


@register("SwapAxis", aliases=["swapaxes"])
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(int(dim1), int(dim2))


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(int(axis))


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return x.squeeze(tuple(int(a) for a in axes))


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


@register("stack")
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=int(axis))


def _parts(parts, axis, squeeze_axis):
    """A split's pieces (views), the split axis dropped with
    ``squeeze_axis``; one piece is returned alone."""
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("SliceChannel", aliases=["split"],
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal pieces along ``axis`` (it must divide)."""
    axis, n = int(axis), int(num_outputs)
    if x.shape[axis] % n:
        raise MXNetError(f"SliceChannel: axis {axis} of size "
                         f"{x.shape[axis]} does not split into {n} equal "
                         f"pieces")
    return _parts(torch.chunk(x, n, dim=axis), axis, squeeze_axis)


@register("split_v2", num_outputs=lambda a: (
    int(a["sections"]) if a.get("sections") else
    len(a.get("indices", ())) + 1))
def _split_v2(x, indices=(), axis=0, squeeze_axis=False, sections=0):
    """At the ``indices`` along ``axis``, or into ``sections`` equal
    pieces."""
    axis = int(axis)
    if sections:
        return _split(x, sections, axis, squeeze_axis)
    bounds = [0] + [int(i) for i in indices] + [x.shape[axis]]
    return _parts([x.narrow(axis, a, b - a) for a, b in
                   zip(bounds, bounds[1:])], axis, squeeze_axis)


@register("flip", aliases=["reverse"])
def _flip(x, axis=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, [int(a) for a in axes])


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


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
               forward_stype=None):
    """``matmul`` over the leading (batch) axes, the last two of an
    operand swapped with ``transpose_*``."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


def _axis_slice(x, axis, b, e, s):
    """``x`` sliced along ``axis`` as numpy slices it (a negative step
    gathers the indices, which torch's slicing does not take)."""
    if s > 0:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(b, e, s)
        return x[tuple(idx)]
    rows = range(*slice(b, e, s).indices(x.shape[axis]))
    return x.index_select(axis, torch.tensor(list(rows), dtype=torch.int64,
                                             device=x.device))


@register("slice", aliases=["crop"])
def _slice(x, begin=(), end=(), step=None):
    """``x[begin:end:step]`` over the leading ``len(begin)`` axes (None
    keeps an end open; a step of None or 0 is 1)."""
    step = tuple(step) if step else ()
    for axis, (b, e) in enumerate(zip(begin, end)):
        s = step[axis] if axis < len(step) and step[axis] not in (None, 0) \
            else 1
        x = _axis_slice(x, axis, b, e, int(s))
    return x


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(int(r) for r in reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    """Each entry ``repeats`` times along ``axis`` (of the flattened input
    without one)."""
    return torch.repeat_interleave(x, int(repeats),
                                   dim=None if axis is None else int(axis))


@register("diag")
def _diag(x, k=0, axis1=0, axis2=1):
    """A 1-D input's diagonal matrix; else the ``k``-th diagonal of the
    (``axis1``, ``axis2``) planes, as the last axis."""
    if x.ndim == 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, offset=int(k), dim1=int(axis1), dim2=int(axis2))


@register("shape_array", differentiable=False)
def _shape_array(x):
    """The shape as int64 (the JAX package runs with 64-bit types on)."""
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)

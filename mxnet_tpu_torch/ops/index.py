"""Indexing ops.

Counterpart of ``mxnet_tpu/ops/index.py``: ``take``, ``batch_take``,
``Embedding``, ``pick``, ``one_hot``, ``gather_nd``, ``scatter_nd``,
``_scatter_set_nd``, ``where``, ``boolean_mask``, ``SequenceMask``,
``SequenceLast``, ``SequenceReverse`` and ``unravel_index``/
``ravel_multi_index`` (reference ``src/operator/tensor/indexing_op.cc``,
``broadcast_reduce_op_index.cc``, ``ravel.cc``,
``sequence_{mask,last,reverse}.cc``).

Out-of-range indices follow the JAX package, not torch (which raises, or
asserts on the card): gathers clamp (a negative index counts from the
end first), ``one_hot`` gives a row of ``off_value``, and the scatters
drop the update. Indices arrive as floats and truncate toward zero.
A sequence op reads ``(seq, batch, ...)`` (``axis=0``) or ``(batch, seq,
...)`` (``axis=1``, ``SequenceMask`` and ``SequenceLast``); lengths
arrive as floats and truncate to integers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("Embedding", arg_names=("data", "weight"))
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    """Row gather. Ids arrive as floats (the predict ABI's wire type) and
    truncate toward zero like the JAX package's int32 cast; out-of-range ids
    clip to the table (``mode="clip"``), where ``F.embedding`` would raise.
    ``F.embedding`` on the clamped ids, because its CUDA backward sums the
    rows of repeated ids in a fixed order; ``index_select``'s backward is
    an ``index_add_`` whose atomics sum them in an order that changes from
    run to run."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("pick", arg_names=("data", "index"))
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s entry at ``index`` along ``axis``; indices truncate to
    integers and clip to the axis, as the JAX package's ``mode="clip"``.
    The index broadcasts to the data's shape on every axis but ``axis``
    (as ``take_along_axis`` broadcasts it); one that cannot raises."""
    ax = int(axis) % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1)
    if idx.ndim < data.ndim:
        idx = idx.unsqueeze(ax)
    shape = list(data.shape)
    shape[ax] = idx.shape[ax]
    try:
        idx = idx.expand(shape)
    except RuntimeError as e:
        raise MXNetError(f"pick: index of shape {tuple(index.shape)} does "
                         f"not broadcast to data {tuple(data.shape)} on "
                         f"axis {ax}") from e
    out = torch.gather(data, ax, idx)
    if keepdims:
        return out
    if out.shape[ax] != 1:
        raise MXNetError(f"pick: keepdims=False needs one index per row on "
                         f"axis {ax}, got {out.shape[ax]}")
    return out.squeeze(ax)


@register("where")
def _where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("SequenceMask", aliases=["sequence_mask"],
          arg_names=("data", "sequence_length"))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    ax = int(axis)
    pos = torch.arange(data.shape[ax], device=data.device)
    mask = pos[:, None] < sequence_length.to(torch.int64)[None, :]
    if ax == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=["sequence_last"],
          arg_names=("data", "sequence_length"))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    ax = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, -1)
    moved = data.movedim(ax, 0)
    last = sequence_length.to(torch.int64) - 1
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse", aliases=["sequence_reverse"],
          arg_names=("data", "sequence_length"))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Each sequence's valid steps reversed in place, the padding kept."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, [0])
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return data[src, torch.arange(data.shape[1], device=data.device)[None, :]]


def _clamped(idx, n):
    """Gather indices as JAX normalises them: a negative index counts from
    the end, then the index clamps to ``[0, n)``."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _in_range(idx, n):
    """Where an index (before ``_clamped``) lies in ``[-n, n)``."""
    return (idx >= -n) & (idx < n)


def _gathered(values, inside):
    """A gather's ``values`` whose gradient reaches the source only where
    its index was in range: JAX's gather clamps an out-of-range index,
    but its transpose, a scatter-add, drops that entry."""
    inside = inside.reshape(inside.shape + (1,) * (values.ndim - inside.ndim))
    return torch.where(inside, values, values.detach())


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    """``a``'s slices at ``indices`` along ``axis``; ``mode="wrap"`` takes
    the index modulo the axis, ``clip`` and ``raise`` clamp it (JAX cannot
    raise inside a program, so the JAX package clips)."""
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take")
def _batch_take(a, indices):
    """Row i's entry ``indices[i]`` of a 2-D ``a`` (the flat index
    normalised and clamped as a JAX gather does)."""
    flat = a.reshape(-1)
    offs = torch.arange(a.shape[0], device=a.device) * a.shape[1]
    pos = offs + indices.to(torch.int64).reshape(-1)
    return _gathered(flat[_clamped(pos, flat.shape[0])],
                     _in_range(pos, flat.shape[0]))


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """``on_value`` at each index's column, ``off_value`` elsewhere, and a
    whole row of ``off_value`` for an index outside ``[0, depth)``
    (``jax.nn.one_hot``; ``F.one_hot`` raises there). An integer
    ``dtype`` gives float64, as the JAX package's 64-bit promotion
    does."""
    from ..ndarray.ndarray import torch_dtype
    dt = torch_dtype(dtype)
    idx = indices.to(torch.int64).unsqueeze(-1)
    oh = (idx == torch.arange(int(depth), device=indices.device)).to(dt)
    if not dt.is_floating_point:
        oh = oh.to(torch.float64)
    return oh * (on_value - off_value) + off_value


@register("gather_nd")
def _gather_nd(data, indices):
    """``data`` at the index tuple of ``indices``' leading axis, each row
    normalised and clamped to its axis (the gradient of an out-of-range
    index dropped, as JAX's)."""
    idx = indices.to(torch.int64)
    rows = range(idx.shape[0])
    inside = torch.stack([_in_range(idx[i], data.shape[i]) for i in rows]) \
        .all(0)
    return _gathered(data[tuple(_clamped(idx[i], data.shape[i])
                                for i in rows)], inside)


def _scatter(target, indices, values):
    """``target`` with ``values`` written at the rows of ``indices``
    (negative indices count from the end; an update outside the target
    goes to a spare row that is cut off after, so it is dropped as JAX's
    ``.at[].set`` drops it, without a host sync). With repeated indices
    one of the writes is kept, which one is unspecified."""
    idx = indices.to(torch.int64)
    m = idx.shape[0]
    lead, rest = tuple(target.shape[:m]), tuple(target.shape[m:])
    total = math.prod(lead)
    flat = torch.zeros(idx.shape[1:], dtype=torch.int64, device=idx.device)
    ok = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for i, n in enumerate(lead):
        row = torch.where(idx[i] < 0, idx[i] + n, idx[i])
        ok &= (row >= 0) & (row < n)
        flat = flat * n + row
    flat = torch.where(ok, flat, total)
    padded = torch.cat([target.reshape((total,) + rest),
                        target.new_zeros((1,) + rest)])
    values = values.expand(idx.shape[1:] + rest).to(target.dtype)
    return padded.index_put((flat,), values)[:total].reshape(target.shape)


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None):
    return _scatter(torch.zeros(tuple(shape), dtype=data.dtype,
                                device=data.device), indices, data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    return _scatter(lhs, indices, rhs)


@register("boolean_mask", aliases=["_contrib_boolean_mask"])
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero.
    The output's shape depends on the data, so the mask is read on the
    host: legal imperatively only, as in the JAX package."""
    keep = torch.nonzero(index.detach().cpu() != 0).reshape(-1)
    return data.index_select(int(axis), keep.to(data.device))


@register("_unravel_index", aliases=["unravel_index"], differentiable=False)
def _unravel_index_op(data, shape=None):
    """Flat indices to coordinate rows, (ndim,) + data.shape, in the input's
    dtype; an index outside ``[-size, size)`` clamps to it first, as
    ``jnp.unravel_index`` does."""
    shape = tuple(int(s) for s in shape)
    strides, total = [], 1
    for s in reversed(shape):
        strides.append(total)
        total *= s
    x = data.to(torch.int64).clamp(-total, total - 1)
    coords = [torch.div(x, st, rounding_mode="floor") % s
              for s, st in zip(shape, reversed(strides))]
    return torch.stack(coords).to(data.dtype)


@register("_ravel_multi_index", aliases=["ravel_multi_index"],
          differentiable=False)
def _ravel_multi_index_op(data, shape=None):
    """Coordinate rows (ndim, n) to flat indices (n,), each coordinate
    clamped to its axis (``mode="clip"``), in the input's dtype."""
    shape = tuple(int(s) for s in shape)
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(shape):
        flat = flat * s + data[i].to(torch.int64).clamp(0, s - 1)
    return flat.to(data.dtype)

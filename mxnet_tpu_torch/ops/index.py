"""Indexing ops.

Counterpart of ``Embedding``, ``pick``, ``where`` and ``SequenceMask``,
``SequenceLast`` and ``SequenceReverse`` in ``mxnet_tpu/ops/index.py``
(reference ``src/operator/tensor/indexing_op.cc``,
``broadcast_reduce_op_index.cc``, ``sequence_{mask,last,reverse}.cc``).
A sequence op reads ``(seq, batch, ...)`` (``axis=0``) or ``(batch, seq,
...)`` (``axis=1``, ``SequenceMask`` and ``SequenceLast``); lengths
arrive as floats and truncate to integers.
"""
from __future__ import annotations

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

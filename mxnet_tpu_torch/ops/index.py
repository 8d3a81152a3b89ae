"""Indexing ops.

Counterpart of ``Embedding`` and ``pick`` in ``mxnet_tpu/ops/index.py``
(reference ``src/operator/tensor/indexing_op.cc``, ``broadcast_reduce_op_index.cc``).
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

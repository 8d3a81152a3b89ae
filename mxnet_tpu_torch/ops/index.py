"""Indexing ops.

Counterpart of ``Embedding`` and ``pick`` in ``mxnet_tpu/ops/index.py``
(reference ``src/operator/tensor/indexing_op.cc``, ``broadcast_reduce_op_index.cc``).
"""
from __future__ import annotations

import torch

from .registry import register


@register("Embedding", arg_names=("data", "weight"))
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    """Row gather. Ids arrive as floats (the predict ABI's wire type) and
    truncate toward zero like the JAX package's int32 cast; out-of-range ids
    clip to the table (``mode="clip"``), where ``F.embedding`` would raise."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(weight.shape[1:]))


@register("pick", arg_names=("data", "index"))
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s entry at ``index`` along ``axis``; indices truncate to
    integers and clip to the axis, as the JAX package's ``mode="clip"``."""
    ax = int(axis) % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1)
    if idx.ndim < data.ndim:
        idx = idx.unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)

"""Creation ops.

Counterpart of ``_zeros``/``zeros``, ``_ones``/``ones``, ``zeros_like`` and
``ones_like`` in ``mxnet_tpu/ops/init_ops.py`` (reference
``src/operator/tensor/init_op.cc``): what ``symbol.zeros`` (the symbolic
cells' ``begin_state``) and the zoneout cells call. An op without array
inputs takes its ``device`` from the caller: the current context
imperatively, the device of the graph's inputs in the executor.
"""
from __future__ import annotations

import torch

from .registry import register


def _full(shape, value, dtype, device):
    from ..ndarray.ndarray import torch_dtype
    return torch.full(tuple(shape), value,
                      dtype=torch_dtype(dtype or "float32"), device=device)


@register("_zeros", aliases=["zeros"], differentiable=False)
def _zeros(shape=(), dtype="float32", device=None):
    return _full(shape, 0.0, dtype, device)


@register("_ones", aliases=["ones"], differentiable=False)
def _ones(shape=(), dtype="float32", device=None):
    return _full(shape, 1.0, dtype, device)


register("zeros_like", differentiable=False)(lambda x: torch.zeros_like(x))
register("ones_like", differentiable=False)(lambda x: torch.ones_like(x))

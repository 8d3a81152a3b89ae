"""Broadcast ops of the served graph.

Counterpart of ``broadcast_add`` in ``mxnet_tpu/ops/broadcast_reduce.py``
(reference ``src/operator/tensor/elemwise_binary_broadcast_op_basic.cc``);
the rest of that module waits for the op-library slice.
"""
from __future__ import annotations

import torch

from .registry import register


@register("broadcast_add")
def _broadcast_add(lhs, rhs):
    return torch.add(lhs, rhs)

"""Broadcast binary ops and reductions.

Counterpart of ``broadcast_{add,sub,mul,div,power}``, ``sum`` and ``mean`` in
``mxnet_tpu/ops/broadcast_reduce.py`` (reference
``src/operator/tensor/elemwise_binary_broadcast_op_basic.cc``,
``broadcast_reduce_op_value.cc``); the rest of that module waits for the
op-library slice.
"""
from __future__ import annotations

import torch

from .registry import register


def _bcast(name, fn):
    register(name, arg_names=("lhs", "rhs"))(
        lambda lhs, rhs, _fn=fn: _fn(lhs, rhs))


_bcast("broadcast_add", torch.add)
_bcast("broadcast_sub", torch.sub)
_bcast("broadcast_mul", torch.mul)
_bcast("broadcast_div", torch.div)
_bcast("broadcast_power", torch.pow)


def _norm_axis(axis, ndim, exclude=False):
    """The reduced axes: all when ``axis`` is None or (), else ``axis``,
    or with ``exclude`` every axis but those (the JAX package's rule)."""
    if axis is None or axis == ():
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(int(a) % ndim for a in axes)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _reduce(name, fn):
    def op(x, axis=None, keepdims=False, exclude=False):
        axes = _norm_axis(axis, x.ndim, exclude)
        if not axes:
            return x
        return fn(x, dim=axes, keepdim=bool(keepdims))

    register(name)(op)


_reduce("sum", torch.sum)
_reduce("mean", torch.mean)

"""Broadcast binary ops and reductions.

Counterpart of ``broadcast_{add,sub,mul,div,mod,power}``, the
``broadcast_{equal,not_equal,greater,greater_equal,lesser,lesser_equal}``
comparisons, ``broadcast_to``, ``sum``, ``mean`` and
``L2Normalization`` in
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
_bcast("broadcast_mod", torch.remainder)     # jnp.mod: the divisor's sign


def _bcast_cmp(name, fn):
    """A comparison in the left operand's dtype (1 or 0), no gradient."""
    register(name, differentiable=False, arg_names=("lhs", "rhs"))(
        lambda lhs, rhs, _fn=fn: _fn(lhs, rhs).to(lhs.dtype))


_bcast_cmp("broadcast_equal", torch.eq)
_bcast_cmp("broadcast_not_equal", torch.ne)
_bcast_cmp("broadcast_greater", torch.gt)
_bcast_cmp("broadcast_greater_equal", torch.ge)
_bcast_cmp("broadcast_lesser", torch.lt)
_bcast_cmp("broadcast_lesser_equal", torch.le)


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    """A 0 in ``shape`` keeps that axis of ``x``."""
    return x.expand(tuple(s if t == 0 else t for s, t in zip(x.shape, shape)))


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


@register("L2Normalization")
def _l2_normalization(x, eps=1e-10, mode="instance"):
    """``x / sqrt(sum(x²) + eps)`` over every axis but the batch
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``); reference ``src/operator/l2_normalization.cc``."""
    if mode == "instance":
        ax = tuple(range(1, x.ndim))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, x.ndim))
    else:
        raise ValueError(f"bad L2Normalization mode {mode}")
    return x / torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True)
                          + float(eps))

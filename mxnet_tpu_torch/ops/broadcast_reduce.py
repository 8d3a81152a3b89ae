"""Broadcast binary ops and reductions.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py`` (reference
``src/operator/tensor/elemwise_binary_broadcast_op_basic.cc``,
``broadcast_reduce_op_value.cc``): every op it registers. ``max`` and
``min`` share a tied extreme's gradient equally among the ties, as XLA's
reduction does (``amax``/``amin``, not ``max(dim)``); ``norm`` is
``sqrt(sum(x²))``, so its gradient at an all-zero input is NaN, as the JAX
package's is; ``argmax``/``argmin`` return float32 indices of the first
extreme.
"""
from __future__ import annotations

import torch

from .registry import register


def _bcast(name, fn):
    register(name, arg_names=("lhs", "rhs"))(
        lambda lhs, rhs, _fn=fn: _fn(lhs, rhs))


_bcast("broadcast_add", torch.add)
_bcast("broadcast_plus", torch.add)
_bcast("broadcast_sub", torch.sub)
_bcast("broadcast_minus", torch.sub)
_bcast("broadcast_mul", torch.mul)
_bcast("broadcast_div", torch.div)
_bcast("broadcast_power", torch.pow)
_bcast("broadcast_mod", torch.remainder)     # jnp.mod: the divisor's sign
_bcast("broadcast_maximum", torch.maximum)   # a tie splits the gradient
_bcast("broadcast_minimum", torch.minimum)
_bcast("broadcast_hypot", torch.hypot)


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
_bcast_cmp("broadcast_logical_and",
           lambda lhs, rhs: torch.logical_and(lhs != 0, rhs != 0))
_bcast_cmp("broadcast_logical_or",
           lambda lhs, rhs: torch.logical_or(lhs != 0, rhs != 0))
_bcast_cmp("broadcast_logical_xor",
           lambda lhs, rhs: torch.logical_xor(lhs != 0, rhs != 0))


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    """A 0 in ``shape`` keeps that axis of ``x``."""
    return x.expand(tuple(s if t == 0 else t for s, t in zip(x.shape, shape)))


@register("broadcast_like")
def _broadcast_like(x, like, lhs_axes=None, rhs_axes=None):
    """``x`` broadcast to ``like``'s shape, or only its ``lhs_axes`` to the
    sizes of ``like``'s ``rhs_axes``."""
    if lhs_axes is None:
        return x.expand(like.shape)
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = like.shape[ra]
    return x.expand(tuple(tgt))


@register("broadcast_axis", aliases=["broadcast_axes"])
def _broadcast_axis(x, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt))


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


def _prod(x, dim, keepdim):
    """The product over several axes (``torch.prod`` takes one)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


_reduce("sum", torch.sum)
_reduce("mean", torch.mean)
_reduce("prod", _prod)
_reduce("max", torch.amax)
_reduce("min", torch.amin)
_reduce("nansum", torch.nansum)
_reduce("nanprod", _nanprod)


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False, out_dtype=None):
    """The L1 norm for ``ord=1``, else ``sqrt(sum(x²))``, over ``axis``
    (all axes when None)."""
    from ..ndarray.ndarray import torch_dtype
    dim = _norm_axis(axis, x.ndim) if axis is not None else \
        tuple(range(x.ndim))
    if int(ord) == 1:
        r = torch.sum(torch.abs(x), dim=dim, keepdim=bool(keepdims))
    else:
        r = torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                 keepdim=bool(keepdims)))
    return r.to(torch_dtype(out_dtype)) if out_dtype else r


def _arg_reduce(name, fn):
    def op(x, axis=None, keepdims=False):
        x = x.detach()
        if axis is None:
            return fn(x.reshape(-1), dim=0).to(torch.float32)
        return fn(x, dim=int(axis), keepdim=bool(keepdims)).to(torch.float32)

    register(name, differentiable=False)(op)


_arg_reduce("argmax", torch.argmax)
_arg_reduce("argmin", torch.argmin)


@register("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return torch.argmax(x.detach(), dim=1).to(torch.float32)


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

"""Elementwise unary and scalar ops.

Counterpart of ``abs``, ``negative``, ``square``, ``sigmoid``, ``tanh``,
``clip``, ``BlockGrad`` and the ``_*_scalar`` family
(``_power_scalar``, ``_rpower_scalar``, ``_mod_scalar`` and the
comparisons among them) in
``mxnet_tpu/ops/elemwise.py`` (reference
``src/operator/tensor/elemwise_unary_op_basic.cc``,
``elemwise_binary_scalar_op_basic.cc``): what NDArray and Symbol
arithmetic, gluon's losses and the vision zoo reach (``clip`` is
MobileNet v2's relu6) and the recurrent cells reach (``tanh``); the rest
waits for the op-library slice.
"""
from __future__ import annotations

import torch

from .registry import register

register("abs")(lambda x: torch.abs(x))
register("negative")(lambda x: torch.neg(x))
register("square")(lambda x: torch.square(x))
register("sigmoid")(lambda x: torch.sigmoid(x))
register("tanh")(lambda x: torch.tanh(x))


def _scalar_op(name, fn):
    register(name)(lambda x, scalar=0.0, _fn=fn: _fn(x, float(scalar)))


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar_op("_mod_scalar", lambda x, s: torch.remainder(x, s))
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(
    torch.full_like(x, s), x))


def _cmp_scalar(name, fn):
    """A comparison with the scalar, in ``x``'s dtype (1 or 0)."""
    register(name, differentiable=False)(
        lambda x, scalar=0.0, _fn=fn: _fn(x, float(scalar)).to(x.dtype))


_cmp_scalar("_equal_scalar", torch.eq)
_cmp_scalar("_not_equal_scalar", torch.ne)
_cmp_scalar("_greater_scalar", torch.gt)
_cmp_scalar("_greater_equal_scalar", torch.ge)
_cmp_scalar("_lesser_scalar", torch.lt)
_cmp_scalar("_lesser_equal_scalar", torch.le)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    """``jnp.clip``: bounds of None leave that side open."""
    return torch.clamp(x, a_min, a_max)


register("BlockGrad", aliases=["stop_gradient"])(lambda x: x.detach())

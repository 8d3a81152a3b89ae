"""Elementwise unary and scalar ops.

Counterpart of ``abs``, ``negative``, ``square``, ``sigmoid``, ``clip``,
``BlockGrad`` and the ``_*_scalar`` family (``_power_scalar`` and
``_rpower_scalar`` among them) in
``mxnet_tpu/ops/elemwise.py`` (reference
``src/operator/tensor/elemwise_unary_op_basic.cc``,
``elemwise_binary_scalar_op_basic.cc``): what NDArray and Symbol
arithmetic, gluon's losses and the vision zoo reach (``clip`` is
MobileNet v2's relu6); the rest waits for the op-library slice.
"""
from __future__ import annotations

import torch

from .registry import register

register("abs")(lambda x: torch.abs(x))
register("negative")(lambda x: torch.neg(x))
register("square")(lambda x: torch.square(x))
register("sigmoid")(lambda x: torch.sigmoid(x))


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


@register("clip")
def _clip(x, a_min=None, a_max=None):
    """``jnp.clip``: bounds of None leave that side open."""
    return torch.clamp(x, a_min, a_max)


register("BlockGrad", aliases=["stop_gradient"])(lambda x: x.detach())

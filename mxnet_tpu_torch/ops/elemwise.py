"""Elementwise unary and scalar ops.

Counterpart of ``negative``, ``square``, ``sigmoid`` and the ``_*_scalar`` family in
``mxnet_tpu/ops/elemwise.py`` (reference
``src/operator/tensor/elemwise_unary_op_basic.cc``,
``elemwise_binary_scalar_op_basic.cc``): what NDArray and Symbol
arithmetic and gluon's losses reach; the rest waits for the op-library
slice.
"""
from __future__ import annotations

import torch

from .registry import register

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

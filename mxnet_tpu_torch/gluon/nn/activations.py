"""Activation Gluon layers.

Counterpart of ``Activation`` in ``mxnet_tpu/gluon/nn/activations.py``
(reference ``python/mxnet/gluon/nn/activations.py``); the parametric and
LeakyReLU-family layers wait for the op-library slice.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

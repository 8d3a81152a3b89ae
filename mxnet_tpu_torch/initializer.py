"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
``python/mxnet/initializer.py``): an initializer is called with a
parameter's name and its tensor and fills the tensor in place, choosing
by the name's suffix (``weight``, ``bias``, ``gamma``, ``beta``, ...).
Random draws come from the explicit ``torch.Generator`` of the tensor's
device (:func:`mxnet_tpu_torch.random.generator`, reset by
``mx.random.seed``), on that device: the JAX package's host numpy stream
is not reproduced, so tests compare statistics.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .base import MXNetError
from .random import generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "register", "create"]

_INIT_REGISTRY: Dict[str, type] = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name, or None (the
    default ``Uniform``)."""
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform()
    key = str(name).lower()
    key = _ALIASES.get(key, key)
    if key not in _INIT_REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _INIT_REGISTRY[key](**kwargs)


class Initializer:
    """Base initializer; dispatches on the parameter name's suffix like the
    reference's InitDesc protocol."""

    def __call__(self, name: str, arr: torch.Tensor) -> None:
        self.init_weight_by_name(name, arr)

    def init_weight_by_name(self, name: str, arr: torch.Tensor) -> None:
        name = name.lower()
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(name, arr)
            elif name.endswith("bias"):
                self._init_bias(name, arr)
            elif name.endswith("gamma"):
                self._init_one(name, arr)
            elif name.endswith("beta"):
                self._init_zero(name, arr)
            elif name.endswith(("moving_mean", "running_mean")):
                self._init_zero(name, arr)
            elif name.endswith(("moving_var", "running_var")):
                self._init_one(name, arr)
            else:
                self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        arr.fill_(0.0)

    def _init_zero(self, name, arr):
        arr.fill_(0.0)

    def _init_one(self, name, arr):
        arr.fill_(1.0)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, name, arr):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.uniform_(-self.scale, self.scale, generator=generator(arr.device))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr.normal_(0.0, self.sigma, generator=generator(arr.device))


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor), factor the fan-in,
    the fan-out or their mean (reference ``initializer.py:Xavier``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / factor)
        gen = generator(arr.device)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=gen)
        else:
            arr.normal_(0.0, scale, generator=gen)

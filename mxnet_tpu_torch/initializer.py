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
import re
from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .random import generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "register", "create"]

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


@register
class Orthogonal(Initializer):
    """The orthonormal factor of a uniform or normal draw's SVD, times
    ``scale`` (reference ``initializer.py:Orthogonal``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=arr.device)
        gen = generator(arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class MSRAPrelu(Xavier):
    """He et al.'s normal draw for a PReLU of ``slope``: Xavier with
    magnitude 2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        n = math.prod(shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        arr.copy_(torch.from_numpy(weight.astype("float32"))
                  .reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (``[i, f, g, o]``) at
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr.fill_(0.0)
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias

    _init_bias = _init_weight


class Mixed(Initializer):
    """The initializer of the first pattern that matches the name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr)
                return
        raise MXNetError(f"no initializer pattern matches {name!r}")

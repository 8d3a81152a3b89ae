"""Optimizers: MXNet's update rules, not ``torch.optim``'s.

Counterpart of ``Optimizer``, ``SGD``, ``Adam``, ``Updater``,
``get_updater`` and ``create`` in ``mxnet_tpu/optimizer.py`` (reference
``python/mxnet/optimizer/optimizer.py`` and the fused kernels of
``src/operator/optimizer_op.cc``). The rules differ from torch's:

* SGD with momentum: ``m ← μ·m − lr·g; w ← w + m`` (torch folds lr in
  after the momentum: the two part ways when the learning rate changes);
* Adam: bias correction folded into ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)``, then
  ``w ← w − lr_t·m/(√v + ε)`` with ε not bias-corrected (torch adds ε to
  the corrected √v̂), ``t`` counted per parameter index;
* weight decay is added to the gradient (L2), ``g ← rescale·g (clipped) +
  wd·w``, in both.

Updates run in place under ``torch.no_grad()``: the weight tensor is the
autograd leaf that the next ``backward`` reaches, so it must not be
rebound. The JAX package rebinds immutable arrays instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "Updater",
           "get_updater"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}")
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, begin_num_update=0,
                 param_dict=None):
        if lr_scheduler is not None:
            raise NotImplementedError("lr_scheduler waits for a later slice "
                                      "of the port (ROADMAP A1)")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.param_dict = dict(param_dict or {})

    def set_learning_rate(self, lr: float) -> None:
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        return self.lr

    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index) -> float:
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def _grad(self, index, weight, grad) -> torch.Tensor:
        """``rescale·g``, clipped, plus ``wd·w``: a new float tensor."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        wd = self._get_wd(index)
        if wd:
            g.add_(weight._data, alpha=wd)
        return g

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (reference ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight._data.detach())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            if state is None:
                weight._data.sub_(g, alpha=lr)
            else:
                state.mul_(self.momentum).sub_(g, alpha=lr)
                weight._data.add_(state)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        w = weight._data.detach()
        return torch.zeros_like(w), torch.zeros_like(w)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        m, v = state
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            denom = v.sqrt().add_(self.epsilon)
            weight._data.sub_(m.mul(lr_t).div_(denom))


class Updater:
    """Applies an optimizer with per-index states."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

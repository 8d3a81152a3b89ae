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
  wd·w``, in both;
* an ``lr_scheduler`` (:mod:`.lr_scheduler`) gives the learning rate of
  each update from ``num_update``, as in the JAX package.

``Updater.get_states(dump_optimizer=True)`` pickles the states as numpy
arrays together with the optimizer (its per-index update counts,
``num_update`` and scheduler), as the reference's ``Trainer.save_states``
does, so that a resumed run takes the same steps as an uninterrupted one.
The JAX package's trainer saves the states without the optimizer
(``mxnet_tpu/gluon/trainer.py:149``): its resumed Adam restarts the
bias correction and the schedule. Its files pickle JAX arrays and do not
load here.

Updates run in place under ``torch.no_grad()``: the weight tensor is the
autograd leaf that the next ``backward`` reaches, so it must not be
rebound. The JAX package rebinds immutable arrays instead.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
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
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.param_dict = dict(param_dict or {})

    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is active; set lr on the "
                             "scheduler")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def __getstate__(self):
        # parameters are bound again by the trainer that loads the states
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d

    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        p = self.param_dict.get(index)
        return lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index) -> float:
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def _grad(self, index, weight, grad) -> torch.Tensor:
        """``rescale·g``, clipped, plus ``wd·w``: a new float tensor. A
        ``clip_gradient`` of 0 or None clips nothing, as in the JAX
        package."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient:
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


def _to_host(state):
    """A state (None, a tensor, or a tuple of them) with numpy arrays for
    tensors."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _to_device(state, device: torch.device):
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state).to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state


class Updater:
    """Applies an optimizer with per-index states. States loaded by
    :meth:`set_states` are numpy arrays until the index's next update
    moves them to its weight's device."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, False):
            self.states[index] = _to_device(self.states[index],
                                            weight._data.device)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def dump_states(self, f, dump_optimizer: bool = False) -> None:
        """Pickle the states (numpy arrays), with the optimizer if asked,
        into the open binary file ``f``."""
        host = {i: _to_host(s) for i, s in self.states.items()}
        pickle.dump((host, self.optimizer) if dump_optimizer else host, f,
                    protocol=pickle.HIGHEST_PROTOCOL)

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        import io
        buf = io.BytesIO()
        self.dump_states(buf, dump_optimizer)
        return buf.getvalue()

    def set_states(self, states) -> None:
        """Load what :meth:`get_states` wrote (bytes, or an open binary
        file); the optimizer too, where it was dumped. Unpickle only files
        this program wrote."""
        obj = pickle.loads(states) if isinstance(states, (bytes, bytearray)) \
            else pickle.load(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj
        self.states_synced = dict.fromkeys(self.states, False)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``): ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``1/batch_size`` and updates every
parameter whose ``grad_req`` is not ``null``, in place.

One card per process in this slice: ``kvstore`` ``"device"``, ``"local"``
or None means no store, which gives what the JAX package's single-process
store gives (a push and pull of one gradient returns it unchanged). Any
other store raises ``NotImplementedError``: multi-card reduction waits for
ROADMAP A8. ``save_states``/``load_states`` wait for a later slice.
"""
from __future__ import annotations

from typing import List

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_SINGLE_CARD_STORES = ("device", "local", None, "None")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list of "
                             "Parameters")
        if kvstore not in _SINGLE_CARD_STORES or compression_params \
                or update_on_kvstore:
            raise NotImplementedError(
                f"kvstore={kvstore!r} (and gradient compression or "
                f"update_on_kvstore): the port runs one card per process "
                f"in this slice; multi-card reduction waits for ROADMAP A8")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"expected Parameter, got {type(p)}")
            self._params.append(p)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._updater = opt_mod.get_updater(self._optimizer)

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Update with gradients rescaled by ``1/batch_size``."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                self._updater(i, p.grad, p.data())

"""BaseModule — the symbolic training loop.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``: ``fit``, ``score``, ``predict``,
``iter_predict``, ``forward_backward``). The JAX package's telemetry and
preemption hooks wait for the operational layers (ROADMAP A9).
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

import torch

from .. import metric as metric_mod
from ..ndarray.ndarray import NDArray

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _call_all(callbacks, *args) -> None:
    for cb in _as_list(callbacks):
        cb(*args)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------- high level
    def forward_backward(self, data_batch) -> None:
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Run ``eval_data`` forward (inference) and return the metric's
        ``[(name, value)]``."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score needs a bound module with parameters")
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                _call_all(batch_end_callback, BatchEndParam(
                    epoch, nbatch, eval_metric, locals()))
            actual += 1
        if score_end_callback is not None:
            _call_all(score_end_callback, BatchEndParam(
                epoch, actual, eval_metric, locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """Yield (outputs without the padding, batch index, batch)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("iter_predict needs a bound module with "
                               "parameters")
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            pad = batch.pad or 0
            yield ([NDArray(o._data[:o.shape[0] - pad])
                    for o in self.get_outputs()], nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Outputs over ``eval_data``, padding dropped, merged along the
        batch axis (or a list per batch)."""
        output_list = [outs for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list or not merge_batches:
            return output_list
        merged = [NDArray(torch.cat([o[i]._data for o in output_list]))
                  for i in range(len(output_list[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The training loop (reference ``base_module.py:409``): bind, init
        the parameters and the optimizer, then per epoch
        ``forward_backward`` + ``update`` + metric per batch, the
        callbacks, and ``score`` on ``eval_data``."""
        if num_epoch is None:
            raise ValueError("fit needs num_epoch")
        if monitor is not None:
            raise NotImplementedError("fit(monitor=...): the Monitor waits "
                                      "for the operational layers "
                                      "(ROADMAP A9)")
        from .. import initializer as init_mod
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or init_mod.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        validation_metric = validation_metric or eval_metric
        eval_metric = metric_mod.create(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    _call_all(batch_end_callback, BatchEndParam(
                        epoch, nbatch, eval_metric, locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            if epoch_end_callback is not None:
                _call_all(epoch_end_callback, epoch, self.symbol, arg_p,
                          aux_p)
            if eval_data is not None:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # ------------------------------------------------------------- interface
    @property
    def symbol(self):
        return self._symbol

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

"""BucketingModule — training on inputs of several shapes (buckets).

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``). ``sym_gen(bucket_key)``
gives each bucket its graph; every bucket's ``Module`` binds over the
default bucket's executor (``shared_module``), so all buckets hold one
storage for each parameter, gradient and auxiliary state, and one
optimizer. A parameter must have one shape in every bucket: a table sized
by the sequence length is declared at the largest bucket and sliced by the
graph (``slice_like``).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._buckets: Dict = {}
        self._curr_module: Module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module._symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    def _gen_module(self, bucket_key) -> Module:
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      group2ctxs=self._group2ctxs,
                      compression_params=self._compression_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket; the others bind at their first batch,
        over its arrays."""
        if self.binded and not force_rebind:
            return
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets = {self._default_bucket_key: module}
        self.binded = True
        self.for_training = for_training
        self._grad_req = grad_req
        self._inputs_need_grad = inputs_need_grad

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the current bucket, binding it over the
        default bucket's arrays at its first use (its parameters are then
        the default bucket's storages: nothing is copied)."""
        if not self.binded:
            raise MXNetError("switch_bucket needs bind() first")
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self._inputs_need_grad, shared_module=default,
                        grad_req=self._grad_req)
            module.params_initialized = self.params_initialized
            if self.optimizer_initialized:
                self._share_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def _share_optimizer(self, module) -> None:
        module._optimizer = self._curr_module._optimizer
        module._updater = self._curr_module._updater
        module._kvstore = self._curr_module._kvstore
        module.optimizer_initialized = True

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params, allow_missing,
                                     force_init, allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        """One optimizer (and its states) for every bucket."""
        self._curr_module.init_optimizer(**kwargs)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)

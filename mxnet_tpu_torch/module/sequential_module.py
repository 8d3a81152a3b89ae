"""SequentialModule — modules chained so that one's outputs feed the next.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference
``python/mxnet/module/sequential_module.py`` and ``python_module.py``).
Each module binds at the previous one's output shapes; only modules added
with ``take_labels=True`` receive the batch's labels; the backward runs
right to left, each interior module's input gradients
(``get_input_grads``) being the head gradients of the module before it.
"""
from __future__ import annotations

import logging
from typing import List

from ..base import MXNetError
from ..io.io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule", "PythonModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules: List[BaseModule] = []
        self._metas: List[dict] = []
        self._label_shapes = None

    def add(self, module: BaseModule, **kwargs) -> "SequentialModule":
        """Append ``module``; ``take_labels=True`` feeds it the labels,
        ``auto_wiring=True`` names its inputs after the previous module's
        outputs by position (the only wiring the chain does)."""
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    def get_params(self):
        if not self.params_initialized:
            raise MXNetError("get_params needs init_params()")
        arg_params, aux_params = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg_params.update(a)
            aux_params.update(x)
        return arg_params, aux_params

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule has no modules; call add()")
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            # an interior module hands its input gradients on, when there
            # is a backward at all
            need_grad = inputs_need_grad if i == 0 else for_training
            module.bind(cur_shapes, label_shapes if take_labels else None,
                        for_training=for_training,
                        inputs_need_grad=need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 == len(self._modules):
                break
            outs = getattr(module, "output_shapes", None)
            if outs is None:
                raise MXNetError("sub-module must expose output_shapes")
            data_names = self._modules[i + 1].data_names
            if len(data_names) != len(outs):
                raise MXNetError(
                    f"module {i} emits {len(outs)} outputs but module "
                    f"{i + 1} consumes {len(data_names)} inputs")
            cur_shapes = [(n, s) for n, (_, s) in zip(data_names, outs)]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if not self.binded:
            raise MXNetError("init_params needs bind() first")
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          force_init=force_init)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs bind() and init_params()")
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs bind() and init_params()")
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            takes = self._metas[i + 1].get(self.META_TAKE_LABELS)
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label if takes else None,
                              pad=data_batch.pad)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward needs bind() and init_params()")
        grads = out_grads
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=grads)
            if i > 0:
                grads = module.get_input_grads()

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer()")
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)


class PythonModule(BaseModule):
    """A module whose compute is Python (reference ``python_module.py``):
    subclasses implement ``forward``/``backward``; a loss or glue stage
    inside a ``SequentialModule``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, *a, **kw):
        self.params_initialized = True

    def init_optimizer(self, *a, **kw):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        pass

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes(data_shapes,
                                                          label_shapes)
        self.binded = True
        self.params_initialized = True

    def _compute_output_shapes(self, data_shapes, label_shapes):
        """Default: outputs mirror the data shapes one to one."""
        return [(n, s) for n, (_, s) in zip(
            self._output_names, [(d[0], d[1]) for d in data_shapes])]

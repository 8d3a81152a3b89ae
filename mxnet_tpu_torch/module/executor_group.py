"""DataParallelExecutorGroup: the Module's executor on its one context.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference
``python/mxnet/module/executor_group.py``). The JAX package holds one
logical executor and leaves devices to SPMD sharding; the port binds one
executor on one card. Several contexts, which the reference splits the
batch across, raise: data-parallel work across cards waits for ROADMAP A8.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(contexts) != 1:
            raise NotImplementedError(
                f"a Module over {len(contexts)} contexts: the port binds one "
                f"card per process; splitting the batch across cards waits "
                f"for ROADMAP A8")
        if shared_group is not None:
            raise NotImplementedError("shared_module (bucketing) waits for "
                                      "BucketingModule (ROADMAP A1)")
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        fixed = set(fixed_param_names or [])
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in label_shapes or []]
        if isinstance(grad_req, dict):
            raise MXNetError("Module.bind takes one grad_req for all "
                             "parameters")
        self.grad_req = {}
        for name in symbol.list_arguments():
            if name in fixed or name in self.label_names:
                self.grad_req[name] = "null"
            elif name in self.data_names:
                self.grad_req[name] = grad_req if inputs_need_grad else "null"
            else:
                self.grad_req[name] = grad_req if for_training else "null"
        shapes = {d.name: d.shape for d in data_shapes}
        shapes.update({d.name: d.shape for d in label_shapes or []})
        self.execs = [symbol.simple_bind(contexts[0], grad_req=self.grad_req,
                                         **shapes)]

    def forward(self, data_batch, is_train=None):
        kwargs = dict(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            kwargs.update(zip(self.label_names, data_batch.label))
        self.execs[0].forward(is_train=bool(is_train), **kwargs)

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return list(self.execs[0].outputs)

    def get_input_grads(self, merge_multi_context=True):
        ex = self.execs[0]
        return [ex.grad_dict.get(n) for n in self.data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self.label_names, labels or [])),
            dict(zip(self.symbol.list_outputs(), self.execs[0].outputs)))

    def get_params(self, arg_params, aux_params):
        """Copies of the bound parameters and auxiliary states."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name, arr in ex.aux_dict.items():
            aux_params[name] = arr.copy()

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

"""Module — a Symbol bound for training: bind, init, forward, backward,
update.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``). The graph runs through the port's
executor on one card (``gpu(0)`` unless ``context`` asks for the CPU: the
reference defaults to ``cpu()``); the optimizer is the port's
``optimizer.Updater``, MXNet's rules, indexed by parameter order as the
JAX package's kvstore indexes them. Graph passes (``passes=``) wait for
ROADMAP A9, a kvstore other than the local one for A8.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import Context, current_context
from ..executor import _copy_into
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]

_LOCAL_STORES = ("local", "device", None)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 passes=None):
        super().__init__(logger)
        if passes not in (None, False):
            raise NotImplementedError("Module(passes=...): the port has no "
                                      "graph passes yet (ROADMAP A9)")
        if group2ctxs or compression_params:
            raise NotImplementedError(
                "group2ctxs / compression_params: placement across cards "
                "and gradient compression wait for ROADMAP A8")
        if context is None:
            context = current_context()
        self._context = [context] if isinstance(context, Context) \
            else list(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params: Dict[str, NDArray] = {}
        self._aux_params: Dict[str, NDArray] = {}
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._data_shapes = self._label_shapes = None
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None   # a states file Module.load names

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint; its values win over the
        initializer at ``init_params`` after ``bind``."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    # ------------------------------------------------------------- binding
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        feed = {d.name: d.shape for d in self._data_shapes}
        feed.update({d.name: d.shape for d in self._label_shapes or []})
        _, outs, _ = self._symbol.infer_shape(**feed)
        return list(zip(self.output_names, outs))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the graph at these input shapes (``DataDesc``s or
        ``(name, shape)`` pairs). A rebind keeps the parameter values."""
        if self.binded and not force_rebind:
            return
        if self.params_initialized:
            self._arg_params, self._aux_params = self.get_params()
        self._data_shapes = _descs(self._data_names, data_shapes)
        self._label_shapes = _descs(self._label_names, label_shapes or [])
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, None, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad,
            shared_group=shared_module._exec_group if shared_module
            else None,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        self.binded = True
        self.for_training = for_training
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """Bind again at new input shapes, keeping the parameters (and the
        optimizer, whose states are indexed by parameter order)."""
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  force_rebind=True)

    # ------------------------------------------------------------- params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Set every parameter and auxiliary state: from ``arg_params`` /
        ``aux_params``, else from a loaded checkpoint, else by
        ``initializer`` (``Uniform(0.01)``)."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params needs bind() first")
        initializer = init_mod.create(initializer or init_mod.Uniform(0.01))
        ex = self._exec_group.execs[0]
        for names, given, loaded, arrays in (
                (self._param_names, arg_params or {}, self._arg_params,
                 ex.arg_dict),
                (self._aux_names, aux_params or {}, self._aux_params,
                 ex.aux_dict)):
            for name in names:
                src = given.get(name, loaded.get(name))
                if src is not None:
                    _copy_into(arrays[name], src)
                else:
                    initializer(name, arrays[name]._data)
        self._arg_params, self._aux_params = {}, {}
        self.params_initialized = True

    def get_params(self):
        """Copies of the (arg_params, aux_params) on the module's card."""
        arg, aux = {}, {}
        self._exec_group.get_params(arg, aux)
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            missing = [n for n in self._param_names
                       if n not in (arg_params or {})]
            if missing:
                raise MXNetError(f"missing parameters {missing}")
        self._exec_group.set_params(arg_params or {}, aux_params or {},
                                    allow_extra=allow_extra)
        self.params_initialized = True

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name or an ``Optimizer``) and its updater;
        ``rescale_grad`` defaults to 1/batch size, as in the reference."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs bind() and init_params()")
        if self.optimizer_initialized and not force_init:
            return
        if kvstore not in _LOCAL_STORES:
            raise NotImplementedError(
                f"kvstore={kvstore!r}: the port's Module updates on its one "
                f"card; other stores wait for ROADMAP A8")
        if isinstance(optimizer, str):
            kwargs = dict(optimizer_params or ())
            batch = self._data_shapes[0].shape[0] if self._data_shapes else 1
            kwargs.setdefault("rescale_grad", 1.0 / max(batch, 1))
            optimizer = opt_mod.create(optimizer, **kwargs)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ------------------------------------------------------------- exec
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs bind() and init_params()")
        if is_train is None:
            is_train = self.for_training
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward needs bind() and init_params()")
        self._exec_group.backward(out_grads)

    def update(self):
        """Apply the optimizer to every parameter that has a gradient, in
        parameter order (the reference's ``module.py:644``)."""
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer()")
        ex = self._exec_group.execs[0]
        for i, name in enumerate(self._param_names):
            grad = ex.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, ex.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    # ------------------------------------------------------------- checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, if asked,
        ``prefix-%04d.states``: the optimizer's states pickled with the
        optimizer itself (update counts, schedule), as the port's
        ``Trainer.save_states`` does, so a resumed run takes the steps an
        uninterrupted one would."""
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                self._updater.dump_states(f, dump_optimizer=True)

    def load_optimizer_states(self, fname):
        """Load what :meth:`save_checkpoint` wrote with the states (files
        this program wrote: they are pickles)."""
        with open(fname, "rb") as f:
            self._updater.set_states(f)
        self._optimizer = self._updater.optimizer


def _descs(names, shapes):
    """``DataDesc``s as given, or one per name from shapes or ``(name,
    shape)`` pairs (the module's names win, as in the JAX package)."""
    from ..io.io import DataDesc
    if shapes and hasattr(shapes[0], "name"):
        return list(shapes)
    return [DataDesc(n, tuple(s[1] if isinstance(s, tuple) and len(s) == 2
                              and isinstance(s[0], str) else s))
            for n, s in zip(names, shapes)]

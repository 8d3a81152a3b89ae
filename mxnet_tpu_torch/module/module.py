"""Module — a Symbol bound for training: bind, init, forward, backward,
update.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``). The graph runs through the port's
executor on one card (``gpu(0)`` unless ``context`` asks for the CPU: the
reference defaults to ``cpu()``); the optimizer is the port's
``optimizer.Updater``, MXNet's rules, indexed by parameter order. With a
store (``init_optimizer(kvstore="local")``, the default, or a
``KVStore``) the optimizer runs in the store, as in the JAX package:
``update`` pushes every gradient and pulls every weight back, and the
optimizer's states files go through the store. ``kvstore=None`` updates
the executor's weights directly. Stores across processes wait for
ROADMAP A8.

The graph-pass pipeline (:mod:`mxnet_tpu_torch.passes`) rewrites the
symbol at bind time, as in the JAX package: ``passes=None`` runs the
``MXNET_PASSES`` default, ``False`` none. The module keeps the original
symbol for checkpoints and shapes; only the executor binds the rewritten
graph. No variable is re-homed on this path (the parameter arrays,
``set_params`` and checkpoints keep the original shapes), so layout
rewrites are transposes, which the port runs as views.
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


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 passes=None):
        super().__init__(logger)
        from ..passes import resolve as _resolve_passes
        self._passes = _resolve_passes(passes)
        self._pass_result = None
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
        self._kvstore = None
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
        bind_symbol = self._run_passes()
        self._exec_group = DataParallelExecutorGroup(
            bind_symbol, self._context, None, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad,
            shared_group=shared_module._exec_group if shared_module
            else None,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            param_shapes=self._original_shapes(bind_symbol))
        self.binded = True
        self.for_training = for_training
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _run_passes(self):
        """The symbol the executor binds: the pipeline's rewrite of the
        module's symbol, or the symbol itself when passes are off or
        rewrote nothing. A pipeline that raises leaves the graph
        unrewritten, with a warning, as in the JAX package."""
        self._pass_result = None
        if self._passes is None:
            return self._symbol
        shapes = {d.name: tuple(d.shape) for d in self._data_shapes}
        shapes.update({d.name: tuple(d.shape)
                       for d in self._label_shapes or []})
        try:
            res = self._passes.run(self._symbol, shapes=shapes,
                                   input_vars=tuple(shapes),
                                   rehome_params=False)
        except Exception as e:
            self.logger.warning("graph-pass pipeline failed; binding the "
                                "unrewritten graph: %r", e)
            return self._symbol
        if res.total_rewrites == 0:
            return self._symbol
        self._pass_result = res
        return res.symbol

    def _original_shapes(self, bind_symbol):
        """The variables' shapes in the module's own graph, for binding a
        rewrite of it: the names are the same (nothing is re-homed here),
        and the rewrite may hide a weight's shape from the data's (the
        space-to-depth stem's weight behind its pad and reshapes, where the
        JAX package's bind fails)."""
        if bind_symbol is self._symbol:
            return None
        feed = {d.name: tuple(d.shape) for d in self._data_shapes}
        feed.update({d.name: tuple(d.shape)
                     for d in self._label_shapes or []})
        arg, _, aux = self._symbol.infer_shape(**feed)
        shapes = dict(zip(self._symbol.list_arguments(), arg))
        shapes.update(zip(self._symbol.list_auxiliary_states(), aux))
        return {k: v for k, v in shapes.items()
                if v is not None and k not in feed}

    def passes_provenance(self):
        """The pipeline's names and rewrite counts (one schema with
        ``DataParallelTrainer``: ``passes.manager.provenance``)."""
        from ..passes import provenance
        return provenance(self._passes, self._pass_result)

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
        ``rescale_grad`` defaults to 1/batch size, as in the reference.
        ``kvstore`` (a type name or a ``KVStore``) gets the optimizer and
        a copy of every parameter, keyed by parameter order."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs bind() and init_params()")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            kwargs = dict(optimizer_params or ())
            batch = self._data_shapes[0].shape[0] if self._data_shapes else 1
            kwargs.setdefault("rescale_grad", 1.0 / max(batch, 1))
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **kwargs)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._kvstore = None
        if kvstore:
            from .. import kvstore as kv_mod
            kv = kv_mod.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            kv.set_optimizer(optimizer)
            ex = self._exec_group.execs[0]
            for i, name in enumerate(self._param_names):
                kv.init(i, ex.arg_dict[name])
            self._kvstore = kv
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
        parameter order (the reference's ``module.py:644``): through the
        store, every push and then every pull, or directly."""
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer()")
        ex = self._exec_group.execs[0]
        live = [(i, name, ex.grad_dict[name])
                for i, name in enumerate(self._param_names)
                if ex.grad_dict.get(name) is not None]
        if self._kvstore is not None:
            for i, _, grad in live:
                self._kvstore.push(i, grad, priority=-i)
            for i, name, _ in live:
                self._kvstore.pull(i, ex.arg_dict[name], priority=-i)
        else:
            for i, name, grad in live:
                self._updater(i, grad, ex.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        self._exec_group.install_monitor(mon)

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
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def _states_updater(self):
        """The updater that holds the optimizer's states: the store's
        where the optimizer runs in a store."""
        if self._kvstore is not None:
            self._kvstore._flush()
            return self._kvstore._raw_updater
        return self._updater

    def save_optimizer_states(self, fname):
        """The optimizer's states pickled with the optimizer itself
        (update counts, schedule)."""
        with open(fname, "wb") as f:
            self._states_updater().dump_states(f, dump_optimizer=True)

    def load_optimizer_states(self, fname):
        """Load what :meth:`save_optimizer_states` wrote (files this
        program wrote: they are pickles)."""
        updater = self._states_updater()
        with open(fname, "rb") as f:
            updater.set_states(f)
        self._optimizer = updater.optimizer


def _descs(names, shapes):
    """``DataDesc``s as given, or one per name from shapes or ``(name,
    shape)`` pairs (the module's names win, as in the JAX package)."""
    from ..io.io import DataDesc
    if shapes and hasattr(shapes[0], "name"):
        return list(shapes)
    return [DataDesc(n, tuple(s[1] if isinstance(s, tuple) and len(s) == 2
                              and isinstance(s[0], str) else s))
            for n, s in zip(names, shapes)]

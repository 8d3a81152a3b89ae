"""Gluon Block and HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): name scopes that give parameters the JAX
package's names, parameter collection and initialization, and the
hybridize/export contract.

PyTorch runs eagerly: a hybridized block runs the same ``hybrid_forward``
with ``F = mx.nd``, op by op, and torch autograd records it under
``autograd.record()``. The first call after ``hybridize()`` also traces
``hybrid_forward`` once with ``F = mx.sym`` to a
:class:`~mxnet_tpu_torch.symbol.Symbol` (only the outermost hybridized
block of a call traces), which :meth:`HybridBlock.export` writes.
:class:`CachedOp` runs a Symbol graph with a map of parameters through the
executor's graph interpreter, and :class:`SymbolBlock` wraps one (an
exported file, through :meth:`SymbolBlock.imports`) as a block.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp"]


class _BlockScope:
    """Hierarchical name manager (reference ``block.py:_BlockScope``)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _static_name(hint) + "_"
            return prefix, ParameterDict(prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        prefix = current._block.prefix + prefix
        parent_params = current._block._params
        return prefix, ParameterDict(prefix, params if params is not None
                                     else parent_params._shared)

    def __enter__(self):
        # a block made with prefix="" is transparent: its children name
        # themselves in the parent's scope
        if getattr(self._block, "_empty_prefix", False):
            return self
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if getattr(self._block, "_empty_prefix", False):
            return False
        _BlockScope._current.value = self._old
        return False


_global_counter: Dict[str, int] = {}


def _static_name(hint: str) -> str:
    i = _global_counter.get(hint, 0)
    _global_counter[hint] = i + 1
    return f"{hint}{i}"


class Block:
    """Base class for all layers and models."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        hint = type(self).__name__.lower()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: Dict[str, Parameter] = {}
        self._forward_hooks: List = []
        self._forward_pre_hooks: List = []

    # ------------------------------------------------------------- naming
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    def name_scope(self) -> _BlockScope:
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    # ------------------------------------------------------------- children
    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.__dict__.setdefault("_children", OrderedDict())[name] = value
        elif isinstance(value, Parameter):
            self.__dict__.setdefault("_reg_params", {})[name] = value
        super().__setattr__(name, value)

    def register_child(self, block: "Block",
                       name: Optional[str] = None) -> None:
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook) -> None:
        """``hook(block, inputs, output)`` after every call."""
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook) -> None:
        """``hook(block, inputs)`` before every call."""
        self._forward_pre_hooks.append(hook)

    def collect_params(self) -> ParameterDict:
        """This block's and its children's parameters, own first, in
        registration order."""
        params = ParameterDict(self._params.prefix)
        for p in self._reg_params.values():
            params._params[p.name] = p
        for child in self._children.values():
            params.update(child.collect_params())
        return params

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as _init
        self.collect_params().initialize(init or _init.Uniform(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype) -> None:
        """Hold every parameter (this block's and its children's) in
        ``dtype``."""
        for child in self._children.values():
            child.cast(dtype)
        for p in self.collect_params().values():
            p.cast(dtype)

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this block;
        returns this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def summary(self, *inputs):
        """Call the block on ``inputs``, print its parameter count (the
        JAX package's one line) and return the output."""
        out = self(*inputs)
        n_params = sum(int(np.prod(p.shape))
                       for p in self.collect_params().values() if p.shape)
        print(f"{type(self).__name__}: {n_params} parameters")
        return out

    # ------------------------------------------------------------- files
    def _collect_params_with_prefix(self, prefix: str = ""
                                    ) -> Dict[str, Parameter]:
        """Structural names (``body.layers.0.ln1.gamma``), independent of
        name scopes: the reference's ``save_parameters`` keys, which the
        JAX package's files use too."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename: str, deduplicate: bool = False
                        ) -> None:
        """Write the values under their structural names in the
        ``MXTPU001`` container; either package loads the file."""
        from ..ndarray import save as nd_save
        nd_save(filename, {k: p.data() for k, p in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current") -> None:
        """Set the parameters from a :meth:`save_parameters` file of
        either package, copying in place (a parameter with deferred
        initialization takes the file's shape)."""
        from .parameter import _load_host, _set_from
        _set_from(self._collect_params_with_prefix(), _load_host(filename),
                  filename, ctx, allow_missing, ignore_extra)

    # the reference's older spellings
    save_params = save_parameters

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False) -> None:
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    # ------------------------------------------------------------- exec
    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)


class CachedOp:
    """A Symbol graph as a callable on NDArrays (the JAX package's
    ``block.py:266-345``; reference ``src/imperative/cached_op.cc``).
    ``param_map`` maps graph input names to :class:`Parameter` s; the other
    inputs are ``data_names`` (by default in the graph's order), given
    positionally in that order. A call runs the graph through the
    executor's interpreter, lowered once for training and once for
    inference (``autograd.is_training()`` picks), recorded by torch
    autograd under ``autograd.record()``; in training the moving statistics
    it computes are written into their parameters. ``flags`` are accepted
    (an eager runtime has nothing to cache)."""

    def __init__(self, sym, param_map: Dict[str, Parameter], flags=None,
                 data_names=None):
        self._sym = sym
        self._param_map = dict(param_map)
        if data_names is not None:
            self._data_names = list(data_names)
        else:
            self._data_names = [n.name for n in sym.topo_nodes()
                                if n.is_var and n.name not in param_map]
        self._lowerings: Dict[bool, object] = {}

    def __call__(self, *args):
        """``args``: the data arrays in ``data_names`` order."""
        import torch
        from ..executor import _GraphLowering
        if len(args) != len(self._data_names):
            raise MXNetError(f"CachedOp expects {len(self._data_names)} "
                             f"inputs ({self._data_names}), got {len(args)}")
        is_train = autograd.is_training()
        if is_train not in self._lowerings:
            self._lowerings[is_train] = _GraphLowering(self._sym).lower(
                is_train)
        feed = {n: a._data for n, a in zip(self._data_names, args)}
        feed.update({n: p.data()._data for n, p in self._param_map.items()})
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, aux_updates = self._lowerings[is_train](feed)
        with torch.no_grad():
            for name, val in aux_updates.items():
                p = self._param_map.get(name)
                if p is not None:
                    p.data()._data.copy_(val)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs


# set while an outer hybridized block runs, so inner ones do not trace
_tracing = threading.local()


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, ...)`` runs on NDArrays (``F =
    mx.nd``) or builds a graph (``F = mx.sym``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._graph = None              # the traced Symbol, for export()
        self._graph_params: Dict[str, Parameter] = {}

    def hybridize(self, active: bool = True, **flags):
        """Mark the block (and its children) hybridized; the
        ``static_alloc``-style flags of the reference mean nothing to an
        eager runtime and are accepted."""
        self._active = active
        self._graph = None
        super().hybridize(active, **flags)

    def cast(self, dtype) -> None:
        """Drop the traced graph, then cast (the JAX package drops its
        cached program first)."""
        self._graph = None
        super().cast(dtype)

    # ------------------------------------------------------------- tracing
    def _trace_symbol(self, n_inputs: int):
        from .. import symbol as sym
        data_syms = [sym.Variable(f"data{i}" if n_inputs > 1 else "data")
                     for i in range(n_inputs)]
        params = {n: p.var() for n, p in self._reg_params.items()}
        with autograd.pause():
            out = self.hybrid_forward(sym, *data_syms, **params)
        if isinstance(out, (list, tuple)):
            out = sym.Group(list(out))
        return out, data_syms

    def _deferred_infer_shape(self, flat_args):
        """Finish deferred initialization from a symbolic trace and the
        input shapes."""
        from ..executor import _GraphLowering
        out_sym, data_syms = self._trace_symbol(len(flat_args))
        known = {s.name: tuple(a.shape) for s, a in zip(data_syms, flat_args)}
        pmap = {p.name: p for p in self.collect_params().values()}
        known.update({n: p.shape for n, p in pmap.items()
                      if p._shape_known()})
        shapes = _GraphLowering(out_sym).infer_shapes(known)
        for name, p in pmap.items():
            if p._deferred_init is not None and name in shapes:
                p._finish_deferred_init(shapes[name])

    # ------------------------------------------------------------- forward
    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._forward_nd(x, *args)
            except DeferredInitializationError:
                self._deferred_infer_shape(
                    [x] + [a for a in args if isinstance(a, NDArray)])
                return self._forward_nd(x, *args)
        # symbolic composition: net(sym.Variable("data"))
        from .. import symbol as sym_mod
        params = {n: p.var() for n, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, x, *args, **params)

    def _forward_nd(self, x, *args):
        from .. import ndarray as nd_mod
        params = {n: p.data() for n, p in self._reg_params.items()}
        outer = not getattr(_tracing, "active", False)
        if self._active and self._graph is None and outer:
            flat = [x] + [a for a in args if isinstance(a, NDArray)]
            graph, _ = self._trace_symbol(len(flat))
            used = {n.name for n in graph.topo_nodes() if n.is_var}
            self._graph_params = {p.name: p
                                  for p in self.collect_params().values()
                                  if p.name in used}
            self._graph = graph
        if not outer:
            return self.hybrid_forward(nd_mod, x, *args, **params)
        _tracing.active = self._active
        try:
            return self.hybrid_forward(nd_mod, x, *args, **params)
        finally:
            _tracing.active = False

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # ------------------------------------------------------------- export
    def export(self, path: str, epoch: int = 0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` for the
        predictor and ``ModelServer``. Each parameter's key is prefixed
        ``arg:`` or ``aux:`` by where the traced graph lists it
        (``list_arguments`` / ``list_auxiliary_states``), not by its
        ``grad_req``: a ``Constant`` such as the positional table is an
        argument of the graph."""
        from ..ndarray import save as nd_save
        if not self._active or self._graph is None:
            raise MXNetError("export requires hybridize() and at least one "
                             "forward call")
        sym_file = f"{path}-symbol.json"
        self._graph.save(sym_file)
        aux = set(self._graph.list_auxiliary_states())
        params = {("aux:" if name in aux else "arg:") + name: p.data()
                  for name, p in self._graph_params.items()}
        param_file = f"{path}-{epoch:04d}.params"
        nd_save(param_file, params)
        return sym_file, param_file


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block (reference ``gluon/block.py:SymbolBlock``,
    the JAX package's ``block.py:482-541``). Every input of ``outputs``
    that is not one of ``inputs`` becomes a parameter under its graph name
    (no prefix); auxiliary states take ``grad_req="null"``, as in the
    reference. Called on NDArrays it runs the graph as a :class:`CachedOp`
    (recorded under ``autograd.record()``, updating the moving statistics
    in training); called on Symbols it returns the graph
    with its inputs replaced by them, which is how
    ``parallel.DataParallelTrainer`` traces it."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        from .. import symbol as sym_mod
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sym_outputs = outputs
        self._input_names_ordered = [s.name for s in inputs]
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name not in self._input_names_ordered:
                self._reg_params[name] = self.params.get(
                    name, allow_deferred_init=True,
                    grad_req="null" if name in aux else "write")
        self._set_values(params or {}, None)
        self._cached_op = CachedOp(outputs, self._reg_params,
                                   data_names=self._input_names_ordered)

    def _set_values(self, values, ctx) -> None:
        """Give each parameter named in ``values`` that value, on ``ctx``
        (the current context by default); other names are ignored."""
        for name, v in values.items():
            p = self._reg_params.get(name)
            if p is not None:
                p.shape = tuple(v.shape)
                p.initialize(ctx=ctx)
                p.set_data(v)

    @staticmethod
    def imports(symbol_file: str, input_names, param_file=None, ctx=None):
        """A block over ``symbol_file`` (graph JSON) with ``input_names`` as
        its inputs and the values of ``param_file`` (``arg:``/``aux:``
        prefixes stripped), loaded through the host onto ``ctx`` (the card,
        ``gpu(0)``, unless the caller asks for the CPU)."""
        from .. import symbol as sym_mod
        from .parameter import _load_host
        graph = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(graph, [sym_mod.Variable(n) for n in input_names])
        if param_file:
            block._set_values({k.split(":", 1)[-1]: v for k, v in
                               _load_host(param_file).items()}, ctx)
        return block

    def _trace_symbol(self, n_inputs):
        from .. import symbol as sym_mod
        return self._sym_outputs, [sym_mod.Variable(n)
                                   for n in self._input_names_ordered]

    def forward(self, x, *args):
        inputs = [x] + list(args)
        if not isinstance(x, NDArray):
            return self._sym_outputs._compose(
                {n: s._outputs[0] for n, s in
                 zip(self._input_names_ordered, inputs)})
        if any(p._data is None for p in self._reg_params.values()):
            self._deferred_infer_shape(inputs)
        return self._cached_op(*inputs)

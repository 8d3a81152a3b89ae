"""Gluon Block and HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): name scopes that give parameters the JAX
package's names, parameter collection and initialization, and the
hybridize/export contract.

PyTorch runs eagerly, so there is no ``CachedOp``: a hybridized block runs
the same ``hybrid_forward`` with ``F = mx.nd``, op by op, and torch
autograd records it under ``autograd.record()``. The first call after
``hybridize()`` also traces ``hybrid_forward`` once with ``F = mx.sym`` to
a :class:`~mxnet_tpu_torch.symbol.Symbol` (only the outermost hybridized
block of a call traces), which :meth:`HybridBlock.export` writes.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


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

    # ------------------------------------------------------------- exec
    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)


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

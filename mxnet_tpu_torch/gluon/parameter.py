"""Gluon Parameter, Constant and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
``python/mxnet/gluon/parameter.py``). A parameter's value is an NDArray on
its context whose tensor is a torch leaf: with ``grad_req`` ``write`` or
``add`` it is an autograd variable with a gradient buffer, with ``null`` it
takes no gradient. The optimizer updates the tensor in place, so the leaf
that the next ``backward`` reaches stays the same tensor.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import autograd, initializer
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray, array as nd_array, torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's value is asked for before its shape is
    known."""


class Parameter:
    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0, wd_mult: float = 1.0,
                 init=None, allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data: Optional[NDArray] = None
        self._deferred_init = None  # (init, ctx) pending the shape
        self._ctx: Optional[Context] = None

    # ------------------------------------------------------------- lifecycle
    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        self._grad_req = req
        if self._data is not None:
            self._attach()

    def _attach(self) -> None:
        """Mark the value as a variable by ``grad_req`` (``null``: no
        gradient buffer, no torch grad)."""
        if self._grad_req == "null":
            autograd.mark_variables([self._data], [None], "null")
        else:
            self._data.attach_grad(self._grad_req)

    def _shape_known(self) -> bool:
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None,
                   default_init=initializer.Uniform(),
                   force_reinit: bool = False) -> None:
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]   # one card per process in this slice
        self._ctx = ctx
        chosen = init or self.init or default_init
        if not self._shape_known():
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"cannot initialize parameter {self.name!r}: shape "
                    f"unknown ({self.shape}); set allow_deferred_init=True "
                    f"or provide shape")
            self._deferred_init = (chosen, ctx)
            return
        self._finish_init(chosen, ctx)

    def _finish_init(self, init, ctx) -> None:
        """Fill a new value by ``init``. A channel-last conv weight
        (``_init_perm`` set by its layer) is drawn in the channel-first
        axis order and permuted, so that the initializer's fan-in and
        fan-out are its channel-first twin's."""
        perm = getattr(self, "_init_perm", None)
        canon = self.shape if perm is None else tuple(
            self.shape[perm.index(i)] for i in range(len(perm)))
        t = torch.empty(canon, dtype=torch_dtype(self.dtype),
                        device=ctx.torch_device())
        initializer.create(init)(self.name, t)
        if perm is not None:
            t = t.permute(*perm).contiguous()
        self._data = NDArray(t)
        self._attach()
        self._deferred_init = None

    def _finish_deferred_init(self, shape) -> None:
        if self._deferred_init is None:
            return
        self.shape = tuple(shape)
        init, ctx = self._deferred_init
        self._finish_init(init, ctx)

    # ------------------------------------------------------------- accessors
    def data(self, ctx=None) -> NDArray:
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name!r} has deferred init; the first "
                    f"forward must infer its shape")
            raise MXNetError(f"parameter {self.name!r} is not initialized")
        return self._data

    @property
    def grad(self) -> NDArray:
        d = self.data()
        if d._grad is None:
            raise MXNetError(f"parameter {self.name!r} has grad_req='null'")
        return d._grad

    def set_data(self, data) -> None:
        """Copy ``data`` into the value in place (the tensor stays the
        autograd leaf); a value of another shape replaces it."""
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError(f"parameter {self.name!r} is not "
                                 f"initialized")
            self.shape = tuple(data.shape)
            init, ctx = self._deferred_init
            self._finish_init(init, ctx)
        src = data._data if isinstance(data, NDArray) else \
            nd_array(np.asarray(data), ctx=self._data.context)._data
        dst = self._data._data
        if tuple(src.shape) == tuple(dst.shape):
            with torch.no_grad():
                dst.copy_(src)
        else:
            self._data._set_data(src.detach().to(dst.dtype))
            self.shape = tuple(src.shape)
            self._attach()

    def cast(self, dtype) -> None:
        """Hold the value (and its gradient) in ``dtype`` from now on."""
        self.dtype = dtype
        if self._data is not None:
            self._data._set_data(
                self._data._data.detach().to(torch_dtype(dtype)))
            self._attach()

    def zero_grad(self) -> None:
        if self._data is not None and self._data._grad is not None:
            self._data._grad._data.zero_()

    def var(self):
        from .. import symbol as sym
        return sym.Variable(self.name, shape=self.shape, dtype=self.dtype)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


class Constant(Parameter):
    """A parameter with a fixed value and no gradient."""

    def __init__(self, name, value):
        value = np.asarray(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value.dtype),
                         init=initializer.Constant(0.0))
        self._value = value

    def _finish_init(self, init, ctx):
        self._data = nd_array(self._value, ctx=ctx)
        self._deferred_init = None


class ParameterDict:
    """Name-scoped dictionary of parameters with a shared prefix."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self) -> str:
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, name: str) -> Parameter:
        return self._params[name]

    def __contains__(self, name) -> bool:
        return name in self._params

    def get(self, name: str, **kwargs) -> Parameter:
        """Get or create ``prefix + name``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None and param.shape is not None:
                    v = tuple(v)
                    if v != param.shape and all(s > 0 for s in param.shape):
                        raise MXNetError(f"parameter {full!r} shape "
                                         f"mismatch: {param.shape} vs {v}")
                    continue
                if getattr(param, k, None) in (None, "float32") \
                        and v is not None and k in ("shape", "dtype", "init"):
                    setattr(param, k, v)
        return param

    def get_constant(self, name: str, value=None) -> Constant:
        full = self._prefix + name
        p = self._get_impl(full)
        if p is None:
            p = Constant(full, value)
            self._params[full] = p
        return p

    def _get_impl(self, full_name):
        if full_name in self._params:
            return self._params[full_name]
        if self._shared is not None:
            p = self._shared._get_impl(full_name)
            if p is not None:
                self._params[full_name] = p
            return p
        return None

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k!r}")
            self._params[k] = v

    def initialize(self, init=initializer.Uniform(), ctx=None,
                   verbose=False, force_reinit=False) -> None:
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def save(self, fname: str, strip_prefix: str = "") -> None:
        """Write every value to ``fname`` in the ``MXTPU001`` container
        (``nd.save``), keyed by name less ``strip_prefix``."""
        from ..ndarray import save as nd_save
        nd_save(fname, {(name[len(strip_prefix):]
                         if name.startswith(strip_prefix) else name): p.data()
                        for name, p in self.items()})

    def load(self, fname: str, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="") -> None:
        """Set every parameter from ``fname`` (read on the host, copied in
        place), keyed by ``restore_prefix`` + the file's names."""
        loaded = {restore_prefix + k: v for k, v in _load_host(fname).items()}
        _set_from(self._params, loaded, fname, ctx, allow_missing,
                  ignore_extra)

    def __repr__(self):
        lines = "\n".join(f"  {p!r}" for p in self.values())
        return f"ParameterDict(prefix={self._prefix!r}\n{lines})"


def _load_host(fname: str):
    """``nd.load`` onto the host: the values are copied into the
    parameters one at a time, so no second copy of the model is made on
    the card."""
    from ..context import cpu
    from ..ndarray import load as nd_load
    loaded = nd_load(fname, ctx=cpu())
    if not isinstance(loaded, dict):
        raise MXNetError(f"{fname}: holds a list of arrays, not named "
                         f"parameters")
    return loaded


def _set_from(params, loaded, fname, ctx, allow_missing, ignore_extra):
    """Set each of ``params`` ({name: Parameter}) from ``loaded``."""
    for name, p in params.items():
        if name in loaded:
            if p._data is None and p._deferred_init is None:
                p.shape = tuple(loaded[name].shape)
                p.initialize(ctx=ctx)
            p.set_data(loaded[name])
        elif not allow_missing:
            raise MXNetError(f"parameter {name!r} missing in file {fname}")
    if not ignore_extra:
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(f"file {fname} has extra parameters "
                             f"{sorted(extra)}; set ignore_extra=True")

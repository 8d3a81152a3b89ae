"""``mx.nd`` — imperative array namespace.

Every registered operator is exposed here as a function, generated on
first access from the registry (counterpart of ``mxnet_tpu/ndarray``).
NDArray positional arguments are op inputs; keyword arguments are attrs;
``out=`` writes into an existing array.
"""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray, array, torch_dtype
from .utils import (zeros, ones, save, load, load_frombuffer, concat, stack,
                    split)
from .._imperative import invoke
from ..ops.registry import _REGISTRY, get_op, list_ops

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load",
           "load_frombuffer", "torch_dtype", "concat", "stack", "split"]


def _make_op_func(name: str):
    """Positional NDArrays (and numpy arrays) are the op's inputs, in
    order; an array passed by keyword under one of the op's input names
    (``SequenceMask(x, sequence_length=lens)``) takes that input's place;
    other keywords are attributes."""
    opdef = get_op(name)
    arg_names = tuple(opdef.arg_names() or ())

    def fn(*args, out=None, **kwargs):
        inputs = [a if isinstance(a, NDArray) else array(a) for a in args
                  if isinstance(a, (NDArray, np.ndarray))]
        named = {k: kwargs.pop(k) for k in list(kwargs)
                 if k in arg_names and isinstance(kwargs[k], NDArray)}
        if named:
            queue = list(inputs)
            slots = [named.get(n) if n in named
                     else (queue.pop(0) if queue else None)
                     for n in arg_names]
            while slots and slots[-1] is None:
                slots.pop()
            inputs = slots + queue
        kwargs.pop("name", None)
        kwargs.pop("ctx", None)
        return invoke(name, inputs, kwargs, out=out)

    fn.__name__ = name
    fn.__doc__ = opdef.doc
    return fn


_func_cache = {}


def __getattr__(name: str):
    if name == "Custom":
        # the imperative, differentiable custom op (``mx.operator``); the
        # registry's ``Custom`` is the graph-mode, forward-only one
        from ..operator import Custom
        return Custom
    if name in _REGISTRY:
        if name not in _func_cache:
            _func_cache[name] = _make_op_func(name)
        return _func_cache[name]
    raise AttributeError(
        f"module 'mxnet_tpu_torch.ndarray' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list_ops()))

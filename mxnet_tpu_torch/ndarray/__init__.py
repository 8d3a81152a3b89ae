"""``mx.nd`` — imperative array namespace.

Every registered operator is exposed here as a function, generated on
first access from the registry (counterpart of ``mxnet_tpu/ndarray``).
NDArray positional arguments are op inputs; keyword arguments are attrs;
``out=`` writes into an existing array.
"""
from __future__ import annotations

from .ndarray import NDArray, array, torch_dtype
from .utils import zeros, ones, save, load, load_frombuffer
from .._imperative import invoke
from ..ops.registry import _REGISTRY, get_op, list_ops

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load",
           "load_frombuffer", "torch_dtype"]


def _make_op_func(name: str):
    opdef = get_op(name)

    def fn(*args, out=None, **kwargs):
        inputs = [a for a in args if isinstance(a, NDArray)]
        kwargs.pop("name", None)
        kwargs.pop("ctx", None)
        return invoke(name, inputs, kwargs, out=out)

    fn.__name__ = name
    fn.__doc__ = opdef.doc
    return fn


_func_cache = {}


def __getattr__(name: str):
    if name in _REGISTRY:
        if name not in _func_cache:
            _func_cache[name] = _make_op_func(name)
        return _func_cache[name]
    raise AttributeError(
        f"module 'mxnet_tpu_torch.ndarray' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list_ops()))

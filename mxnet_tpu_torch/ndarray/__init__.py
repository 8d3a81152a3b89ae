"""``mx.nd`` — imperative array namespace.

Every registered operator is exposed here as a function, generated on
first access from the registry (counterpart of ``mxnet_tpu/ndarray``);
``mx.nd.sparse`` holds the sparse arrays.
NDArray positional arguments are op inputs; keyword arguments are attrs;
``out=`` writes into an existing array.
"""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray, array, torch_dtype
from .utils import (zeros, ones, full, empty, arange, save, load,
                    load_frombuffer, concat, stack, split, one_hot,
                    concatenate, moveaxis)
from . import sparse
from .._imperative import invoke
from ..base import MXNetError
from ..ops.registry import _REGISTRY, get_op, list_ops

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "save", "load", "load_frombuffer", "torch_dtype", "concat",
           "stack", "split", "one_hot", "waitall", "onehot_encode",
           "imdecode", "from_dlpack", "to_dlpack_for_read",
           "to_dlpack_for_write", "concatenate", "moveaxis", "add",
           "subtract", "multiply", "divide", "true_divide", "modulo",
           "maximum", "minimum", "power", "equal", "not_equal", "greater",
           "greater_equal", "lesser", "lesser_equal", "logical_and",
           "logical_or", "logical_xor"]


def _scalar_or_elemwise(elem_op, scalar_op, rscalar_op=None):
    """The top-level binary functions (``mx.nd.maximum(a, 2)``): the
    broadcast op for two arrays, the scalar op otherwise (the JAX
    package's dispatch)."""
    def fn(lhs, rhs):
        l_scalar, r_scalar = np.isscalar(lhs), np.isscalar(rhs)
        if l_scalar and r_scalar:
            raise ValueError("at least one operand must be an NDArray")
        if r_scalar:
            return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        if l_scalar:
            return invoke(rscalar_op or scalar_op, [rhs],
                          {"scalar": float(lhs)})
        return invoke(elem_op, [lhs, rhs], {})
    fn.__name__ = elem_op.replace("broadcast_", "")
    return fn


maximum = _scalar_or_elemwise("broadcast_maximum", "_maximum_scalar")
minimum = _scalar_or_elemwise("broadcast_minimum", "_minimum_scalar")
power = _scalar_or_elemwise("broadcast_power", "_power_scalar",
                            "_rpower_scalar")
add = _scalar_or_elemwise("broadcast_add", "_plus_scalar")
subtract = _scalar_or_elemwise("broadcast_sub", "_minus_scalar",
                               "_rminus_scalar")
multiply = _scalar_or_elemwise("broadcast_mul", "_mul_scalar")
divide = _scalar_or_elemwise("broadcast_div", "_div_scalar", "_rdiv_scalar")
true_divide = divide
modulo = _scalar_or_elemwise("broadcast_mod", "_mod_scalar", "_rmod_scalar")
equal = _scalar_or_elemwise("broadcast_equal", "_equal_scalar")
not_equal = _scalar_or_elemwise("broadcast_not_equal", "_not_equal_scalar")
greater = _scalar_or_elemwise("broadcast_greater", "_greater_scalar")
greater_equal = _scalar_or_elemwise("broadcast_greater_equal",
                                    "_greater_equal_scalar")
lesser = _scalar_or_elemwise("broadcast_lesser", "_lesser_scalar")
lesser_equal = _scalar_or_elemwise("broadcast_lesser_equal",
                                   "_lesser_equal_scalar")
logical_and = _scalar_or_elemwise("broadcast_logical_and",
                                  "_logical_and_scalar")
logical_or = _scalar_or_elemwise("broadcast_logical_or",
                                 "_logical_or_scalar")
logical_xor = _scalar_or_elemwise("broadcast_logical_xor",
                                  "_logical_xor_scalar")


def onehot_encode(indices, out):
    """The legacy one-hot fill: ``indices``' one-hot rows written into
    ``out`` (its dtype kept), which is returned."""
    hot = invoke("one_hot", [indices], {"depth": int(out.shape[1])})
    if tuple(hot.shape) != tuple(out.shape):
        raise MXNetError(f"onehot_encode: output shape {tuple(out.shape)} "
                         f"does not match the one-hot expansion "
                         f"{tuple(hot.shape)} of the given indices")
    out._set_data(hot._data.to(out._data.dtype))
    return out


def from_dlpack(ext_tensor) -> NDArray:
    """An array over a DLPack provider's memory, without a copy (an object
    with ``__dlpack__``: a torch tensor, a numpy array, or what
    :func:`to_dlpack_for_read` returns). A raw capsule is refused, as in
    the JAX package."""
    import torch
    if type(ext_tensor).__name__ == "PyCapsule":
        raise MXNetError("from_dlpack takes a DLPack provider object (torch "
                         "tensor, numpy array, ...), not a raw capsule; pass "
                         "the tensor itself")
    return NDArray(torch.from_dlpack(ext_tensor))


def to_dlpack_for_read(arr: NDArray):
    """A DLPack provider of the array, after its pending work (the tensor
    itself: consumers call ``torch.from_dlpack``/``np.from_dlpack`` on
    it)."""
    arr.wait_to_read()
    return arr._data.detach()


def to_dlpack_for_write(arr: NDArray):
    """A writable DLPack provider. As in the JAX package it is a fresh host
    copy: writes land in the copy, never in ``arr`` (re-import it with
    :func:`from_dlpack` or ``nd.array`` to see them)."""
    arr.wait_to_read()
    return arr._data.detach().cpu().numpy().copy()


def imdecode(buf, **kwargs) -> NDArray:
    """Decode an image buffer (``mx.image.imdecode``)."""
    from .. import image as _image
    return _image.imdecode(buf, **kwargs)


def waitall() -> None:
    """Block until all launched work is done and surface a deferred error
    (``mx.engine.wait_all``)."""
    from ..engine import wait_all
    wait_all()


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
        return invoke(name, inputs, kwargs, out=out)

    fn.__name__ = name
    fn.__doc__ = opdef.doc
    return fn


_func_cache = {}


def __getattr__(name: str):
    if name == "contrib":
        import importlib
        return importlib.import_module(__name__ + ".contrib")
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

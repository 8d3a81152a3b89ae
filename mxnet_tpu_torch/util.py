"""General utilities (``mx.util``).

Counterpart of ``mxnet_tpu/util.py`` (reference ``python/mxnet/util.py``):
the numpy-shape switches (torch handles zero-size and zero-dim tensors
natively, so the switch only records the user's flag), file and
environment helpers, the GPU count and memory, and the reference-format
weight files, which go through :mod:`mxnet_tpu_torch.interop`.
"""
from __future__ import annotations

import functools
import inspect
import os
import threading
from typing import Callable

__all__ = ["is_np_shape", "set_np_shape", "np_shape", "use_np_shape",
           "makedirs", "getenv", "setenv", "get_gpu_count", "get_gpu_memory",
           "load_reference_params", "save_reference_params",
           "load_reference_checkpoint"]


def load_reference_params(fname: str):
    """A reference-format binary ``.params`` file as a name->NDArray dict,
    on the host (see :mod:`mxnet_tpu_torch.interop`)."""
    from .interop import load_reference_params as _impl
    return _impl(fname)


def save_reference_params(fname: str, params) -> None:
    """Write params in the reference's binary format."""
    from .interop import save_reference_params as _impl
    return _impl(fname, params)


def load_reference_checkpoint(prefix: str, epoch: int):
    """``prefix-symbol.json`` and ``prefix-NNNN.params`` of the reference
    as (symbol, arg_params, aux_params)."""
    from .interop import load_reference_checkpoint as _impl
    return _impl(prefix, epoch)


_state = threading.local()


def is_np_shape() -> bool:
    """Whether numpy-compatible shape semantics are on (``util.py:37``)."""
    return getattr(_state, "np_shape", False)


def set_np_shape(active: bool) -> bool:
    prev = is_np_shape()
    _state.np_shape = bool(active)
    return prev


class np_shape:
    """Context manager and decorator for the np-shape switch
    (``util.py:82``)."""

    def __init__(self, active: bool = True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = set_np_shape(self._active)
        return self

    def __exit__(self, *exc):
        set_np_shape(self._prev)

    def __call__(self, fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with np_shape(self._active):
                return fn(*args, **kwargs)
        return wrapper


def use_np_shape(fn: Callable) -> Callable:
    """Decorator form (``util.py:170``)."""
    if inspect.isclass(fn):
        return fn
    return np_shape(True)(fn)


def makedirs(d: str) -> None:
    """``os.makedirs(exist_ok=True)`` (``util.py:30``)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def getenv(name: str):
    return os.environ.get(name)


def setenv(name: str, value) -> None:
    os.environ[name] = str(value)


def get_gpu_count() -> int:
    """The CUDA devices torch sees (c_api MXGetGPUCount)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_memory(dev_id: int = 0):
    """(free, total) bytes of CUDA device ``dev_id``."""
    import torch
    if dev_id >= get_gpu_count():
        raise ValueError(f"no accelerator {dev_id}")
    return torch.cuda.mem_get_info(dev_id)

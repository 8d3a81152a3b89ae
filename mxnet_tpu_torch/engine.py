"""Engine facade: execution-ordering control.

Counterpart of ``mxnet_tpu/engine.py`` (reference ``include/mxnet/
engine.h``, ``src/engine/``: NaiveEngine, op bulking ``set_bulk_size``,
``MXNET_ENGINE_TYPE``). CUDA streams order the device work, so what is
kept here is:

- :func:`wait_all`, Engine::WaitForAll: every CUDA device the process has
  used is synchronised, the host engine drained, and the first deferred
  error (a device-side assert, a failed host task) raised as
  :class:`~mxnet_tpu_torch.base.MXNetError`, after everything has drained;
- naive (synchronous) mode for debugging: every imperative op waits for its
  outputs (``MXNET_ENGINE_TYPE=NaiveEngine``, or :func:`naive_mode`);
- ``set_bulk_size``/``bulk``, a hint kept for API parity (the JAX package's
  fused path is graph capture; the port runs eagerly);
- the host dependency engine, :func:`new_var`, :func:`push`,
  :func:`wait_var`, :func:`wait_all_host`: the C++ engine of
  :mod:`mxnet_tpu_torch.native` (built with ``g++`` at first use), or a
  serial engine with the same error semantics only where that library
  cannot be built.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from .base import MXNetError, get_env

__all__ = ["wait_all", "naive_mode", "is_naive", "set_naive",
           "set_bulk_size", "bulk", "new_var", "var_version", "free_var",
           "push", "wait_var", "wait_all_host"]

_state = threading.local()


def _naive_default() -> bool:
    return str(get_env("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")) \
        .lower().startswith("naive")


def is_naive() -> bool:
    if not hasattr(_state, "naive"):
        _state.naive = _naive_default()
    return _state.naive


def set_naive(flag: bool) -> None:
    _state.naive = bool(flag)


@contextmanager
def naive_mode():
    """Synchronous execution: every imperative op waits until its outputs
    are computed (NaiveEngine semantics, ``naive_engine.cc:228``)."""
    old = is_naive()
    _state.naive = True
    try:
        yield
    finally:
        _state.naive = old


def synchronize(tensors) -> None:
    """Wait for the devices that hold ``tensors`` (naive mode's op
    barrier)."""
    import torch
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)
                and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def wait_all() -> None:
    """Engine::WaitForAll: block until all launched work is done, on every
    CUDA device this process has used and in the host engine. As in the
    reference (``threaded_engine.cc:429-481``) a failure captured by
    asynchronous work is raised here, as ``MXNetError``, after the rest
    has drained."""
    import torch
    first_err = None
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            try:
                torch.cuda.synchronize(i)
            except Exception as e:      # keep draining, raise the first
                first_err = first_err or e
    if _host_engine is not None:
        try:
            _host_engine.wait_all()
        except Exception as e:
            first_err = first_err or e
    if first_err is not None:
        raise MXNetError(f"async error surfaced at waitall: {first_err}") \
            from first_err


_bulk_size = [0]


def set_bulk_size(size: int) -> int:
    """Engine::set_bulk_size; returns the previous value (a hint: the port
    dispatches each op eagerly)."""
    old = _bulk_size[0]
    _bulk_size[0] = int(size)
    return old


@contextmanager
def bulk(size: int):
    old = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(old)


# ------------------------------------------- the host dependency engine
_host_engine = None
_host_engine_lock = threading.Lock()


class _SerialEngine:
    """Immediate execution with the engine's error deferral: the engine
    where the native library cannot be built."""

    def __init__(self):
        self._versions = {}
        self._errors = {}
        self._next = 1

    def new_var(self):
        v = self._next
        self._next += 1
        self._versions[v] = 0
        return v

    def var_version(self, var):
        return self._versions.get(var, 0)

    def free_var(self, var):
        self._versions.pop(var, None)
        self._errors.pop(var, None)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        try:
            fn()
        except BaseException as e:
            for v in list(const_vars) + list(mutable_vars):
                self._errors.setdefault(v, f"{type(e).__name__}: {e}")
        for v in mutable_vars:
            self._versions[v] = self._versions.get(v, 0) + 1

    def _raise_if(self, var):
        msg = self._errors.pop(var, None)
        if msg:
            raise RuntimeError(f"deferred engine error: {msg}")

    def wait_var(self, var):
        self._raise_if(var)

    def wait_all(self):
        for v in list(self._errors):
            self._raise_if(v)


def host_engine():
    """The process's host engine: native where the library builds."""
    global _host_engine
    with _host_engine_lock:
        if _host_engine is None:
            nworkers = int(get_env("MXNET_CPU_WORKER_NTHREADS", 4))
            try:
                from .native import NativeEngine
                _host_engine = NativeEngine(nworkers)
            except RuntimeError:
                _host_engine = _SerialEngine()
        return _host_engine


def new_var() -> int:
    """A dependency variable (Engine::NewVariable)."""
    return host_engine().new_var()


def var_version(var: int) -> int:
    """How many writes of ``var`` have completed (ThreadedVar::version_)."""
    return host_engine().var_version(var)


def free_var(var: int) -> None:
    """Engine::DeleteVariable: waits for the var's ops, then frees it."""
    host_engine().free_var(var)


def push(fn, const_vars=(), mutable_vars=(), priority: int = 0) -> None:
    """Run ``fn()`` on the host pool once its dependencies are met
    (MXEnginePushAsync); its errors surface at ``wait_var``/``wait_all``."""
    host_engine().push(fn, const_vars, mutable_vars, priority)


def wait_var(var: int) -> None:
    """Engine::WaitForVar: block, and raise a deferred error of ``var``."""
    host_engine().wait_var(var)


def wait_all_host() -> None:
    """Block until every host task is done (raises a deferred error)."""
    host_engine().wait_all()

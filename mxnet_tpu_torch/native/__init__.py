"""Native bridge of the PyTorch port: the Predictor (the C ABI over it
waits for a later slice) and the host dependency engine.

:class:`NativeEngine` is the port's copy of ``mxnet_tpu/native``'s: the C++
engine of ``engine_storage.cc`` beside this file (ThreadedVar queues, a
priority worker pool, deferred exceptions), compiled with ``g++`` at first
use into ``mxnet_tpu_torch/_build/`` (gitignored) under a name that digests
the source and the flags, and bound with ``ctypes``. :func:`get_lib`
returns None where it cannot be built; :mod:`mxnet_tpu_torch.engine` then
runs its serial engine.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "engine_storage.cc"
_BUILD = _HERE.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_build_failed = False

TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_char_p))


def lib_path() -> Path:
    """The library built from the current source and flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"libengine-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """``g++`` into a temporary file renamed into place, so that processes
    building at once each see a whole library or none."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The engine library (built at first use), or None where it cannot be
    built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.eng_create.restype = ctypes.c_void_p
        lib.eng_create.argtypes = [ctypes.c_int]
        lib.eng_destroy.argtypes = [ctypes.c_void_p]
        lib.eng_new_var.restype = ctypes.c_uint64
        lib.eng_new_var.argtypes = [ctypes.c_void_p]
        lib.eng_var_version.restype = ctypes.c_uint64
        lib.eng_var_version.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.eng_del_var.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.eng_push.argtypes = [
            ctypes.c_void_p, TASK_FN, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
        lib.eng_wait_var.restype = ctypes.c_void_p   # char*, eng_free_str
        lib.eng_wait_var.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.eng_wait_all.restype = ctypes.c_void_p
        lib.eng_wait_all.argtypes = [ctypes.c_void_p]
        lib.eng_free_str.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


_libc = ctypes.CDLL(None)
_libc.strdup.restype = ctypes.c_void_p
_libc.strdup.argtypes = [ctypes.c_char_p]


class NativeEngine:
    """Threaded dependency engine (reference ThreadedEnginePerDevice
    semantics, ``src/engine/threaded_engine.h``): vars with read/write
    queues and version counters, ops with wait counts dispatched to a
    priority worker pool, exceptions captured per var and raised again at
    the wait points. A Python callback holds the GIL while it runs, so the
    engine orders and overlaps host work whose heavy part releases the GIL
    (file IO, numpy, CUDA dispatch)."""

    def __init__(self, num_workers: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native engine library unavailable")
        self._lib = lib
        self._h = lib.eng_create(num_workers)
        self._callbacks = {}      # cb id -> CFUNCTYPE, alive until done
        self._cb_vars = {}        # cb id -> vars the op touches
        self._done = set()        # ids whose Python body finished
        self._cb_id = 0
        self._cb_lock = threading.Lock()

    def _check(self):
        if not self._h:
            raise RuntimeError("engine is closed")

    def _drain_done(self, var=None):
        # A CFUNCTYPE may be dropped only once its thunk has returned; the
        # C engine proves that at its wait points (all ops, or every op on
        # ``var``), so only those finished callbacks are released.
        with self._cb_lock:
            for cb_id in list(self._done):
                if var is not None and var not in self._cb_vars.get(
                        cb_id, ()):
                    continue
                self._done.discard(cb_id)
                self._callbacks.pop(cb_id, None)
                self._cb_vars.pop(cb_id, None)

    def new_var(self) -> int:
        self._check()
        return int(self._lib.eng_new_var(self._h))

    def var_version(self, var: int) -> int:
        self._check()
        return int(self._lib.eng_var_version(self._h, var))

    def free_var(self, var: int) -> None:
        """Engine::DeleteVariable: waits for the var's ops, then frees."""
        self._check()
        self._lib.eng_del_var(self._h, var)
        self._drain_done(var)

    def push(self, fn, const_vars=(), mutable_vars=(), priority: int = 0):
        """Run ``fn()`` after its dependencies: it reads ``const_vars`` and
        writes ``mutable_vars`` (MXEnginePushAsync). An exception of
        ``fn`` surfaces at ``wait_var``/``wait_all`` of a var it
        touches."""
        self._check()
        with self._cb_lock:
            cb_id = self._cb_id
            self._cb_id += 1

        def trampoline(_ctx, err_out):
            try:
                fn()
            except BaseException as e:   # captured, raised at a wait point
                msg = f"{type(e).__name__}: {e}".encode()
                # the engine frees it with free(): allocate with strdup
                err_out[0] = ctypes.cast(_libc.strdup(msg), ctypes.c_char_p)
            finally:
                with self._cb_lock:
                    self._done.add(cb_id)

        cfn = TASK_FN(trampoline)
        with self._cb_lock:
            self._callbacks[cb_id] = cfn
            self._cb_vars[cb_id] = frozenset(const_vars) | frozenset(
                mutable_vars)
        nc, nm = len(const_vars), len(mutable_vars)
        cv = (ctypes.c_uint64 * max(nc, 1))(*const_vars)
        mv = (ctypes.c_uint64 * max(nm, 1))(*mutable_vars)
        self._lib.eng_push(self._h, cfn, None, cv, nc, mv, nm, priority)

    def _raise_if(self, err_ptr):
        if err_ptr:
            msg = ctypes.cast(err_ptr, ctypes.c_char_p).value.decode()
            self._lib.eng_free_str(err_ptr)
            raise RuntimeError(f"deferred engine error: {msg}")

    def wait_var(self, var: int) -> None:
        self._check()
        err = self._lib.eng_wait_var(self._h, var)
        self._drain_done(var)
        self._raise_if(err)

    def wait_all(self) -> None:
        self._check()
        err = self._lib.eng_wait_all(self._h)
        self._drain_done()
        self._raise_if(err)

    def close(self) -> None:
        if self._h:
            self._lib.eng_destroy(self._h)   # joins the workers
            self._h = None
            self._drain_done()
            self._callbacks.clear()
            self._cb_vars.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

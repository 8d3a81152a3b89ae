"""``ctypes`` bindings to NVRTC and the CUDA driver, for :mod:`.rtc`.

The reference's ``CudaModule`` (``src/common/rtc.cc``) compiles a user's
CUDA source with NVRTC and launches it through the driver API
(``cuModuleLoadData``, ``cuLaunchKernel``). This module binds the few
entry points that takes, with nothing built ahead of time:

* ``libnvrtc`` from ``$CUDA_HOME/lib64`` or ``/usr/local/cuda/lib64``, else
  the ``nvidia/cuda_nvrtc/lib`` directory that PyTorch's CUDA wheels
  install;
* the driver, ``libcuda.so.1``.

Both load at first use, so the package imports on a machine without CUDA;
a library that is missing raises :class:`~.base.MXNetError` naming it.
Every ``nvrtcResult`` and ``CUresult`` is checked.

Driver calls act on the calling thread's current context, which the CUDA
runtime sets only on threads that have used it. :func:`make_current` makes
the device's primary context (the one PyTorch uses) current before a load
or a launch, so a launch from any thread works.
"""
from __future__ import annotations

import ctypes
import glob
import importlib.util
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .base import MXNetError

__all__ = ["cuda_home", "compile_program", "make_current", "load_module",
           "get_function", "set_max_dynamic_shared", "launch"]

_VP, _SZ, _CP = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
_INT, _UINT = ctypes.c_int, ctypes.c_uint

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_contexts: Dict[int, ctypes.c_void_p] = {}

CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

# name -> (restype, argtypes); every function returns a status code
_NVRTC_FUNCS = {
    "nvrtcGetErrorString": (_CP, [_INT]),
    "nvrtcCreateProgram": (_INT, [ctypes.POINTER(_VP), _CP, _CP, _INT,
                                  ctypes.POINTER(_CP), ctypes.POINTER(_CP)]),
    "nvrtcDestroyProgram": (_INT, [ctypes.POINTER(_VP)]),
    "nvrtcAddNameExpression": (_INT, [_VP, _CP]),
    "nvrtcCompileProgram": (_INT, [_VP, _INT, ctypes.POINTER(_CP)]),
    "nvrtcGetProgramLogSize": (_INT, [_VP, ctypes.POINTER(_SZ)]),
    "nvrtcGetProgramLog": (_INT, [_VP, ctypes.c_char_p]),
    "nvrtcGetLoweredName": (_INT, [_VP, _CP, ctypes.POINTER(_CP)]),
    "nvrtcGetCUBINSize": (_INT, [_VP, ctypes.POINTER(_SZ)]),
    "nvrtcGetCUBIN": (_INT, [_VP, ctypes.c_char_p]),
    "nvrtcGetPTXSize": (_INT, [_VP, ctypes.POINTER(_SZ)]),
    "nvrtcGetPTX": (_INT, [_VP, ctypes.c_char_p]),
}
_CUDA_FUNCS = {
    "cuGetErrorString": (_INT, [_INT, ctypes.POINTER(_CP)]),
    "cuInit": (_INT, [_UINT]),
    "cuDeviceGet": (_INT, [ctypes.POINTER(_INT), _INT]),
    "cuDevicePrimaryCtxRetain": (_INT, [ctypes.POINTER(_VP), _INT]),
    "cuCtxSetCurrent": (_INT, [_VP]),
    "cuModuleLoadData": (_INT, [ctypes.POINTER(_VP), _VP]),
    "cuModuleGetFunction": (_INT, [ctypes.POINTER(_VP), _VP, _CP]),
    "cuFuncSetAttribute": (_INT, [_VP, _INT, _INT]),
    "cuLaunchKernel": (_INT, [_VP, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT,
                              _UINT, _VP, ctypes.POINTER(_VP),
                              ctypes.POINTER(_VP)]),
}


def cuda_home() -> Optional[str]:
    """``$CUDA_HOME`` (or ``$CUDA_PATH``), else ``/usr/local/cuda`` if it
    exists, else None."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return home
    return "/usr/local/cuda" if os.path.isdir("/usr/local/cuda") else None


def _nvrtc_candidates() -> List[str]:
    dirs = []
    home = cuda_home()
    if home:
        dirs.append(os.path.join(home, "lib64"))
    dirs.append("/usr/local/cuda/lib64")
    spec = importlib.util.find_spec("nvidia")
    for root in (spec.submodule_search_locations or []) if spec else []:
        dirs.append(os.path.join(root, "cuda_nvrtc", "lib"))
    found = []
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "libnvrtc.so*"))):
            if path not in found:
                found.append(path)
    return found


def _bind(lib: ctypes.CDLL, funcs) -> ctypes.CDLL:
    for name, (restype, argtypes) in funcs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load(which: str) -> ctypes.CDLL:
    with _lock:
        if which in _libs:
            return _libs[which]
        if which == "nvrtc":
            paths = _nvrtc_candidates()
            if not paths:
                raise MXNetError(
                    "libnvrtc not found: looked in $CUDA_HOME/lib64, "
                    "/usr/local/cuda/lib64 and PyTorch's nvidia/cuda_nvrtc/"
                    "lib; rtc.CudaModule compiles with NVRTC")
            errors = []
            for path in paths:
                try:
                    lib = _bind(ctypes.CDLL(path), _NVRTC_FUNCS)
                    break
                except (OSError, AttributeError) as e:
                    errors.append(f"{path}: {e}")
            else:
                raise MXNetError("libnvrtc could not be loaded: "
                                 + "; ".join(errors))
        else:
            try:
                lib = _bind(ctypes.CDLL("libcuda.so.1"), _CUDA_FUNCS)
            except (OSError, AttributeError) as e:
                raise MXNetError(f"the CUDA driver libcuda.so.1 could not be "
                                 f"loaded ({e}); rtc.CudaModule launches "
                                 f"through the driver API") from None
            _check_cu(lib, lib.cuInit(0), "cuInit")
        _libs[which] = lib
        return lib


def _check_nvrtc(lib, status: int, what: str, log: str = "") -> None:
    if status != 0:
        msg = lib.nvrtcGetErrorString(status).decode()
        raise MXNetError(f"{what}: NVRTC error {status} ({msg})"
                         + (f"\n{log}" if log else ""))


def _check_cu(lib, status: int, what: str) -> None:
    if status != 0:
        s = _CP()
        lib.cuGetErrorString(status, ctypes.byref(s))
        msg = s.value.decode() if s.value else "unknown"
        raise MXNetError(f"{what}: CUDA driver error {status} ({msg})")


def _program_log(lib, prog) -> str:
    size = _SZ()
    _check_nvrtc(lib, lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                 "nvrtcGetProgramLogSize")
    buf = ctypes.create_string_buffer(size.value)
    _check_nvrtc(lib, lib.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
    return buf.value.decode(errors="replace")


def compile_program(source: str, options: Sequence[str],
                    name_expressions: Sequence[str], binary: str
                    ) -> Tuple[bytes, Dict[str, str], str]:
    """Compile ``source`` with NVRTC; returns (the image, {name expression:
    lowered name}, the compile log). ``binary`` is ``"cubin"`` (the options
    name a real architecture, ``sm_XX``) or ``"ptx"`` (a virtual one,
    ``compute_XX``, which the driver compiles at load). A failed compile
    raises with NVRTC's log."""
    lib = _load("nvrtc")
    prog = _VP()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_source.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"nvrtcAddNameExpression({expr!r})")
        opts = [o.encode() for o in options]
        arr = (_CP * len(opts))(*opts)
        status = lib.nvrtcCompileProgram(prog, len(opts), arr)
        log = _program_log(lib, prog)
        _check_nvrtc(lib, status, "CUDA source failed to compile", log)
        lowered = {}
        for expr in name_expressions:
            out = _CP()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, expr.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = out.value.decode()
        get_size, get = ((lib.nvrtcGetCUBINSize, lib.nvrtcGetCUBIN)
                         if binary == "cubin"
                         else (lib.nvrtcGetPTXSize, lib.nvrtcGetPTX))
        size = _SZ()
        _check_nvrtc(lib, get_size(prog, ctypes.byref(size)),
                     f"nvrtcGet{binary.upper()}Size")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, get(prog, buf), f"nvrtcGet{binary.upper()}")
        return buf.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def make_current(device_index: int) -> None:
    """Make the device's primary context current on this thread (retained
    once per device; the context PyTorch's runtime uses)."""
    lib = _load("cuda")
    ctx = _contexts.get(device_index)
    if ctx is None:
        with _lock:
            ctx = _contexts.get(device_index)
            if ctx is None:
                dev = _INT()
                _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev),
                                               device_index), "cuDeviceGet")
                ctx = _VP()
                _check_cu(lib, lib.cuDevicePrimaryCtxRetain(
                    ctypes.byref(ctx), dev.value), "cuDevicePrimaryCtxRetain")
                _contexts[device_index] = ctx
    _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(device_index: int, image: bytes) -> ctypes.c_void_p:
    """Load a cubin or PTX image into the device's primary context. The
    module stays loaded for the life of the process."""
    lib = _load("cuda")
    make_current(device_index)
    module = _VP()
    buf = ctypes.create_string_buffer(image, len(image))
    _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(module),
                                        ctypes.cast(buf, _VP)),
              "cuModuleLoadData")
    return module


def get_function(module, lowered_name: str) -> ctypes.c_void_p:
    lib = _load("cuda")
    fn = _VP()
    _check_cu(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                           lowered_name.encode()),
              f"cuModuleGetFunction({lowered_name!r})")
    return fn


def set_max_dynamic_shared(function, nbytes: int) -> None:
    """Allow ``nbytes`` of dynamic shared memory (needed above 48 KB)."""
    lib = _load("cuda")
    _check_cu(lib, lib.cuFuncSetAttribute(
        function, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
        int(nbytes)), "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(device_index: int, function, grid: Sequence[int],
           block: Sequence[int], shared_mem: int, stream: int,
           values: Sequence[ctypes._SimpleCData]) -> None:
    """``cuLaunchKernel`` with one pointer to each argument's value;
    ``values`` are the arguments as ``ctypes`` objects of their exact C
    types, kept alive by the caller until this returns."""
    lib = _load("cuda")
    make_current(device_index)
    params = (_VP * max(len(values), 1))(
        *[ctypes.addressof(v) for v in values])
    _check_cu(lib, lib.cuLaunchKernel(
        function, *(int(g) for g in grid), *(int(b) for b in block),
        int(shared_mem), _VP(stream), params, None), "cuLaunchKernel")

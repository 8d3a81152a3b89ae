"""Runtime-compiled user kernels (``mx.rtc``): CUDA source through NVRTC.

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasModule`` wraps a user's
Pallas function in ``pl.pallas_call`` (``rtc.py:78``). On the GPU the
reference's own API comes back (``include/mxnet/rtc.h:39``,
``src/common/rtc.cc:35-49``, ``python/mxnet/rtc.py``):

    mod = mx.rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float* x, float* y, int n")
    k.launch([x, y, n], mx.gpu(0), (blocks, 1, 1), (threads, 1, 1))

* The source is compiled at the kernel's first launch on a device, once
  per device, by NVRTC to a cubin for the card's architecture
  (``--gpu-architecture=sm_90a`` on a Hopper card: the ``a`` keeps
  ``wgmma`` and ``setmaxnreg`` available), unless ``options`` name one.
  NVRTC sees no system headers; ``-I$CUDA_HOME/include`` is added so that
  ``cuda_fp16.h`` resolves.
* ``exports`` are NVRTC name expressions, so C++ and template kernels
  (``"fwd<float>"``) are found by their lowered names; with no exports,
  names are ``extern "C"`` symbols used as they are.
* ``launch`` checks every argument against the signature (contiguous CUDA
  tensors on ``ctx`` of the signature's dtype; scalars of its C type),
  writes into its array arguments on PyTorch's current stream of that
  device and returns nothing. Anything else raises
  :class:`~.base.MXNetError` before anything is compiled: there is no CPU
  path.

Each kernel counts its launches in :attr:`CudaKernel.launches`.
"""
from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _cuda_driver as drv
from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "Kernel", "PallasModule"]

# signature type -> (torch dtype of a pointer's array, ctypes type of a value)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "__half": (torch.float16, ctypes.c_uint16),
}
_ARG_RE = re.compile(r"^\s*(const\s+)?(\w+)\s*(\*)?\s*(\w+)?\s*$")
_SHARED_DEFAULT = 48 * 1024


class _Arg:
    __slots__ = ("const", "ctype", "pointer", "name")

    def __init__(self, const, ctype, pointer, name):
        self.const, self.ctype, self.pointer, self.name = \
            const, ctype, pointer, name

    def __repr__(self):
        return (f"{'const ' if self.const else ''}{self.ctype}"
                f"{'*' if self.pointer else ''} {self.name}")


def _parse_signature(signature: str) -> List[_Arg]:
    """``"const float* x, float* y, int n"`` -> one :class:`_Arg` each."""
    args = []
    if not signature.strip():
        return args
    for i, part in enumerate(signature.split(",")):
        m = _ARG_RE.match(part)
        if m is None:
            raise MXNetError(f"cannot parse kernel argument {part!r}")
        const, ctype, star, name = m.groups()
        if ctype not in _TYPES:
            raise MXNetError(f"kernel argument {part.strip()!r}: type "
                             f"{ctype!r} is not supported (supported: "
                             f"{', '.join(_TYPES)})")
        args.append(_Arg(bool(const), ctype, bool(star), name or f"arg{i}"))
    return args


def _names_architecture(options: Sequence[str]) -> bool:
    return any(o.startswith(("-arch", "--gpu-architecture")) for o in options)


class CudaModule:
    """CUDA source compiled at run time (reference ``CudaModule``).

    Parameters
    ----------
    source : str
        CUDA C++ source.
    options : sequence of str
        NVRTC options (``"--use_fast_math"``, ``"-arch=compute_90"``, ...).
    exports : sequence of str
        Name expressions of the kernels to look up by C++ name, e.g.
        ``"axpy<float>"``; ``extern "C"`` kernels need none.
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._lock = threading.Lock()
        # device index -> (module handle, {export: lowered name})
        self._loaded: Dict[int, Tuple[ctypes.c_void_p, Dict[str, str]]] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with its argument list ``signature``; checked
        here, compiled at its first launch."""
        if self.exports and name not in self.exports:
            raise MXNetError(f"kernel {name!r} is not among the module's "
                             f"exports {list(self.exports)}")
        return CudaKernel(self, name, _parse_signature(signature))

    def _options(self, device_index: int) -> List[str]:
        opts = list(self.options)
        if not _names_architecture(opts):
            major, minor = torch.cuda.get_device_capability(device_index)
            arch = f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0)
                                           else "")
            opts.append(f"--gpu-architecture={arch}")
        home = drv.cuda_home()
        if home:
            opts.append(f"-I{home}/include")
        return opts

    def compile(self, ctx: Context) -> float:
        """Compile and load for ``ctx`` now (otherwise the first launch
        does); returns the seconds it took, 0 if it was done already."""
        import time
        t0 = time.perf_counter()
        fresh = self._module(_device_index(ctx))[2]
        return time.perf_counter() - t0 if fresh else 0.0

    def _module(self, device_index: int):
        """(module handle, {export: lowered name}, compiled by this call)."""
        with self._lock:
            got = self._loaded.get(device_index)
            if got is not None:
                return got[0], got[1], False
            opts = self._options(device_index)
            arch = [o for o in opts
                    if o.startswith(("-arch", "--gpu-architecture"))][-1]
            binary = "ptx" if "compute_" in arch else "cubin"
            image, lowered, _ = drv.compile_program(self.source, opts,
                                                    self.exports, binary)
            module = drv.load_module(device_index, image)
            self._loaded[device_index] = (module, lowered)
            return module, lowered, True


def _device_index(ctx) -> int:
    if not isinstance(ctx, Context) or ctx.device_type != "gpu":
        raise MXNetError(f"CudaKernel.launch needs a GPU context, got {ctx!r}:"
                         f" runtime-compiled CUDA runs only on the card")
    return ctx.torch_device().index


class CudaKernel:
    """One kernel of a :class:`CudaModule` (reference
    ``CudaModule::Kernel``, ``rtc.h:58``)."""

    def __init__(self, module: CudaModule, name: str, signature: List[_Arg]):
        self._module = module
        self._name = name
        self.signature = signature
        self.launches = 0
        self._functions: Dict[int, Tuple[ctypes.c_void_p, int]] = {}

    @property
    def name(self) -> str:
        return self._name

    def _pack(self, args, device: torch.device) -> List:
        """Check ``args`` against the signature; the ctypes value of each
        (pointers from ``data_ptr()``, scalars in their exact C type)."""
        if len(args) != len(self.signature):
            raise MXNetError(f"kernel {self._name}: {len(args)} arguments for"
                             f" signature ({', '.join(map(repr, self.signature))})")
        values = []
        for a, spec in zip(args, self.signature):
            dtype, ctype = _TYPES[spec.ctype]
            if spec.pointer:
                t = a._data if isinstance(a, NDArray) else a
                if not isinstance(t, torch.Tensor):
                    raise MXNetError(f"kernel {self._name}: argument "
                                     f"{spec!r} takes an array, got "
                                     f"{type(a).__name__}")
                if t.device != device:
                    raise MXNetError(f"kernel {self._name}: argument "
                                     f"{spec!r} lies on {t.device}, the "
                                     f"launch is on {device}")
                if t.dtype != dtype:
                    raise MXNetError(f"kernel {self._name}: argument "
                                     f"{spec!r} takes {dtype}, got {t.dtype}")
                if not t.is_contiguous():
                    raise MXNetError(f"kernel {self._name}: argument "
                                     f"{spec!r} is not contiguous")
                values.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(a, (NDArray, torch.Tensor)):
                    raise MXNetError(f"kernel {self._name}: argument "
                                     f"{spec!r} takes a scalar, got an array")
                if spec.ctype == "__half":
                    values.append(ctype(int(np.float16(a).view(np.uint16))))
                elif dtype.is_floating_point:
                    values.append(ctype(float(a)))
                else:
                    values.append(ctype(int(a)))
        return values

    def _function(self, device_index: int, shared_mem: int):
        got = self._functions.get(device_index)
        if got is None:
            module, lowered, _ = self._module._module(device_index)
            got = (drv.get_function(module, lowered.get(self._name,
                                                        self._name)),
                   _SHARED_DEFAULT)
        fn, allowed = got
        if shared_mem > allowed:
            drv.set_max_dynamic_shared(fn, shared_mem)
            allowed = shared_mem
        self._functions[device_index] = (fn, allowed)
        return fn

    def launch(self, args: Sequence, ctx: Context, grid_dims: Sequence[int],
               block_dims: Sequence[int], shared_mem: int = 0) -> None:
        """Launch on ``ctx`` with CUDA grid and block dims (up to three
        each) and ``shared_mem`` bytes of dynamic shared memory; arrays
        are written in place."""
        device_index = _device_index(ctx)
        device = torch.device("cuda", device_index)
        values = self._pack(args, device)
        grid = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(block_dims) + (1,) * (3 - len(block_dims))
        fn = self._function(device_index, int(shared_mem))
        drv.launch(device_index, fn, grid, block, int(shared_mem),
                   torch.cuda.current_stream(device).cuda_stream, values)
        self.launches += 1


Kernel = CudaKernel


class PallasModule:
    """Unavailable on the GPU: kept so that code written for the JAX
    package fails with a clear error pointing at :class:`CudaModule`."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasModule (Pallas kernels for the TPU) is not available in "
            "the PyTorch port. Write the kernel in CUDA C++ and use "
            "mx.rtc.CudaModule(source, options, exports) instead.")

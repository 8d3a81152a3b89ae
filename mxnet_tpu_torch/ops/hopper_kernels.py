"""Hand-written Hopper kernels for the ops XLA used to fuse through Pallas.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel is CUDA C++
under ``mxnet_tpu_torch/csrc/``, compiled for ``sm_90a`` with ``nvcc`` at
first use into ``mxnet_tpu_torch/_build/`` (a plain-C shared library loaded
with ``ctypes``), and sits beside a plain PyTorch version of the same
function.

Dispatch is by the device of the tensors, nothing else:

* a CPU tensor takes the plain version (the CPU tests run it);
* a CUDA tensor launches the kernel, or raises — there is no fallback and
  no switch that swaps the plain version in on the card;
* a ``meta`` tensor (shape inference) gets empty outputs of the right shape.

Every launch adds one to :data:`launch_counts` under the kernel's name, so
a run can show that its main path went through the kernel.

Kernels:

* ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) — replaces
  ``_fa_kernel``/``_fa_pallas`` (``pallas_kernels.py:63-178``); entry points
  :func:`flash_attention` and :func:`flash_attention_with_lse` on
  (B, H, T, D), plain version :func:`flash_attention_reference`. Forward
  only: the blockwise backward lands with the training slice, so calling it
  under autograd on the card raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "launch_counts", "reset_launch_counts",
           "build", "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30  # the TPU kernel's sentinel; ring attention's merge needs it

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "flash_attention_fwd.cu"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last reset
launch_counts: Dict[str, int] = {"flash_attention_fwd": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME): the Hopper kernels "
                     "are built from mxnet_tpu_torch/csrc at first use")


def build() -> Path:
    """Compile ``csrc/flash_attention_fwd.cu`` unless a library built from
    the same source and flags exists; returns the library's path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    path = _BUILD / f"libflash_attention_fwd-{digest[:16]}.so"
    if path.exists():
        return path
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                           str(_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError(f"kernel build failed (nvcc exit "
                         f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            # without argtypes ctypes passes Python ints as 32-bit C ints
            # and cuts the pointers
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.mxtt_flash_attention_fwd
            fn.argtypes = ([vp] * 5 + [i32] * 5 + [i64] * 8
                           + [ctypes.c_float, i32, i32, i32, vp])
            fn.restype = i32
            lib.mxtt_cuda_error_string.argtypes = [i32]
            lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mxtt_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              q_offset: int = 0, k_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, following ``_fa_reference``
    (``pallas_kernels.py:181-195``): the full score matrix in float32.
    q, k, v (..., T, D) -> (out (..., Tq, D) in q's dtype, lse (..., Tq)
    in float32). Inputs of a lower precision are upcast first, so on bf16
    inputs this is the float32 answer the kernel is held against."""
    Tq, D = q.shape[-2], q.shape[-1]
    Tk = k.shape[-2]
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    if causal:
        qpos = torch.arange(Tq, device=q.device) + q_offset
        kpos = torch.arange(Tk, device=q.device) + k_offset
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full((), _NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= _NEG_INF / 2, torch.zeros((), device=q.device), p)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp_min(1e-30)
    l0 = l[..., 0]
    lse = torch.where(l0 <= 0.0, torch.full((), _NEG_INF, device=q.device),
                      m[..., 0] + torch.log(l0.clamp_min(1e-30)))
    return out.to(q.dtype), lse


def _fa_kernel(q, k, v, scale, causal, q_offset, k_offset):
    """Launch ``csrc/flash_attention_fwd.cu`` on (BH, T, D) CUDA tensors."""
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise MXNetError(f"flash_attention: head dim {D} is not supported by "
                         f"the Hopper kernel (supported: "
                         f"{SUPPORTED_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(f"flash_attention: the Hopper kernel takes float32 "
                         f"or bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (k.device == q.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise MXNetError("flash_attention: no backward on the card yet "
                         "(backward lands with the training slice); call "
                         "it under torch.no_grad()/inference_mode()")
    BH, Tq, _ = q.shape
    Tk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], D, BH, Tq, Tk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale), int(bool(causal)), int(q_offset), int(k_offset),
            stream)
    _check(lib, err, "flash_attention_fwd launch")
    launch_counts["flash_attention_fwd"] += 1
    return out, lse


def _fa_fwd_dispatch(q, k, v, scale, causal, q_offset, k_offset):
    """(BH, T, D) -> (out, lse), by device: see the module docstring."""
    dev = q.device.type
    if dev == "cuda":
        return _fa_kernel(q, k, v, scale, causal, q_offset, k_offset)
    if dev == "cpu":
        return flash_attention_reference(q, k, v, causal, scale,
                                         q_offset, k_offset)
    if dev == "meta":
        return (torch.empty_like(q),
                torch.empty(q.shape[:-1], dtype=torch.float32,
                            device=q.device))
    raise MXNetError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: int = 0, k_offset: int = 0):
    """(out, lse) attention on (B, H, T, D) -> ((B, H, Tq, D), (B, H, Tq)),
    as ``pallas_kernels.flash_attention_with_lse``."""
    B, H, Tq, D = q.shape
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    out, lse = _fa_fwd_dispatch(q.reshape(B * H, Tq, D),
                                k.reshape(B * H, k.shape[2], D),
                                v.reshape(B * H, v.shape[2], D),
                                sc, causal, q_offset, k_offset)
    return out.reshape(B, H, Tq, D), lse.reshape(B, H, Tq)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    q_offset: int = 0, k_offset: int = 0):
    """Attention on (B, H, T, D) -> (B, H, Tq, D), as
    ``pallas_kernels.flash_attention`` (forward only)."""
    return flash_attention_with_lse(q, k, v, causal, scale, q_offset,
                                    k_offset)[0]

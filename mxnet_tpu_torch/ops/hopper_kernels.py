"""Hand-written Hopper kernels for the ops XLA used to fuse through Pallas.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel is CUDA C++
under ``mxnet_tpu_torch/csrc/``, compiled for ``sm_90a`` with ``nvcc`` at
first use into ``mxnet_tpu_torch/_build/`` (one plain-C shared library per
source, loaded with ``ctypes``; the ``nvcc`` processes run in parallel),
and sits beside a plain PyTorch version of the same function.

Dispatch is by the device of the tensors, nothing else:

* a CPU tensor takes the plain version (the CPU tests run it);
* a CUDA tensor launches the kernel, or raises — there is no fallback and
  no switch that swaps the plain version in on the card;
* a ``meta`` tensor (shape inference) gets empty outputs of the right shape.

Every launch adds one to :data:`launch_counts` under the kernel's name, so
a run can show that its main path went through the kernel, and one to
:data:`launch_dtypes` under the kernel's name and its inputs' dtype, so
that it can show in which dtype.

Kernels:

* ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) — replaces
  ``_fa_kernel``/``_fa_pallas`` (``pallas_kernels.py:63-178``); plain
  version :func:`flash_attention_reference`.
* ``flash_attention_bwd_dkdv`` and ``flash_attention_bwd_dq``
  (``csrc/flash_attention_bwd.cu``) — replace ``flash_attention_bwd``
  (``pallas_kernels.py:220-270``), the backward of the forward's custom
  VJP; plain version :func:`flash_attention_bwd_reference`.
  :func:`flash_attention` and :func:`flash_attention_with_lse` on
  (B, H, T, D) are one ``torch.autograd.Function`` over the two (``lse`` is
  not differentiable, as in the JAX package). Both flash sources run
  their products on the tensor cores through the shared header
  ``csrc/flash_mma.cuh`` (split-TF32 ``mma.sync`` for float32, bf16
  ``mma.sync`` for bfloat16).
* ``softmax_cross_entropy_fwd`` (``csrc/softmax_cross_entropy.cu``) —
  replaces ``_ce_kernel``/``_ce_fwd`` (``pallas_kernels.py:325-367``);
  :func:`softmax_cross_entropy` is a ``torch.autograd.Function`` whose
  backward is ``_ce_bwd``'s ``(softmax − onehot)·g`` in plain PyTorch from
  the saved ``lse``; plain version :func:`softmax_cross_entropy_reference`.
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
           "flash_attention_reference", "flash_attention_bwd_reference",
           "softmax_cross_entropy", "softmax_cross_entropy_reference",
           "launch_counts", "launch_dtypes", "reset_launch_counts", "build",
           "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30  # the TPU kernel's sentinel; ring attention's merge needs it

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
            for name in ("flash_attention_fwd", "flash_attention_bwd",
                         "softmax_cross_entropy")}
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last reset
launch_counts: Dict[str, int] = {
    "flash_attention_fwd": 0, "flash_attention_bwd_dkdv": 0,
    "flash_attention_bwd_dq": 0, "softmax_cross_entropy_fwd": 0}
#: (kernel name, dtype name of its inputs) -> launches since the last reset
launch_dtypes: Dict[Tuple[str, str], int] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
# source -> {C entry: argtypes}; without argtypes ctypes passes Python ints
# as 32-bit C ints and cuts the pointers
_BWD_ARGS = [_VP] * 9 + [_I32] * 5 + [_F32, _I32, _I32, _I32, _VP]
_ENTRIES = {
    "flash_attention_fwd": {
        "mxtt_flash_attention_fwd": ([_VP] * 5 + [_I32] * 5 + [_I64] * 8
                                     + [_F32, _I32, _I32, _I32, _VP])},
    "flash_attention_bwd": {"mxtt_flash_attention_bwd_dkdv": _BWD_ARGS,
                            "mxtt_flash_attention_bwd_dq": _BWD_ARGS},
    "softmax_cross_entropy": {
        "mxtt_softmax_cross_entropy_fwd": [_VP] * 4 + [_I32, _I64, _I64,
                                                        _VP]},
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launch_dtypes.clear()


def _launched(name: str, dtype: torch.dtype) -> None:
    launch_counts[name] += 1
    key = (name, str(dtype).replace("torch.", ""))
    launch_dtypes[key] = launch_dtypes.get(key, 0) + 1


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


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of the source,
    every header beside it (``*.cuh``, which the sources include) and the
    flags: an edited header rebuilds every library."""
    src = _SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library built from the same
    source, headers and flags, one ``nvcc`` per source, all started together;
    returns {source name: library path}."""
    paths = {name: _lib_path(name) for name in _SOURCES}
    todo = [name for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = paths[name].with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs.append((name, tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])   # atomic: a loader sees all or none
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, every entry's argtypes
    declared (all sources are built at the first call)."""
    with _lock:
        if name not in _libs:
            paths = build()
            for src, entries in _ENTRIES.items():
                lib = ctypes.CDLL(str(paths[src]))
                for entry, argtypes in entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = _I32
                lib.mxtt_cuda_error_string.argtypes = [_I32]
                lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
                _libs[src] = lib
        return _libs[name]


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mxtt_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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


def flash_attention_bwd_reference(q, k, v, out, lse, g, scale: float,
                                  causal: bool = False, q_offset: int = 0,
                                  k_offset: int = 0, block_k: int = 128):
    """Plain PyTorch version of the backward kernels, following
    ``flash_attention_bwd`` (``pallas_kernels.py:220-270``) block by block
    over the keys, so no (Tq, Tk) matrix of a whole head is built. (BH, T,
    D) inputs, ``lse`` (BH, Tq) f32, ``g`` = dO -> (dq, dk, dv) in f32.
    Masked positions are selected to 0, so rows whose lse is the −1e30
    sentinel get zero gradients, not NaN."""
    Tq, Tk = q.shape[1], k.shape[1]
    qf, g32 = q.float(), g.float()
    delta = (g32 * out.float()).sum(-1)                        # (BH, Tq)
    qpos = torch.arange(Tq, device=q.device) + q_offset
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, Tk, block_k):
        kblk = k[:, k0:k0 + block_k].float()
        vblk = v[:, k0:k0 + block_k].float()
        s = torch.matmul(qf, kblk.transpose(-1, -2)) * scale
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            kpos = torch.arange(k0, k0 + kblk.shape[1],
                                device=q.device) + k_offset
            mask = qpos[:, None] >= kpos[None, :]
        p = torch.where(mask, torch.exp(s - lse[..., None]),
                        torch.zeros((), device=q.device))
        dvs.append(torch.matmul(p.transpose(-1, -2), g32))
        dp = torch.matmul(g32, vblk.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.matmul(ds, kblk)
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    if not dks:
        return dq, torch.zeros_like(k, dtype=torch.float32), \
            torch.zeros_like(v, dtype=torch.float32)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _check_qkv(what, *ts) -> None:
    q = ts[0]
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise MXNetError(f"{what}: head dim {D} is not supported by the "
                         f"Hopper kernel (supported: {SUPPORTED_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise MXNetError(f"{what}: the Hopper kernel takes float32 or "
                         f"bfloat16 tensors of one dtype, got "
                         f"{', '.join(str(t.dtype) for t in ts)}")
    if any(t.device != q.device for t in ts):
        raise MXNetError(f"{what}: tensors on different devices")


def _fa_kernel(q, k, v, scale, causal, q_offset, k_offset):
    """Launch ``csrc/flash_attention_fwd.cu`` on (BH, T, D) CUDA tensors."""
    _check_qkv("flash_attention", q, k, v)
    D = q.shape[-1]
    BH, Tq, _ = q.shape
    Tk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library("flash_attention_fwd")
    with torch.cuda.device(q.device):
        err = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype], D, BH, Tq, Tk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale), int(bool(causal)), int(q_offset), int(k_offset),
            _stream(q.device))
    _check(lib, err, "flash_attention_fwd launch")
    _launched("flash_attention_fwd", q.dtype)
    return out, lse


def _fa_bwd_launch(which, q, k, v, g, lse, delta, dq, dk, dv, scale, causal,
                   q_offset, k_offset) -> None:
    """Launch one kernel of ``csrc/flash_attention_bwd.cu`` on contiguous
    (BH, T, D) CUDA tensors: ``"dkdv"`` writes dk and dv, ``"dq"`` dq."""
    lib = _library("flash_attention_bwd")
    BH, Tq, D = q.shape
    with torch.cuda.device(q.device):
        err = getattr(lib, f"mxtt_flash_attention_bwd_{which}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODE[q.dtype], D, BH, Tq, k.shape[1],
            float(scale), int(bool(causal)), int(q_offset), int(k_offset),
            _stream(q.device))
    _check(lib, err, f"flash_attention_bwd_{which} launch")
    _launched(f"flash_attention_bwd_{which}", q.dtype)


def _fa_bwd_kernel(q, k, v, out, lse, g, scale, causal, q_offset, k_offset):
    """The backward on (BH, T, D) CUDA tensors: the dK/dV kernel, then the
    dQ kernel. ``delta = rowsum(dO∘O)`` is one torch reduction before them,
    as the JAX function takes it outside its loop."""
    _check_qkv("flash_attention backward", q, k, v, out, g)
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    lse = lse.contiguous()
    delta = (g.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.shape[1] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    for which in ("dkdv", "dq"):
        _fa_bwd_launch(which, q, k, v, g, lse, delta, dq, dk, dv, scale,
                       causal, q_offset, k_offset)
    return dq, dk, dv


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


def _fa_bwd_dispatch(q, k, v, out, lse, g, scale, causal, q_offset,
                     k_offset):
    """(dq, dk, dv) in the inputs' dtypes, by device."""
    dev = q.device.type
    if dev == "cuda":
        return _fa_bwd_kernel(q, k, v, out, lse, g, scale, causal,
                              q_offset, k_offset)
    if dev == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, out, lse, g, scale,
                                              causal, q_offset, k_offset)
        return tuple(d.to(t.dtype) for d, t in zip(grads, (q, k, v)))
    if dev == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    raise MXNetError(f"flash_attention: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """``_flash_core``'s custom VJP: the forward saves (q, k, v, out, lse)
    as ``_flash_core_fwd`` does; the backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, k_offset):
        out, lse = _fa_fwd_dispatch(q, k, v, scale, causal, q_offset,
                                    k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (scale, causal, q_offset, k_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa_bwd_dispatch(q, k, v, out, lse, g_out, *ctx.attrs)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: int = 0, k_offset: int = 0):
    """(out, lse) attention on (B, H, T, D) -> ((B, H, Tq, D), (B, H, Tq)),
    as ``pallas_kernels.flash_attention_with_lse``; differentiable in
    ``out``."""
    B, H, Tq, D = q.shape
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    out, lse = _FlashAttention.apply(q.reshape(B * H, Tq, D),
                                     k.reshape(B * H, k.shape[2], D),
                                     v.reshape(B * H, v.shape[2], D),
                                     sc, causal, q_offset, k_offset)
    return out.reshape(B, H, Tq, D), lse.reshape(B, H, Tq)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    q_offset: int = 0, k_offset: int = 0):
    """Attention on (B, H, T, D) -> (B, H, Tq, D), as
    ``pallas_kernels.flash_attention``: differentiable, with the blockwise
    backward."""
    return flash_attention_with_lse(q, k, v, causal, scale, q_offset,
                                    k_offset)[0]


# ---------------------------------------------------------------------------
# fused softmax cross-entropy
# ---------------------------------------------------------------------------

def softmax_cross_entropy_reference(logits, labels
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: logits (N, C), int64 labels
    (N,) -> (per-row loss, lse), both (N,) float32. ``lse`` is taken in
    float32 as ``_ce_fwd`` takes it; a label in [−C, 0) picks class
    ``C + label`` (``take_along_axis``'s wrap), any other outside [0, C)
    gives a NaN loss."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=1)
    C = x.shape[1]
    labels = torch.where(labels < 0, labels + C, labels)
    valid = (labels >= 0) & (labels < C)
    picked = x.gather(1, labels.clamp(0, max(C - 1, 0))[:, None])[:, 0]
    picked = torch.where(valid, picked,
                         torch.full((), float("nan"), device=x.device))
    return lse - picked, lse


def _ce_kernel(logits, labels):
    """Launch ``csrc/softmax_cross_entropy.cu`` on CUDA (N, C) logits."""
    if logits.dtype not in _DTYPE_CODE:
        raise MXNetError(f"softmax_cross_entropy: the Hopper kernel takes "
                         f"float32 or bfloat16 logits, got {logits.dtype}")
    if labels.device != logits.device:
        raise MXNetError("softmax_cross_entropy: logits and labels on "
                         "different devices")
    N, C = logits.shape
    if tuple(labels.shape) != (N,):
        raise MXNetError(f"softmax_cross_entropy: the kernel reads one "
                         f"label a row, got {tuple(labels.shape)} for {N} "
                         f"rows")
    logits, labels = logits.contiguous(), labels.contiguous()
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    loss = torch.empty_like(lse)
    if N == 0:
        return loss, lse
    lib = _library("softmax_cross_entropy")
    with torch.cuda.device(logits.device):
        err = lib.mxtt_softmax_cross_entropy_fwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            loss.data_ptr(), _DTYPE_CODE[logits.dtype], N, C,
            _stream(logits.device))
    _check(lib, err, "softmax_cross_entropy_fwd launch")
    _launched("softmax_cross_entropy_fwd", logits.dtype)
    return loss, lse


def _ce_fwd_dispatch(logits, labels):
    """(per-row loss, lse), by device."""
    dev = logits.device.type
    if dev == "cuda":
        return _ce_kernel(logits, labels)
    if dev == "cpu":
        return softmax_cross_entropy_reference(logits, labels)
    if dev == "meta":
        n = logits.shape[0]
        return (torch.empty(n, device=logits.device),
                torch.empty(n, device=logits.device))
    raise MXNetError(f"softmax_cross_entropy: no kernel for device "
                     f"{logits.device}")


def softmax_cross_entropy_grad(logits, labels, lse, g):
    """``_ce_bwd`` (``pallas_kernels.py:370-374``) with the softmax taken
    from the saved lse: ``(exp(x − lse) − onehot)·g`` in float32, cast to
    the logits' dtype; a label outside [0, C), negative ones included, has
    no one-hot entry (``jax.nn.one_hot``), unlike the forward's pick. Built
    in place on one (N, C) float32 buffer."""
    C = logits.shape[1]
    grad = (logits.float() - lse[:, None]).exp_()
    valid = ((labels >= 0) & (labels < C)).to(grad.dtype)
    grad.scatter_add_(1, labels.clamp(0, max(C - 1, 0))[:, None],
                      -valid[:, None])
    return grad.mul_(g.float()[:, None]).to(logits.dtype)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """``softmax_cross_entropy``'s custom VJP; saves (logits, labels,
    lse)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = _ce_fwd_dispatch(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_cross_entropy_grad(logits, labels, lse, g), None


def softmax_cross_entropy(logits, labels):
    """Per-row CE ``logsumexp(logits) − logits[label]``: logits (N, C),
    labels (N,) or (1,) of any type (truncated to integers, as the JAX
    package's int32 cast does; one label serves every row, as
    ``take_along_axis`` broadcasts it) -> (N,) float32, differentiable in
    ``logits``. The kernel and the plain version always get N labels."""
    N = logits.shape[0]
    if labels.ndim != 1 or labels.shape[0] not in (1, N):
        raise MXNetError(f"softmax_cross_entropy: labels of shape "
                         f"{tuple(labels.shape)} do not broadcast to the "
                         f"{N} rows of the logits")
    labels = labels.detach().to(torch.int64).expand(N)
    return _SoftmaxCrossEntropy.apply(logits, labels)

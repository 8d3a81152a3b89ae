"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``: a :class:`Context` names a device
(``cpu`` or ``gpu``, plus an id) and maps onto a ``torch.device``. It is
hashable, comparable and usable as a ``with`` target that sets the
thread's default context.

The default context is the card, ``gpu(0)``: entry points run on the GPU
unless the caller asks for the CPU (``mx.cpu()`` or ``with mx.cpu():``).
Resolving a GPU context on a machine without CUDA raises
:class:`~mxnet_tpu_torch.base.MXNetError`; it never falls back to the CPU.
The JAX package's names for its accelerator, ``tpu`` and ``num_tpus``,
name the card here, so that code written for it runs unchanged;
``cpu_pinned`` is a host context.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "num_tpus", "gpu_memory_info"]


class Context:
    """A device context (reference ``python/mxnet/context.py:Context``)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared",
                   6: "tpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
        else:
            if device_type not in ("cpu", "gpu", "cpu_pinned",
                                   "cpu_shared"):
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_type = device_type
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_typeid(self) -> int:
        return self.devstr2type[self.device_type]

    def torch_device(self) -> torch.device:
        """Resolve to a ``torch.device``; a GPU context without CUDA (or
        past the device count) raises."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(f"context {self} asks for the GPU but CUDA is "
                             f"not available; pass mx.cpu() to run on the "
                             f"host")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self}: only {n} GPU(s) present")
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_torch(device: torch.device) -> "Context":
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        return Context("cpu", 0)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx
        return False

    def empty_cache(self) -> None:
        """Return the card's cached, unused blocks to CUDA (the
        reference's ``MXStorageEmptyCache``); nothing on the host."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device()):
                torch.cuda.empty_cache()

    def memory_info(self) -> dict:
        """The device's allocator statistics under the JAX package's keys
        (bytes in use, the limit, the peak; the largest allocation, which
        torch's allocator does not report, is None), plus the count and
        bytes of the tensors alive on it. The host reports no allocator
        statistics (None), as the JAX package's CPU does."""
        import gc
        dev = self.torch_device()
        info = dict.fromkeys(("bytes_in_use", "bytes_limit",
                              "peak_bytes_in_use", "largest_alloc_size"))
        info["device"] = str(dev)
        if dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            info.update({
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.mem_get_info(dev)[1],
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)})
        live_n = live_b = 0
        for obj in gc.get_objects():
            if issubclass(type(obj), torch.Tensor) and obj.device == dev:
                live_n += 1
                live_b += obj.numel() * obj.element_size()
        info["live_arrays"] = live_n
        info["live_array_bytes"] = live_b
        return info


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The JAX package's accelerator context: the card here."""
    return gpu(device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus() -> int:
    return num_gpus()


def gpu_memory_info(device_id: int = 0):
    """(free bytes, total bytes) of the card (``cudaMemGetInfo``); raises
    without CUDA."""
    free, total = torch.cuda.mem_get_info(gpu(device_id).torch_device())
    return (int(free), int(total))


def current_context() -> Context:
    """The thread's ``with ctx:`` scope, else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)

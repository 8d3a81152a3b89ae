"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``: a :class:`Context` names a device
(``cpu`` or ``gpu``, plus an id) and maps onto a ``torch.device``. It is
hashable, comparable and usable as a ``with`` target that sets the
thread's default context.

The default context is the card, ``gpu(0)``: entry points run on the GPU
unless the caller asks for the CPU (``mx.cpu()`` or ``with mx.cpu():``).
Resolving a GPU context on a machine without CUDA raises
:class:`~mxnet_tpu_torch.base.MXNetError`; it never falls back to the CPU.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """A device context (reference ``python/mxnet/context.py:Context``)."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
        else:
            if device_type not in ("cpu", "gpu"):
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_type = device_type
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    def torch_device(self) -> torch.device:
        """Resolve to a ``torch.device``; a GPU context without CUDA (or
        past the device count) raises."""
        if self.device_type == "cpu":
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


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The thread's ``with ctx:`` scope, else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)

"""NDArray over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The array is a tensor on
an explicit device; PyTorch's asynchronous launch on the card's stream gives
the reference's engine semantics (ops return at once, ``asnumpy`` is the
sync point). Mutation rebinds the tensor and bumps a version counter.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["NDArray", "array", "torch_dtype"]


def _to_tensor(source, ctx: Optional[Context], dtype=None) -> torch.Tensor:
    dev = (ctx or current_context()).torch_device()
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.to(dev)
    else:
        a = np.asarray(source)
        if a.dtype == np.float64 and dtype is None:
            a = a.astype(np.float32)     # MXNet's default dtype
        # a copy: the source may be a read-only view (e.g. of file bytes)
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, its name, or a torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    want = getattr(torch, name, None)
    if not isinstance(want, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return want


class NDArray:
    """An n-dimensional array on a device."""

    __slots__ = ("_data", "_version", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        self._version = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one, else the torch dtype (bf16)."""
        try:
            return np.dtype(str(self._data.dtype).replace("torch.", ""))
        except TypeError:
            return self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> Context:
        return Context.from_torch(self._data.device)

    ctx = context

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray " \
               f"{'x'.join(map(str, self.shape))} @{self.context}>"

    def _set_data(self, data) -> None:
        """Rebind to ``data`` (a tensor or array-like), kept on this
        array's device."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        self._data = data.to(self._data.device)
        self._version += 1

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Create an NDArray from any array-like (reference ``mx.nd.array``);
    ``ctx`` defaults to the current context (the GPU)."""
    return NDArray(_to_tensor(source_array, ctx, dtype))

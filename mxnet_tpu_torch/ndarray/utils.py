"""Array creation and the ``MXTPU001`` container.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (``zeros``, ``ones``,
``concat``, ``stack``, ``split``, ``save``, ``load``). The on-disk format is the JAX package's own: the 8-byte magic
``MXTPU001``, a little-endian u64 header length, a JSON header
``{"keys": [...] | null, "metas": [{"shape", "dtype"}, ...]}``, then per
array a u64 byte length and the raw little-endian buffer. The port keeps
its own reader and writer, so it opens files that ``mxnet_tpu`` wrote, and
the reverse. :func:`load` and :func:`load_frombuffer` also read the
reference's ``.params`` format (the dmlc list container, found by its
magic), through :mod:`mxnet_tpu_torch.interop`.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import NDArray, array, torch_dtype

__all__ = ["zeros", "ones", "full", "empty", "arange", "concat", "stack",
           "split", "save", "load", "load_frombuffer", "concatenate",
           "one_hot", "moveaxis"]

_MAGIC = b"MXTPU001"


def _full(shape, value, ctx, dtype) -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.full(shape, value,
                              dtype=torch_dtype(dtype or "float32"),
                              device=(ctx or current_context())
                              .torch_device()))


def zeros(shape, ctx: Optional[Context] = None, dtype=None,
          **kwargs) -> NDArray:
    return _full(shape, 0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype=None,
         **kwargs) -> NDArray:
    return _full(shape, 1, ctx, dtype)


def full(shape, val, ctx: Optional[Context] = None, dtype=None,
         **kwargs) -> NDArray:
    return _full(shape, val, ctx, dtype)


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Zeros, as in the JAX package."""
    return _full(shape, 0, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    """``np.arange`` (each value ``repeat`` times) on ``ctx``."""
    out = np.arange(start, stop, step, dtype=dtype or "float32")
    if repeat > 1:
        out = np.repeat(out, repeat)
    return array(out, ctx=ctx)


def concat(*arrays, dim=1) -> NDArray:
    """``Concat`` of the arrays (or of one list of them)."""
    from .._imperative import invoke
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return invoke("Concat", list(arrays), {"dim": dim})


def stack(*arrays, axis=0) -> NDArray:
    """``stack`` of the arrays (or of one list of them)."""
    from .._imperative import invoke
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return invoke("stack", list(arrays), {"axis": axis})


def split(ary, indices_or_sections, axis=0):
    """``SliceChannel`` into equal sections (an int), else ``split_v2``
    at the indices."""
    from .._imperative import invoke
    if isinstance(indices_or_sections, int):
        return invoke("SliceChannel", [ary],
                      {"num_outputs": indices_or_sections, "axis": axis})
    return invoke("split_v2", [ary],
                  {"indices": tuple(indices_or_sections), "axis": axis})


def concatenate(arrays, axis=0) -> NDArray:
    return concat(*arrays, dim=axis)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    from .._imperative import invoke
    return invoke("one_hot", [indices], {
        "depth": depth, "on_value": on_value, "off_value": off_value,
        "dtype": dtype})


def moveaxis(tensor, source, destination) -> NDArray:
    """``tensor`` with axis ``source`` moved to ``destination`` (a
    transpose)."""
    ax = list(range(tensor.ndim))
    ax.remove(source % tensor.ndim)
    ax.insert(destination % tensor.ndim, source % tensor.ndim)
    return tensor.transpose(*ax)


def _raw(a) -> tuple:
    """(bytes, shape, dtype name) of an NDArray, tensor or array-like."""
    t = a._data if isinstance(a, NDArray) else a
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bf16: ship the bits
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        t = t.numpy()
    t = np.ascontiguousarray(t)
    return t.tobytes(), list(t.shape), str(t.dtype)


def save(fname: str, data) -> None:
    """Save a list or str-keyed dict of arrays (reference ``mx.nd.save``)."""
    if isinstance(data, NDArray):
        data = [data]
    keys = list(data) if isinstance(data, dict) else None
    arrays = [data[k] for k in keys] if keys is not None else list(data)
    raws = [_raw(a) for a in arrays]
    header = json.dumps({"keys": keys, "metas": [
        {"shape": shape, "dtype": dt} for _, shape, dt in raws]}).encode()
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for blob, _, _ in raws:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)


def _load_stream(f, label: str, ctx: Optional[Context]):
    magic = f.read(8)
    if magic != _MAGIC:
        from .. import interop
        if not interop._is_reference_head(magic):
            raise MXNetError(f"{label}: not an MXTPU001 NDArray file (magic "
                             f"{magic!r}) and not a reference .params file "
                             f"either")
        f.seek(0)
        data = f.getvalue() if isinstance(f, io.BytesIO) else f.read()
        arrays, names = interop._ndarrays_from_bytes(
            data, label, ctx or current_context())
        return dict(zip(names, arrays)) if names else arrays
    (hlen,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(hlen).decode())
    arrays = []
    for meta in header["metas"]:
        (blen,) = struct.unpack("<Q", f.read(8))
        buf = f.read(blen)
        if meta["dtype"] == "bfloat16":
            t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
            arrays.append(array(t.reshape(meta["shape"]), ctx=ctx))
        else:
            arrays.append(array(np.frombuffer(buf, dtype=meta["dtype"])
                                .reshape(meta["shape"]), ctx=ctx))
    if header["keys"] is None:
        return arrays
    return dict(zip(header["keys"], arrays))


def load(fname: str, ctx: Optional[Context] = None):
    """Load arrays saved by :func:`save` (or by ``mxnet_tpu``'s, or by the
    reference's ``mx.nd.save``) onto ``ctx`` (default: the current
    context); a dict where the file names its arrays, else a list."""
    with open(fname, "rb") as f:
        return _load_stream(f, fname, ctx)


def load_frombuffer(buf: bytes, ctx: Optional[Context] = None):
    """:func:`load` from an in-memory file image."""
    return _load_stream(io.BytesIO(buf), "<buffer>", ctx)

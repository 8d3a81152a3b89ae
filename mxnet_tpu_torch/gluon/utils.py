"""Gluon utilities: batch splitting, global-norm clipping, file hashes.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``). ``clip_global_norm`` scales the arrays
in place (``a *= scale``), so a list of ``Parameter.grad`` buffers is
clipped where the trainer reads it. ``download`` raises: the package
fetches nothing.
"""
from __future__ import annotations

import hashlib
import math
from typing import List

import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"batch size {size} must be divisible by number of slices "
            f"{num_slice}; set even_split=False")
    step = size // num_slice
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """:func:`split_data`, each slice on its context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale the arrays in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before. The squared norms are summed
    on the host in float64, one array after another, as the JAX package
    sums them, after one read of the card."""
    if not arrays:
        return 0.0
    squares = torch.stack([nd.sum(a * a)._data for a in arrays])
    norm = math.sqrt(sum(squares.double().cpu().tolist()))
    if check_isfinite and not math.isfinite(norm):
        raise MXNetError(f"global norm is {norm}: gradients exploded/NaN")
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return norm


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download: this environment has no network egress; "
                     "place files locally and pass their path instead")

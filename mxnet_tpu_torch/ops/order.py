"""Ordering ops: ``sort``, ``argsort`` and ``topk``.

Counterpart of ``mxnet_tpu/ops/order.py`` (reference
``src/operator/tensor/ordering_op.cc``). Every sort is stable, as
``jnp.argsort`` is, so ties keep their order: ``topk`` takes the lower
index first, and a descending ``sort``/``argsort`` is the ascending one
reversed (the higher index first), as in the JAX package. On the card
``torch.topk`` does not order ties stably, so ``topk`` sorts. Indices are
float32 unless ``dtype`` says otherwise.

``topk(ret_typ="mask")`` gives 1 at the top-k positions along the axis.
The JAX package's mask sums its one-hot rows over the wrong axis for a
negative ``axis`` (the default, −1): there it raises for an n-D input
unless ``k`` is 1 or the whole axis, and gives all ones for ``k`` = 1.
"""
from __future__ import annotations

import torch

from .registry import register


def _flat(x, axis):
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


@register("sort")
def _sort(x, axis=-1, is_ascend=True):
    x, ax = _flat(x, axis)
    out = torch.sort(x, dim=ax, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(ax,))


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    from ..ndarray.ndarray import torch_dtype
    x, ax = _flat(x.detach(), axis)
    idx = torch.argsort(x, dim=ax, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(ax,))
    return idx.to(torch_dtype(dtype))


def _topk_nout(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout, differentiable=False)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    from ..base import MXNetError
    from ..ndarray.ndarray import torch_dtype
    x, ax = _flat(x.detach(), axis)
    k = int(k) if int(k) > 0 else x.shape[ax]
    key = x if is_ascend else -x
    idx = torch.argsort(key, dim=ax, stable=True).narrow(ax, 0, k)
    if ret_typ == "value":
        return torch.gather(x, ax, idx)
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return torch.gather(x, ax, idx), idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(ax, idx, 1.0)
    raise MXNetError(f"bad ret_typ {ret_typ}")

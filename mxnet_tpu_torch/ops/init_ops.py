"""Creation ops.

Counterpart of ``mxnet_tpu/ops/init_ops.py`` (reference
``src/operator/tensor/init_op.cc``): ``zeros``, ``ones``, ``full``,
``arange`` (with ``repeat``), ``linspace``, ``eye`` and the ``*_like``
pair, float32 unless ``dtype`` says otherwise. An op without array
inputs takes its ``device`` from the caller: the current context
imperatively, the device of the graph's inputs in the executor.
``arange`` and ``eye`` take numpy's values (``jnp.arange`` of concrete
bounds is ``np.arange``), made on the host and copied once.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _dt(dtype):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(dtype or "float32")


def _full(shape, value, dtype, device):
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, value, dtype=_dt(dtype), device=device)


@register("_zeros", aliases=["zeros"], differentiable=False)
def _zeros(shape=(), dtype="float32", device=None):
    return _full(shape, 0.0, dtype, device)


@register("_ones", aliases=["ones"], differentiable=False)
def _ones(shape=(), dtype="float32", device=None):
    return _full(shape, 1.0, dtype, device)


@register("_full", aliases=["full"], differentiable=False)
def _full_op(shape=(), value=0.0, dtype="float32", device=None):
    return _full(shape, value, dtype, device)


def _from_numpy(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=_dt(dtype))


@register("_arange", aliases=["arange"], differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", device=None):
    out = np.arange(start, stop, step, dtype=np.dtype(dtype or "float32"))
    if int(repeat) > 1:
        out = np.repeat(out, int(repeat))
    return _from_numpy(out, dtype, device)


@register("_linspace", aliases=["linspace"], differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              device=None):
    num = int(num)
    if endpoint:
        return torch.linspace(float(start), float(stop), num,
                              dtype=_dt(dtype), device=device)
    step = (float(stop) - float(start)) / num
    return torch.linspace(float(start), float(stop) - step, num,
                          dtype=_dt(dtype), device=device)


@register("_eye", aliases=["eye"], differentiable=False)
def _eye(N=0, M=0, k=0, dtype="float32", device=None):
    return _from_numpy(np.eye(int(N), int(M) or None, k=int(k)), dtype,
                       device)


register("zeros_like", differentiable=False)(lambda x: torch.zeros_like(x))
register("ones_like", differentiable=False)(lambda x: torch.ones_like(x))

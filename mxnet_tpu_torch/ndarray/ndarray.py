"""NDArray over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The array is a tensor on
an explicit device; PyTorch's asynchronous launch on the card's stream gives
the reference's engine semantics (ops return at once, ``asnumpy`` is the
sync point). Mutation rebinds the tensor and bumps a version counter; a
variable (``attach_grad``) stays a variable across a rebind. Arithmetic,
``reshape`` and any registered op called as a method go through the op
registry, so they are recorded under ``autograd.record()``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._imperative import invoke
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

    __slots__ = ("_data", "_grad", "_grad_req", "_version", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        self._grad: Optional[NDArray] = None
        self._grad_req = "null"
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

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer of a variable, else None."""
        return self._grad

    def asnumpy(self) -> np.ndarray:
        """A copy on the host: a CPU tensor's numpy view would change with
        the in-place updates of gradients, weights and moving statistics."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the array is not scalar")
        return self.asnumpy().reshape(())[()]

    def __float__(self):
        return float(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray " \
               f"{'x'.join(map(str, self.shape))} @{self.context}>"

    def _set_data(self, data) -> None:
        """Rebind to ``data`` (a tensor or array-like), kept on this
        array's device; a variable's new tensor is a leaf again."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        data = data.to(self._data.device)
        if self._data.requires_grad and self._data.is_leaf:
            data = data.detach().requires_grad_(data.is_floating_point())
        self._data = data
        self._version += 1

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        """A copy in ``dtype``, outside any recorded graph (as in the JAX
        package)."""
        want = torch_dtype(dtype)
        if not copy and self._data.dtype == want:
            return self
        return NDArray(self._data.detach().to(want, copy=True))

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Make this array a variable with a zero gradient buffer
        (reference ``MXAutogradMarkVariables``)."""
        from .. import autograd
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data.detach()))],
            grad_req)

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------- arithmetic
    def _binop(self, op, other, scalar_op, reverse=False):
        """``op`` with another NDArray, ``scalar_op`` with a number."""
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op, [a, b], {})
        return invoke(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o): return self._binop("broadcast_add", o, "_plus_scalar")
    def __radd__(self, o): return self._binop("broadcast_add", o, "_plus_scalar")
    def __sub__(self, o): return self._binop("broadcast_sub", o, "_minus_scalar")
    def __rsub__(self, o): return self._binop("broadcast_sub", o, "_rminus_scalar", True)
    def __mul__(self, o): return self._binop("broadcast_mul", o, "_mul_scalar")
    def __rmul__(self, o): return self._binop("broadcast_mul", o, "_mul_scalar")
    def __truediv__(self, o): return self._binop("broadcast_div", o, "_div_scalar")
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, "_rdiv_scalar", True)
    def __pow__(self, o): return self._binop("broadcast_power", o, "_power_scalar")
    def __rpow__(self, o): return self._binop("broadcast_power", o, "_rpower_scalar", True)
    def __neg__(self): return invoke("negative", [self], {})
    def __abs__(self): return invoke("abs", [self], {})

    # ------------------------------------------------------------- op methods
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return invoke("Reshape", [self], {"shape": tuple(shape),
                                          "reverse": kwargs.pop("reverse",
                                                                False)})

    def __getattr__(self, name):
        """Any registered op as a method taking this array as its first
        input (the reference's generated methods: ``x.mean(axis=1)``)."""
        from ..ops.registry import _REGISTRY
        if name.startswith("_") or name not in _REGISTRY:
            raise AttributeError(f"NDArray has no attribute {name!r}")

        def method(*args, **kwargs):
            ins = [self] + [a for a in args if isinstance(a, NDArray)]
            scalars = [a for a in args if not isinstance(a, NDArray)]
            if len(scalars) == 1 and "axis" not in kwargs:
                kwargs["axis"] = scalars[0]
            out = kwargs.pop("out", None)
            return invoke(name, ins, kwargs, out=out)

        return method


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Create an NDArray from any array-like (reference ``mx.nd.array``);
    ``ctx`` defaults to the current context (the GPU)."""
    return NDArray(_to_tensor(source_array, ctx, dtype))

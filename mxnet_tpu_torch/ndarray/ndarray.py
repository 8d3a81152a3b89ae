"""NDArray over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The array is a tensor on
an explicit device; PyTorch's asynchronous launch on the card's stream gives
the reference's engine semantics (ops return at once, ``asnumpy`` is the
sync point). Mutation rebinds the tensor and bumps a version counter; a
variable (``attach_grad``) stays a variable across a rebind. Arithmetic,
``reshape`` and any registered op called as a method go through the op
registry, so they are recorded under ``autograd.record()``.

In-place arithmetic (``a *= s``) and item assignment (``a[k] = v``) write
the result into the same array, as the JAX package's ``_inplace`` and
``__setitem__`` do: every name bound to the array sees it, a
``Parameter``'s gradient buffer among them, while a tensor taken from the
array before (a view, an ``asnumpy`` copy) keeps the old value. Indexing
returns a view; under ``autograd.record()`` it is recorded.
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
    def stype(self) -> str:
        """The storage type: ``"default"`` (dense; the sparse classes of
        :mod:`.sparse` say ``"row_sparse"`` or ``"csr"``)."""
        return "default"

    @property
    def context(self) -> Context:
        return Context.from_torch(self._data.device)

    ctx = context

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer of a variable, else None."""
        return self._grad

    def wait_to_read(self) -> None:
        """Block until the work that writes this array is done."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

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

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray " \
               f"{'x'.join(map(str, self.shape))} @{self.context}>"

    def _set_data(self, data) -> None:
        """Rebind to ``data`` (a tensor or array-like), kept on this
        array's device; a variable's new tensor is a leaf again."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        data = data.to(self._data.device)
        if self._leaf():
            data = data.detach().requires_grad_(data.is_floating_point())
        self._data = data
        self._version += 1

    def copyto(self, other):
        """A copy on ``other`` (a Context), or written into ``other`` (an
        NDArray, which keeps its device)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        other._set_data(self._data.detach().clone())
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    as_in_ctx = as_in_context

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

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key) -> "NDArray":
        """A view (float index arrays truncate to integers)."""
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[_index(key)])

    def __setitem__(self, key, value) -> None:
        """Write ``value`` (broadcast) at ``key``: the array is rebound to
        the new values (the JAX package's ``.at[key].set``)."""
        from .. import autograd
        if isinstance(value, NDArray):
            value = value._data
        with torch.set_grad_enabled(autograd.is_recording()):
            out = (self._data.detach() if self._leaf()
                   else self._data).clone()
            out[_index(key)] = torch.as_tensor(value, dtype=out.dtype,
                                               device=out.device)
        self._set_data(out)

    def slice_assign(self, rhs, begin, end, step=None) -> "NDArray":
        """``self[begin:end:step] = rhs`` over the leading axes."""
        step = step or (None,) * len(begin)
        key = tuple(slice(b, e, s if s not in (None, 0) else 1)
                    for b, e, s in zip(begin, end, step))
        self[key] = rhs
        return self

    def _leaf(self) -> bool:
        return self._data.requires_grad and self._data.is_leaf

    # ------------------------------------------------------------- arithmetic
    def _binop(self, op, other, scalar_op, reverse=False):
        """``op`` with another NDArray (or an array-like, made one on this
        array's device), ``scalar_op`` with a number."""
        if np.isscalar(other):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        if not isinstance(other, NDArray):
            other = array(other, ctx=self.context)
        a, b = (other, self) if reverse else (self, other)
        return invoke(op, [a, b], {})

    def _inplace(self, op, other, scalar_op) -> "NDArray":
        self._set_data(self._binop(op, other, scalar_op)._data)
        return self

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
    def __mod__(self, o): return self._binop("broadcast_mod", o, "_mod_scalar")
    def __rmod__(self, o): return self._binop("broadcast_mod", o, "_rmod_scalar", True)
    def __matmul__(self, o): return invoke("dot", [self, o], {})
    def __neg__(self): return invoke("negative", [self], {})
    def __abs__(self): return invoke("abs", [self], {})

    def __eq__(self, o): return self._binop("broadcast_equal", o, "_equal_scalar")
    def __ne__(self, o): return self._binop("broadcast_not_equal", o, "_not_equal_scalar")
    def __gt__(self, o): return self._binop("broadcast_greater", o, "_greater_scalar")
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o, "_greater_equal_scalar")
    def __lt__(self, o): return self._binop("broadcast_lesser", o, "_lesser_scalar")
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o, "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __iadd__(self, o): return self._inplace("broadcast_add", o, "_plus_scalar")
    def __isub__(self, o): return self._inplace("broadcast_sub", o, "_minus_scalar")
    def __imul__(self, o): return self._inplace("broadcast_mul", o, "_mul_scalar")
    def __itruediv__(self, o): return self._inplace("broadcast_div", o, "_div_scalar")

    # ------------------------------------------------------------- op methods
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return invoke("Reshape", [self], {"shape": tuple(shape),
                                          "reverse": kwargs.pop("reverse",
                                                                False)})

    def broadcast_to(self, shape) -> "NDArray":
        return invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other) -> "NDArray":
        return invoke("broadcast_like", [self, other], {})

    def reshape_like(self, other) -> "NDArray":
        return invoke("reshape_like", [self, other], {})

    def expand_dims(self, axis) -> "NDArray":
        return invoke("expand_dims", [self], {"axis": axis})

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes or None})

    def flatten(self) -> "NDArray":
        return invoke("Flatten", [self], {})

    def squeeze(self, axis=None) -> "NDArray":
        return invoke("squeeze", [self], {"axis": axis})

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


def _index(key):
    """An indexing key with NDArrays as int64 tensors."""
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    if isinstance(key, NDArray):
        key = key._data
        return key if key.dtype == torch.bool else key.to(torch.int64)
    return key


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Create an NDArray from any array-like (reference ``mx.nd.array``);
    ``ctx`` defaults to the current context (the GPU)."""
    return NDArray(_to_tensor(source_array, ctx, dtype))

"""Frontend-defined custom operators (``mx.operator``).

Counterpart of ``mxnet_tpu/operator.py`` (reference
``python/mxnet/operator.py`` over ``src/operator/custom/custom-inl.h``):
``CustomOp`` / ``CustomOpProp`` / ``register`` and ``Custom``.

* :func:`Custom` (``mx.nd.Custom``) is one ``torch.autograd.Function``.
  Its forward runs the user's ``forward`` under ``autograd.pause()`` into
  outputs the bridge allocates (zeros, of the shapes and types
  ``prop.infer_shape`` / ``infer_type`` give); its backward runs the
  user's ``backward`` with zeroed ``in_grad`` buffers, and torch autograd
  carries the result on. Positional inputs are the op's arguments followed
  by its auxiliary states; auxiliary states are passed as they are (the
  user may update them in place) and take no gradient. An op whose prop
  says ``need_top_grad() == False`` is a loss head: its ``backward`` gets
  the head gradient but need not read it.
* The JAX package pushes the user's ``forward`` onto its host dependency
  engine (``MXNET_CUSTOM_OP_ASYNC``). The port runs it on the caller's
  thread: a forward that launches CUDA work (``mx.rtc`` kernels, torch
  ops) still only queues it on the stream, so the device stays
  asynchronous; a forward that reads numpy synchronises, as it must.
* The graph-mode ``Custom`` op (``mx.sym.Custom``, run by the executor)
  is forward only, as the JAX package's ``jax.pure_callback`` island is
  (``differentiable=False``). On ``meta`` tensors (shape inference) it
  answers from ``prop.infer_shape`` / ``infer_type`` and never calls the
  user's ``forward``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls", "Custom"]

_CUSTOM_OPS: Dict[str, type] = {}


def _as_tensor(src, like: torch.Tensor) -> torch.Tensor:
    if isinstance(src, NDArray):
        return src._data
    if isinstance(src, torch.Tensor):
        return src
    return torch.as_tensor(np.asarray(src), device=like.device)


class CustomOp(object):
    """Base class for custom operator implementations."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs; write them via ``self.assign``."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients; write them via ``self.assign``."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by the request: in place for
        ``write``/``inplace``, added for ``add``, nothing for ``null``.
        ``dst`` keeps its tensor (it is never rebound)."""
        if req in ("null", None):
            return
        t = dst._data
        s = _as_tensor(src, t)
        with torch.no_grad():
            if req in ("write", "inplace"):
                t.copy_(s)
            elif req == "add":
                t.add_(s.to(t.device, t.dtype))
            else:
                raise MXNetError("unknown req %s" % req)


class CustomOpProp(object):
    """Describes a custom op: its arguments, outputs, shapes and types."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad
        self.kwargs: Dict[str, str] = {}

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        """Default: all outputs and aux take the first input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), \
            [in_shape[0]] * len(self.list_auxiliary_states())

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def need_top_grad(self) -> bool:
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Decorator registering a CustomOpProp subclass under ``reg_name``."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("can only register subclasses of CustomOpProp")
        _CUSTOM_OPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop_cls(op_type: str) -> type:
    if op_type not in _CUSTOM_OPS:
        raise MXNetError("custom op %r is not registered" % op_type)
    return _CUSTOM_OPS[op_type]


def _make_prop(op_type, kwargs: Dict[str, Any]) -> CustomOpProp:
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop_cls = get_prop_cls(op_type)
    # the reference passes user kwargs to the prop as strings
    kw = {k: str(v) for k, v in kwargs.items()}
    prop = prop_cls(**kw)
    prop.kwargs = kw
    return prop


class _Call:
    """One call's prop, operator and split of its inputs."""

    def __init__(self, op_type, kwargs, inputs: List[torch.Tensor]):
        self.op_type = op_type
        self.prop = _make_prop(op_type, kwargs)
        self.n_args = len(self.prop.list_arguments())
        n_aux = len(self.prop.list_auxiliary_states())
        if len(inputs) != self.n_args + n_aux:
            raise MXNetError(
                f"custom op {op_type} expects {self.n_args} inputs "
                f"{self.prop.list_arguments()} and {n_aux} auxiliary states, "
                f"got {len(inputs)} arrays")
        self.in_shapes = [tuple(t.shape) for t in inputs[:self.n_args]]
        self.in_types = [NDArray(t).dtype for t in inputs[:self.n_args]]
        _, self.out_shapes, _ = self.prop.infer_shape(self.in_shapes)
        _, self.out_types, _ = self.prop.infer_type(self.in_types)

    def empty_outputs(self, device) -> List[torch.Tensor]:
        return [torch.empty(tuple(s), dtype=torch_dtype(t), device=device)
                for s, t in zip(self.out_shapes, self.out_types)]

    def run_forward(self, inputs: List[torch.Tensor], is_train: bool):
        """The user's forward on ``inputs`` (arguments then aux) into new
        zeroed outputs; returns (operator, in_data, out_data, aux)."""
        from . import autograd
        from .context import Context
        dev = inputs[0].device
        op = self.prop.create_operator(Context.from_torch(dev),
                                       self.in_shapes, self.in_types)
        in_data = [NDArray(t.detach()) for t in inputs[:self.n_args]]
        aux = [NDArray(t) for t in inputs[self.n_args:]]
        out_data = [NDArray(t.zero_()) for t in self.empty_outputs(dev)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(out_data),
                       in_data=in_data, out_data=out_data, aux=aux)
        return op, in_data, out_data, aux


class _CustomFunction(torch.autograd.Function):
    """The imperative bridge: ``forward(ctx, call, is_train, n_in, *inputs
    then aux)``."""

    @staticmethod
    def forward(ctx, call, is_train, *tensors):
        op, in_data, out_data, aux = call.run_forward(list(tensors),
                                                      is_train)
        ctx.call, ctx.op, ctx.aux = call, op, aux
        ctx.save_for_backward(*[x._data for x in in_data],
                              *[o._data for o in out_data])
        ctx.set_materialize_grads(False)
        outs = tuple(o._data for o in out_data)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        from . import autograd
        call = ctx.call
        saved = ctx.saved_tensors
        in_t, out_t = saved[:call.n_args], saved[call.n_args:]
        out_grad = [NDArray(g if g is not None
                            else torch.zeros((), dtype=o.dtype,
                                             device=o.device).expand(o.shape))
                    for g, o in zip(grads, out_t)]
        in_grad = [NDArray(torch.zeros_like(t)) for t in in_t]
        with autograd.pause():
            ctx.op.backward(req=["write"] * len(in_grad), out_grad=out_grad,
                            in_data=[NDArray(t) for t in in_t],
                            out_data=[NDArray(t) for t in out_t],
                            in_grad=in_grad, aux=ctx.aux)
        needs = ctx.needs_input_grad[2:2 + call.n_args]
        return (None, None) + tuple(
            g._data if need else None for g, need in zip(in_grad, needs)) \
            + (None,) * (len(ctx.needs_input_grad) - 2 - call.n_args)


def Custom(*inputs, op_type=None, name=None, **kwargs):
    """Imperative custom-op call: ``mx.nd.Custom(x, ..., op_type=name)``.

    Positional inputs are the op's arguments followed by its auxiliary
    states. Recorded by torch autograd under ``autograd.record()``; the
    output (a list of them for several) is on the inputs' device."""
    from . import autograd
    from .ndarray.ndarray import array
    arrays = [x if isinstance(x, NDArray) else array(x) for x in inputs]
    if not arrays:
        raise MXNetError("Custom needs at least one input")
    tensors = [a._data for a in arrays]
    call = _Call(op_type, kwargs, tensors)
    with torch.set_grad_enabled(autograd.is_recording()):
        out = _CustomFunction.apply(call, autograd.is_training(), *tensors)
    outs = out if isinstance(out, tuple) else (out,)
    res = [NDArray(o) for o in outs]
    return res[0] if len(res) == 1 else res


def _register_symbolic_custom():
    """The graph-mode ``Custom`` op, forward only."""
    from .ops.registry import register as op_register

    def _n_out(attrs):
        kw = {k: v for k, v in attrs.items() if k != "op_type"}
        return len(_make_prop(attrs.get("op_type"), kw).list_outputs())

    @op_register("Custom", num_outputs=_n_out, differentiable=False)
    def _custom(*inputs, op_type=None, **kw):
        call = _Call(op_type, kw, list(inputs))
        if inputs[0].device.type == "meta":
            outs = call.empty_outputs(inputs[0].device)
        else:
            outs = [o._data for o in
                    call.run_forward(list(inputs), is_train=False)[2]]
        return outs[0] if len(outs) == 1 else tuple(outs)


_register_symbolic_custom()

"""Autograd: record, pause, train/predict mode, backward and grad.

Counterpart of ``mxnet_tpu/autograd.py`` (reference
``python/mxnet/autograd.py`` over ``src/imperative/imperative.cc``).
Where the JAX package keeps a tape of ``jax.vjp`` closures, the port keeps
no tape of its own: an op invoked while recording runs with torch's grad
mode on, so torch autograd records it; outside :func:`record` (and inside
:func:`pause`) ops run with grad mode off and build no graph.

A variable is an NDArray whose tensor is a torch leaf that requires grad
(:func:`mark_variables`, ``NDArray.attach_grad``). :func:`backward` asks
torch for the gradients of every live variable and delivers them by the
variable's ``grad_req``, the reference's rules rather than torch's
accumulation into ``.grad``: ``write`` overwrites the gradient buffer,
``add`` adds to it, ``null`` takes nothing. A head without a head
gradient is seeded with ones, as in the reference, given to torch as one
element expanded to the head's shape (a loss head of 8192 × 50272 floats
needs no 1.6 GB of ones).

:class:`Function` is a user-defined differentiable function over
``torch.autograd.Function`` (counterpart of ``mxnet_tpu/autograd.py:
563-616``).
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward", "grad",
           "mark_variables", "get_symbol", "Function"]

_state = threading.local()
# id -> NDArray of every array marked as a variable (held weakly)
_variables: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(flag: bool) -> bool:
    """Turn recording on or off; returns the previous state."""
    st = _st()
    old, st.recording = st.recording, bool(flag)
    return old


def set_training(flag: bool) -> bool:
    """Turn training mode on or off; returns the previous state."""
    st = _st()
    old, st.training = st.training, bool(flag)
    return old


def get_symbol(x):
    """Raises, as the JAX package's does: the tape is torch autograd's, not
    a graph of NNVM nodes; hybridize a block to obtain a graph."""
    raise MXNetError("get_symbol: the port records torch autograd's graph, "
                     "not NNVM nodes; use hybridize() or export() to "
                     "obtain a graph")


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old
        return False


def record(train_mode: bool = True) -> _Scope:
    """Record the ops inside the block for :func:`backward`."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Stop recording inside the block."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each array a variable (a torch leaf that requires grad, its
    history dropped) with ``gradients[i]`` as its gradient buffer."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        t = v._data.detach()
        v._data = t.requires_grad_(req != "null" and t.is_floating_point())
        v._grad = g
        v._grad_req = req
        _variables[id(v)] = v


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is not None:
        if not isinstance(head_grads, (list, tuple)):
            raise MXNetError("head_grads must be None or a list/tuple "
                             "matching heads; got "
                             f"{type(head_grads).__name__}")
        if len(head_grads) != len(heads):
            raise MXNetError(f"head_grads length {len(head_grads)} does not "
                             f"match heads length {len(heads)}")
    tensors, grads = [], []
    for i, h in enumerate(heads):
        if not h._data.requires_grad:
            raise MXNetError("head array is not part of a recorded graph "
                             "(did you compute it under autograd.record()?)")
        tensors.append(h._data)
        hg = None if head_grads is None else head_grads[i]
        grads.append(torch.ones((), dtype=h._data.dtype,
                                device=h._data.device).expand(h._data.shape)
                     if hg is None
                     else hg._data if isinstance(hg, NDArray) else hg)
    return tensors, grads


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Deliver the gradients of ``heads`` (seeded with ``head_grads``, ones
    by default) to every variable by its ``grad_req``."""
    tensors, grads = _heads(heads, head_grads)
    live = [v for v in list(_variables.values())
            if v._grad_req != "null" and v._data.requires_grad]
    if not live:
        return
    got = torch.autograd.grad(tensors, [v._data for v in live], grads,
                              retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(live, got):
            if g is None:
                continue              # not reached from the heads
            if v._grad_req == "add":
                v._grad._data.add_(g)
            else:   # contiguous: g may be a head's expanded ones
                v._grad._data = g.to(v._grad._data.dtype).contiguous()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays; no gradient buffer is touched. With ``create_graph`` the
    gradients are themselves recorded, so they can be differentiated."""
    from .ndarray.ndarray import NDArray
    tensors, grads = _heads(heads, head_grads)
    if isinstance(variables, NDArray):
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    got = torch.autograd.grad(tensors, [v._data for v in variables], grads,
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    return [NDArray(g if g is not None else torch.zeros_like(v._data))
            for v, g in zip(variables, got)]


class _FunctionBridge(torch.autograd.Function):
    """Runs a :class:`Function`'s ``forward`` and ``backward`` on NDArrays
    with recording paused."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outputs = func.forward(*[NDArray(t.detach()) for t in tensors])
        ctx.func = func
        func._single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if func._single else list(outputs)
        return tuple(o._data for o in outs) if len(outs) > 1 \
            else outs[0]._data

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            gs = ctx.func.backward(*[NDArray(g) for g in grads])
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        n_in = len(ctx.needs_input_grad) - 1
        if len(gs) != n_in:
            raise MXNetError(f"{type(ctx.func).__name__}.backward returned "
                             f"{len(gs)} gradients for {n_in} inputs")
        return (None,) + tuple(
            (g._data if isinstance(g, NDArray) else g) if need else None
            for g, need in zip(gs, ctx.needs_input_grad[1:]))


class Function:
    """Custom differentiable function (reference ``autograd.Function``).
    Subclass it and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; ``backward`` returns
    one gradient per input. Use a new instance for each call."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        with torch.set_grad_enabled(is_recording()):
            out = _FunctionBridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray(o) for o in (out if isinstance(out, tuple)
                                     else (out,))]
        return outs[0] if self._single else outs

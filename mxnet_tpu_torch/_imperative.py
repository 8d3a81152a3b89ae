"""Imperative op invocation.

Counterpart of ``mxnet_tpu/_imperative.py``. PyTorch dispatches each op
eagerly and asynchronously on the card's stream, so invoking an op is a
plain call of its registered function; there is no compiled-executable
cache. :func:`invoke` runs the op with torch's grad mode on exactly while
``autograd.record()`` is on, so torch autograd is the tape, and passes
``is_train = autograd.is_training()`` to ops that take it.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Sequence

import torch

from . import random as _random
from .ops.registry import OpDef, get_op

__all__ = ["invoke", "invoke_raw"]


def _op_signature_flags(opdef: OpDef):
    """(accepts ``is_train``, accepts ``rng``) of an op's function."""
    if not hasattr(opdef, "_sig_flags"):
        params = inspect.signature(opdef.fn).parameters
        opdef._sig_flags = ("is_train" in params, "rng" in params)
    return opdef._sig_flags


def invoke_raw(op_name: str, inputs: Sequence[Any], attrs: Dict[str, Any],
               is_train: bool = False):
    """Run an op on raw tensors, returning raw tensor(s). A random op draws
    from the generator of its first input's device."""
    opdef = get_op(op_name)
    accepts_train, accepts_rng = _op_signature_flags(opdef)
    attrs = dict(attrs)
    if accepts_train and "is_train" not in attrs:
        attrs["is_train"] = is_train
    if accepts_rng and attrs.get("rng") is None and inputs:
        attrs["rng"] = _random.generator(inputs[0].device)
    return opdef.fn(*inputs, **attrs)


def invoke(op_name: str, inputs, attrs, out=None):
    """Entry of the generated ``mx.nd.*`` functions: unwraps NDArrays,
    runs the op, rewraps the output(s)."""
    from . import autograd
    from .ndarray.ndarray import NDArray
    with torch.set_grad_enabled(autograd.is_recording()):
        raw = invoke_raw(op_name, [x._data if isinstance(x, NDArray) else x
                                   for x in inputs], attrs,
                         is_train=autograd.is_training())
    outs = [NDArray(o) for o in (raw if isinstance(raw, tuple) else (raw,))]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, outs):
            t._set_data(o._data)
        return out
    return outs[0] if len(outs) == 1 else outs

"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``: an op is a plain function
``fn(*tensors, **attrs)`` over ``torch.Tensor``s, registered under its
MXNet name (plus aliases). The ``mx.nd`` and ``mx.sym`` namespaces are
generated from this registry.

Shape inference runs the op itself on ``torch.device("meta")`` tensors,
where the JAX package uses ``jax.eval_shape``. PyTorch runs eagerly, so
there is no per-op compiled-executable cache (the JAX package's
``jitted_op``).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Sequence

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "alias"]

_REGISTRY: Dict[str, "OpDef"] = {}


class OpDef:
    """One registered operator; the fields are the JAX package's.

    ``needs_rng`` ops take a ``torch.Generator`` as the ``rng`` keyword;
    ``aux_args`` names inputs that are auxiliary states; ``host`` marks ops
    whose output shape depends on the data.
    """

    def __init__(self, name: str, fn: Callable, num_outputs=1,
                 needs_rng: bool = False, differentiable: bool = True,
                 doc: str = "", arg_names=None, aux_args=(),
                 host: bool = False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        self.differentiable = differentiable
        self.host = host
        self.doc = doc or (fn.__doc__ or "")
        self._arg_names = arg_names
        self.aux_args = tuple(aux_args)

    def arg_names(self):
        """Array-input parameter names: the explicit ``arg_names=``, else
        the leading parameters of ``fn`` without defaults (None for a
        variadic op)."""
        if self._arg_names is None:
            names = []
            for p in inspect.signature(self.fn).parameters.values():
                if p.kind == p.VAR_POSITIONAL:
                    names = None
                    break
                if p.default is not p.empty:
                    break
                names.append(p.name)
            self._arg_names = names
        return self._arg_names

    def out_count(self, attrs: Dict[str, Any]) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def __repr__(self):
        return f"OpDef({self.name})"


def register(name: str, num_outputs=1, needs_rng: bool = False,
             differentiable: bool = True, aliases: Sequence[str] = (),
             arg_names=None, aux_args=(), host: bool = False):
    """Decorator: register ``fn`` as operator ``name`` (plus aliases)."""

    def deco(fn: Callable):
        opdef = OpDef(name, fn, num_outputs=num_outputs, needs_rng=needs_rng,
                      differentiable=differentiable, arg_names=arg_names,
                      aux_args=aux_args, host=host)
        _REGISTRY[name] = opdef
        for a in aliases:
            _REGISTRY[a] = opdef
        return fn

    return deco


def alias(existing: str, *names: str) -> None:
    opdef = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = opdef


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered in the "
                         f"PyTorch port") from None


def list_ops():
    return sorted(_REGISTRY)

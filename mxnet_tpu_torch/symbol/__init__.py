"""``mx.sym`` — symbolic namespace.

Every registered operator is exposed as a graph-node constructor generated
from the registry (counterpart of ``mxnet_tpu/symbol``).
``sym.FullyConnected(data, num_hidden=10, name="fc1")`` creates a node and
auto-creates the ``fc1_weight``/``fc1_bias`` variables it is not given;
an unnamed node is named ``{op}{counter}`` by the thread's current
:class:`~mxnet_tpu_torch.name.NameManager`.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..base import MXNetError
from ..name import NameManager
from ..ops.registry import _REGISTRY, get_op, list_ops
from .symbol import Group, Symbol, Variable, _Node, load, load_json, var

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones"]


def _invoke_sym(op_name: str, sym_inputs: List[Symbol],
                kwargs: Dict[str, Any]) -> Symbol:
    from ..attribute import AttrScope
    opdef = get_op(op_name)
    name = NameManager.current().get(kwargs.pop("name", None),
                                     op_name.lower().lstrip("_"))
    scope_attr = AttrScope.current().get(kwargs.pop("attr", None))
    kwargs.pop("ctx", None)
    entries = []
    for s in sym_inputs:
        if not isinstance(s, Symbol):
            raise MXNetError(f"{op_name}: expected Symbol input, got "
                             f"{type(s)}")
        entries.append(s._outputs[0])
    kw_syms = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
    arg_names = opdef.arg_names() or []
    if arg_names:
        # inputs in signature order; missing parameters become variables
        final: List = []
        pos = 0
        for an in arg_names:
            if an in kw_syms:
                final.append(kw_syms[an]._outputs[0])
            elif pos < len(entries):
                final.append(entries[pos])
                pos += 1
            elif an == "bias" and attrs.get(
                    "no_bias", op_name == "Deconvolution"):
                continue
            else:
                final.append((_Node(None, f"{name}_{an}", {}, []), 0))
        entries = final
    node = _Node(op_name, name, attrs, entries)
    node._attr_dict.update(scope_attr)
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _shape_attr(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype="float32", **kwargs) -> Symbol:
    """A ``_zeros`` node (created beside the graph's inputs)."""
    return _invoke_sym("_zeros", [], {"shape": _shape_attr(shape),
                                      "dtype": dtype})


def ones(shape, dtype="float32", **kwargs) -> Symbol:
    return _invoke_sym("_ones", [], {"shape": _shape_attr(shape),
                                     "dtype": dtype})


def _make_sym_func(op_name: str):
    def fn(*args, **kwargs):
        return _invoke_sym(op_name, [a for a in args
                                     if isinstance(a, Symbol)], dict(kwargs))

    fn.__name__ = op_name
    fn.__doc__ = get_op(op_name).doc
    return fn


_func_cache: Dict[str, Any] = {}


def __getattr__(name: str):
    if name in _REGISTRY:
        if name not in _func_cache:
            _func_cache[name] = _make_sym_func(name)
        return _func_cache[name]
    raise AttributeError(
        f"module 'mxnet_tpu_torch.symbol' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list_ops()))

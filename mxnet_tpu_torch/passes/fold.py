"""Constant folding and dead-branch elimination.

Counterpart of ``mxnet_tpu/passes/fold.py``: subgraphs reachable only from
creation ops (``zeros``/``full``/``arange``/…) with static attributes are
evaluated once, on the CPU, at pass time and replaced by one
``_graph_const`` node, and a ``where`` whose condition folds to a uniform
boolean drops its dead branch.

Folding is size-capped: a constant above ``MAX_CONST_ELEMENTS`` stays a
creator op, and random or host ops never fold.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.registry import get_op, register as _register_op
from ..symbol.symbol import Symbol, _Node
from .manager import Pass, PassContext, Namer, is_barrier, register_pass

__all__ = ["ConstantFoldPass", "MAX_CONST_ELEMENTS"]

#: largest folded constant materialized into a ``_graph_const`` node
MAX_CONST_ELEMENTS = 4096
#: largest intermediate value the folder evaluates at all
_MAX_EVAL_ELEMENTS = 1 << 16


@_register_op("_graph_const", differentiable=False)
def _graph_const(value=(), shape=(), dtype="float32", device=None):
    """A pass-made constant; ``value`` is the flat element tuple."""
    a = np.array(value, dtype=np.dtype(str(dtype))).reshape(tuple(shape))
    return torch.from_numpy(a).to(device or "cpu")


#: zero-input creation ops (static attributes determine the value)
CREATORS = frozenset({
    "_zeros", "zeros", "_ones", "ones", "_full", "full", "_arange",
    "arange", "_linspace", "linspace", "_eye", "eye", "_graph_const",
})

#: pure ops the folder evaluates when every input is constant
FOLDABLE = frozenset({
    "transpose", "Reshape", "reshape", "Flatten", "flatten", "expand_dims",
    "squeeze", "Cast", "cast", "negative", "abs", "exp", "log", "sqrt",
    "square", "clip", "_plus_scalar", "_minus_scalar", "_rminus_scalar",
    "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_power_scalar",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "zeros_like", "ones_like", "Concat", "concat", "where",
})

_CPU = torch.device("cpu")


def _static_attrs(attrs) -> bool:
    def ok(v):
        if isinstance(v, (int, float, bool, str, bytes, type(None))):
            return True
        if isinstance(v, (tuple, list)):
            return all(ok(x) for x in v)
        return False
    return all(ok(v) for v in (attrs or {}).values())


def _uniform_bool(arr: np.ndarray):
    flat = np.asarray(arr).ravel()
    if flat.size == 0:
        return None
    if np.all(flat):
        return True
    if not np.any(flat):
        return False
    return None


def _evaluate(opdef, ins, attrs):
    """One op on constant CPU tensors -> a numpy value, or None."""
    from .._imperative import _op_signature_flags
    kw = dict(attrs)
    if _op_signature_flags(opdef)[2] and not ins:
        kw["device"] = _CPU
    try:
        out = opdef.fn(*[torch.from_numpy(np.array(v)) for v in ins], **kw)
        if not isinstance(out, torch.Tensor):
            return None
        out = out.detach().numpy()
        # the value must survive the tuple/np.dtype(str) round trip into
        # _graph_const's attributes (bfloat16 does not convert)
        np.dtype(str(out.dtype))
    except Exception:
        return None
    return out


@register_pass
class ConstantFoldPass(Pass):
    name = "fold"

    def apply(self, sym: Symbol, ctx: PassContext):
        nodes = sym.topo_nodes()
        if not any(n.op in CREATORS for n in nodes if not n.is_var):
            return sym, 0

        # ---- evaluate the constant frontier
        const: Dict[Tuple[int, int], np.ndarray] = {}
        creator = set()
        for node in nodes:
            if node.is_var or is_barrier(node):
                continue
            if node.op not in CREATORS and node.op not in FOLDABLE:
                continue
            try:
                opdef = get_op(node.op)
            except Exception:
                continue
            if opdef.needs_rng or opdef.host or node.num_outputs != 1:
                continue
            if not _static_attrs(node.attrs):
                continue
            ins = [const.get((id(src), idx)) for (src, idx) in node.inputs]
            if any(v is None for v in ins):
                continue
            out = _evaluate(opdef, ins, node.attrs)
            if out is None or out.size > _MAX_EVAL_ELEMENTS:
                continue
            const[(id(node), 0)] = out
            if node.op in CREATORS:
                creator.add(id(node))

        if not const:
            return sym, 0

        namer = Namer(sym)
        remap: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        const_nodes: Dict[Tuple[int, int], _Node] = {}
        count = 0
        # dead-branch elimination reads output shapes (where() broadcasts:
        # a branch passes through only when its shape is the result's)
        avals = None
        if any(n.op == "where" and len(n.inputs) == 3
               and (id(n.inputs[0][0]), n.inputs[0][1]) in const
               for n in nodes if not n.is_var):
            avals = ctx.annotate(sym)

        def const_entry(entry):
            nonlocal count
            k = (id(entry[0]), entry[1])
            if k not in const_nodes:
                v = const[k]
                const_nodes[k] = _Node(
                    "_graph_const", namer.fresh(entry[0].name + "_folded"),
                    {"value": tuple(v.ravel().tolist()),
                     "shape": tuple(int(d) for d in v.shape),
                     "dtype": str(v.dtype)}, [])
                count += 1
            return (const_nodes[k], 0)

        def map_entry(entry):
            src, idx = entry
            if src.is_var:
                return (src, idx)
            k = (id(src), idx)
            # a COMPUTED constant becomes a _graph_const; plain creators
            # stay, and oversized values stay live ops
            if k in const and id(src) not in creator \
                    and src.op != "_graph_const" \
                    and const[k].size <= MAX_CONST_ELEMENTS:
                return const_entry(entry)
            return remap[k]

        for node in nodes:
            if node.is_var:
                continue
            if node.op == "where" and len(node.inputs) == 3 \
                    and not is_barrier(node):
                cv = const.get((id(node.inputs[0][0]), node.inputs[0][1]))
                u = _uniform_bool(cv) if cv is not None else None
                if u is not None and avals is not None:
                    live = node.inputs[1] if u else node.inputs[2]
                    out_av = avals.get((id(node), 0))
                    live_av = avals.get((id(live[0]), live[1]))
                    if out_av is not None and live_av is not None \
                            and tuple(out_av.shape) == tuple(live_av.shape) \
                            and out_av.dtype == live_av.dtype:
                        remap[(id(node), 0)] = map_entry(live)
                        count += 1
                        continue
            ins = [map_entry(e) for e in node.inputs]
            if all(a is b[0] and i == b[1]
                   for (a, i), b in zip(node.inputs, ins)):
                nn = node
            else:
                nn = _Node(node.op, node.name, dict(node.attrs), ins)
                nn._attr_dict = dict(node._attr_dict)
            for i in range(node.num_outputs):
                remap.setdefault((id(node), i), (nn, i))

        if count == 0:
            return sym, 0
        new_heads = [map_entry(e) if not e[0].is_var else e
                     for e in sym._outputs]
        return Symbol(new_heads), count

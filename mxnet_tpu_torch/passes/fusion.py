"""Transpose reordering: compose, cancel and sink transposes.

Counterpart of ``mxnet_tpu/passes/fusion.py``. Three structural rewrites,
iterated to a fixpoint:

* **compose/cancel** — ``transpose(transpose(x, q), p)`` becomes one
  transpose, or none when the composition is the identity;
* **sink through unary** — ``relu(transpose(x))`` → ``transpose(relu(x))``
  (casts included), toward consumers where the compose rule can cancel;
* **sink through binary** — ``add(transpose(x), transpose(y))`` with equal
  permutations → ``transpose(add(x, y))``.

All three reorder data movement around elementwise math, so they are
bitwise exact. A rewrite fires only when the transposed value has a
single consumer.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..symbol.symbol import Symbol, _Node
from .manager import Pass, PassContext, Namer, is_barrier, register_pass
from .layout import UNARY_ELEMWISE, MULTI_ELEMWISE

__all__ = ["FusionReorderPass"]

_MAX_ROUNDS = 8


def _axes_of(node) -> Tuple[int, ...]:
    axes = (node.attrs or {}).get("axes")
    if isinstance(axes, (tuple, list)) and axes:
        return tuple(int(a) for a in axes)
    return ()


def _is_transpose(node) -> bool:
    return node is not None and node.op == "transpose" and bool(_axes_of(node))


@register_pass
class FusionReorderPass(Pass):
    name = "fusion"

    def apply(self, sym: Symbol, ctx: PassContext):
        total = 0
        for _ in range(_MAX_ROUNDS):
            sym, n = self._round(sym)
            total += n
            if n == 0:
                break
        return sym, total

    def _round(self, sym: Symbol):
        nodes = sym.topo_nodes()
        if not any(_is_transpose(n) for n in nodes if not n.is_var):
            return sym, 0
        consumers: Dict[int, int] = {}
        for n in nodes:
            for (src, _) in n.inputs:
                consumers[id(src)] = consumers.get(id(src), 0) + 1
        for (hn, _) in sym._outputs:
            consumers[id(hn)] = consumers.get(id(hn), 0) + 1

        namer = Namer(sym)
        remap: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        count = 0

        def map_entry(entry):
            src, idx = entry
            if src.is_var:
                return (src, idx)
            return remap[(id(src), idx)]

        def register(node, entry_or_node):
            if isinstance(entry_or_node, tuple):
                remap[(id(node), 0)] = entry_or_node
            else:
                for i in range(node.num_outputs):
                    remap[(id(node), i)] = (entry_or_node, i)

        def clone(node, ins, attrs=None):
            if attrs is None and all(
                    a is b[0] and i == b[1]
                    for (a, i), b in zip(node.inputs, ins)):
                return node
            nn = _Node(node.op, node.name,
                       dict(node.attrs) if attrs is None else attrs, ins)
            nn._attr_dict = dict(node._attr_dict)
            return nn

        for node in nodes:
            if node.is_var:
                continue
            if is_barrier(node):
                register(node, clone(node, [map_entry(e)
                                            for e in node.inputs]))
                continue

            ins = [map_entry(e) for e in node.inputs]

            # ---- compose / cancel consecutive transposes
            if _is_transpose(node) and len(ins) == 1 \
                    and _is_transpose(ins[0][0]) and ins[0][1] == 0:
                inner = ins[0][0]
                p, q = _axes_of(node), _axes_of(inner)
                if len(p) == len(q):
                    composed = tuple(q[a] for a in p)
                    count += 1
                    if composed == tuple(range(len(composed))):
                        register(node, inner.inputs[0])
                    else:
                        register(node, clone(
                            node, [inner.inputs[0]],
                            dict(node.attrs, axes=composed)))
                    continue

            # ---- sink a single-consumer transpose through unary elemwise
            if node.op in UNARY_ELEMWISE and len(node.inputs) == 1 \
                    and _is_transpose(ins[0][0]) and ins[0][1] == 0 \
                    and consumers.get(id(node.inputs[0][0]), 0) == 1:
                t = ins[0][0]
                inner_op = _Node(node.op, node.name, dict(node.attrs),
                                 [t.inputs[0]])
                inner_op._attr_dict = dict(node._attr_dict)
                out_t = _Node("transpose", namer.fresh(node.name + "_sunk"),
                              {"axes": _axes_of(t)}, [(inner_op, 0)])
                register(node, out_t)
                count += 1
                continue

            # ---- sink matching transposes through binary elemwise
            if node.op in MULTI_ELEMWISE and len(node.inputs) == 2 \
                    and all(_is_transpose(i[0]) and i[1] == 0 for i in ins) \
                    and _axes_of(ins[0][0]) == _axes_of(ins[1][0]) \
                    and all(consumers.get(id(e[0]), 0) == 1
                            for e in node.inputs):
                ta, tb = ins[0][0], ins[1][0]
                inner_op = _Node(node.op, node.name, dict(node.attrs),
                                 [ta.inputs[0], tb.inputs[0]])
                inner_op._attr_dict = dict(node._attr_dict)
                out_t = _Node("transpose", namer.fresh(node.name + "_sunk"),
                              {"axes": _axes_of(ta)}, [(inner_op, 0)])
                register(node, out_t)
                count += 1
                continue

            register(node, clone(node, ins))

        if count == 0:
            return sym, 0
        new_heads = [map_entry(e) for e in sym._outputs]
        return Symbol(new_heads), count

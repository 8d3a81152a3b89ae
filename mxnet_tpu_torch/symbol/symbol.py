"""Symbol — the symbolic graph IR.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference ``nnvm::Symbol``
and ``python/mxnet/symbol/symbol.py``): composition, argument/output
listing, JSON in the JAX package's format, shape inference and ``bind``.
The bound graph runs through :class:`~mxnet_tpu_torch.executor.Executor`,
an eager interpreter over the port's op registry.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load_json"]


class _Node:
    """One graph node: an op application or a variable (``op=None``)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = 1 if op is None else get_op(op).out_count(attrs)

    @property
    def is_var(self) -> bool:
        return self.op is None


class Symbol:
    """A list of output entries over a shared DAG."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = outputs

    @property
    def name(self) -> str:
        return self._outputs[0][0].name if len(self._outputs) == 1 \
            else "group"

    def __getitem__(self, idx):
        if isinstance(idx, str):
            idx = self.list_outputs().index(idx)
        return Symbol([self._outputs[idx]])

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # arithmetic sugar, the NDArray set (gluon's hybrid_forward uses it)
    def _binop(self, op, other, scalar_op, reverse=False):
        from . import _invoke_sym
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _invoke_sym(op, [a, b], {})
        return _invoke_sym(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o): return self._binop("broadcast_add", o, "_plus_scalar")
    def __radd__(self, o): return self._binop("broadcast_add", o, "_plus_scalar")
    def __sub__(self, o): return self._binop("broadcast_sub", o, "_minus_scalar")
    def __rsub__(self, o): return self._binop("broadcast_sub", o, "_rminus_scalar", True)
    def __mul__(self, o): return self._binop("broadcast_mul", o, "_mul_scalar")
    def __rmul__(self, o): return self._binop("broadcast_mul", o, "_mul_scalar")
    def __truediv__(self, o): return self._binop("broadcast_div", o, "_div_scalar")
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, "_rdiv_scalar", True)

    def __neg__(self):
        from . import _invoke_sym
        return _invoke_sym("negative", [self], {})

    def topo_nodes(self) -> List[_Node]:
        """Post-order DFS over the DAG, inputs in order (the JAX package's
        topo order), with an explicit stack: a deep residual chain would
        exceed Python's recursion limit."""
        seen = set()
        order: List[_Node] = []
        for (root, _) in self._outputs:
            if id(root) in seen:
                continue
            seen.add(id(root))
            stack = [(root, iter(root.inputs))]
            while stack:
                node, pending = stack[-1]
                for (src, _) in pending:
                    if id(src) not in seen:
                        seen.add(id(src))
                        stack.append((src, iter(src.inputs)))
                        break
                else:
                    stack.pop()
                    order.append(node)
        return order

    def _aux_names(self) -> set:
        aux = set()
        for n in self.topo_nodes():
            if n.op is None:
                continue
            opdef = get_op(n.op)
            if opdef.aux_args:
                arg_names = opdef.arg_names() or []
                for i, (src, _) in enumerate(n.inputs):
                    if src.is_var and i < len(arg_names) \
                            and arg_names[i] in opdef.aux_args:
                        aux.add(src.name)
        return aux

    def list_arguments(self) -> List[str]:
        aux = self._aux_names()
        out = []
        for n in self.topo_nodes():
            if n.is_var and n.name not in aux and n.name not in out:
                out.append(n.name)
        return out

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_names()
        out = []
        for n in self.topo_nodes():
            if n.is_var and n.name in aux and n.name not in out:
                out.append(n.name)
        return out

    def list_outputs(self) -> List[str]:
        return [f"{node.name}_output" if node.num_outputs == 1
                else f"{node.name}_output{idx}"
                for (node, idx) in self._outputs]

    def list_inputs(self) -> List[str]:
        return self.list_arguments() + self.list_auxiliary_states()

    def get_internals(self) -> "Symbol":
        return Symbol([(n, i) for n in self.topo_nodes()
                       for i in range(n.num_outputs)])

    # ---------------------------------------------------------------- shapes
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes, positional in ``list_arguments`` order or by name."""
        from ..executor import _GraphLowering
        arg_names = self.list_arguments()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes = _GraphLowering(self).infer_shapes(known)
        return ([shapes.get(n) for n in arg_names], shapes["__outputs__"],
                [shapes.get(n) for n in self.list_auxiliary_states()])

    # ---------------------------------------------------------------- binding
    def bind(self, ctx, args, args_grad=None, grad_req="null",
             aux_states=None):
        """Bind arrays to an inference executor. The executor's gradients
        wait for a later slice (ROADMAP A1): ``args_grad`` or a
        ``grad_req`` other than ``"null"`` raises."""
        from ..executor import Executor
        if args_grad is not None or grad_req not in ("null", None):
            raise NotImplementedError(
                "bind with gradients waits for a later slice (ROADMAP A1); "
                "train through gluon and autograd")
        return Executor(self, ctx, args, aux_states)

    # ---------------------------------------------------------------- JSON
    def tojson(self) -> str:
        """The JAX package's graph JSON (``mxnet_tpu_version`` 1): every
        attr value JSON-encoded as a string."""
        nodes = self.topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": n.op or "null",
            "name": n.name,
            "attrs": {k: json.dumps(v) for k, v in (n.attrs or {}).items()},
            "inputs": [[nid[id(src)], idx, 0] for (src, idx) in n.inputs],
        } for n in nodes]
        heads = [[nid[id(node)], idx, 0] for (node, idx) in self._outputs]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())


def Variable(name: str, shape=None, dtype=None, **kwargs) -> Symbol:
    """A named graph input. Shape and dtype hints are accepted and not
    kept: shapes come to ``infer_shape`` by name. Attribute scopes and
    ``lr_mult``-style metadata wait for a later slice."""
    return Symbol([(_Node(None, name, {}, []), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([entry for s in symbols for entry in s._outputs])


def load_json(json_str: str) -> Symbol:
    """Parse the JAX package's graph JSON. Graphs in the reference's own
    JSON (``nnvm`` attrs) and control-flow subgraphs wait for later
    slices."""
    data = json.loads(json_str)
    if "mxnet_tpu_version" not in data:
        raise MXNetError("load_json: not an mxnet_tpu graph (reference "
                         "MXNet JSON waits for the interop slice)")
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        op = None if jn["op"] == "null" else jn["op"]
        attrs = {}
        for k, v in jn.get("attrs", {}).items():
            v = json.loads(v)
            if isinstance(v, dict):
                raise MXNetError(f"load_json: node {jn['name']!r} embeds a "
                                 f"subgraph; control flow waits for a later "
                                 f"slice")
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            attrs[k] = v
        inputs = [(nodes[i], idx) for (i, idx, _) in jn.get("inputs", [])]
        nodes.append(_Node(op, jn["name"], attrs, inputs))
    return Symbol([(nodes[i], idx) for (i, idx, _) in data["heads"]])

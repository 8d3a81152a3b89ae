"""Symbol — the symbolic graph IR.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference ``nnvm::Symbol``
and ``python/mxnet/symbol/symbol.py``): composition, argument/output
listing, JSON in the JAX package's format (and the reference's, read
through :mod:`~mxnet_tpu_torch.interop`), shape inference, ``bind`` and
``simple_bind``. The bound graph runs through
:class:`~mxnet_tpu_torch.executor.Executor`, an eager interpreter over the
port's op registry, forward and backward.
"""
from __future__ import annotations

import json

import numpy as np
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    """One graph node: an op application or a variable (``op=None``)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs",
                 "_attr_dict")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = 1 if op is None else get_op(op).out_count(attrs)
        # string metadata (``Variable``'s hints, ``AttrScope``, ``attr=``):
        # read by ``Symbol.attr``, never by an op, and not written to the
        # graph JSON (the JAX package writes only ``attrs``)
        self._attr_dict: Dict[str, str] = {}

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

    def __len__(self):
        return len(self._outputs)

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
    def __pow__(self, o): return self._binop("broadcast_power", o, "_power_scalar")
    def __lt__(self, o): return self._binop("_lesser", o, "_lesser_scalar")
    def __le__(self, o): return self._binop("_lesser_equal", o, "_lesser_equal_scalar")
    def __gt__(self, o): return self._binop("_greater", o, "_greater_scalar")
    def __ge__(self, o): return self._binop("_greater_equal", o, "_greater_equal_scalar")

    def __neg__(self):
        from . import _invoke_sym
        return _invoke_sym("negative", [self], {})

    # ---------------------------------------------------------------- attrs
    def attr(self, key: str) -> Optional[str]:
        return self._outputs[0][0]._attr_dict.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0]._attr_dict.update(kwargs)

    def list_attr(self) -> Dict[str, str]:
        return dict(self._outputs[0][0]._attr_dict)

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """Every node's attribute dict by name, an op's own attributes
        included as strings (the JAX package's ``attr_dict``)."""
        out = {}
        for n in self.topo_nodes():
            d = dict(n._attr_dict)
            if n.op is not None:
                d.update({k: str(v) for k, v in n.attrs.items()})
            if d:
                out[n.name] = d
        return out

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

    def _compose(self, entries: Dict[str, Tuple[_Node, int]]) -> "Symbol":
        """A copy of this graph with each variable named in ``entries``
        replaced by that output entry of another graph (the reference's
        ``Symbol._compose``); this graph is left as it is."""
        new: Dict[int, _Node] = {}

        def entry(src, idx):
            if src.is_var and src.name in entries:
                return entries[src.name]
            return (new.get(id(src), src), idx)

        for n in self.topo_nodes():
            if not n.is_var:
                node = _Node.__new__(_Node)
                node.op, node.name, node.num_outputs = (n.op, n.name,
                                                        n.num_outputs)
                node.attrs = dict(n.attrs)
                node._attr_dict = dict(n._attr_dict)
                node.inputs = [entry(src, idx) for (src, idx) in n.inputs]
                new[id(n)] = node
        return Symbol([entry(node, idx) for (node, idx) in self._outputs])

    def get_internals(self) -> "Symbol":
        return Symbol([(n, i) for n in self.topo_nodes()
                       for i in range(n.num_outputs)])

    def get_children(self) -> Optional["Symbol"]:
        """The first output's node's inputs as one Symbol, or None for a
        variable."""
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

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

    def infer_shape_partial(self, *args, **kwargs):
        """:meth:`infer_shape`, or ``(None, None, None)`` where the given
        shapes do not determine the graph's."""
        try:
            return self.infer_shape(*args, **kwargs)
        except Exception:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        """float32 for every argument, output and auxiliary state, as the
        JAX package answers (its graphs are bound in float32)."""
        return ([np.float32] * len(self.list_arguments()),
                [np.float32] * len(self._outputs),
                [np.float32] * len(self.list_auxiliary_states()))

    # ---------------------------------------------------------------- binding
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind arrays (lists in ``list_arguments`` order or dicts by name)
        to an :class:`~mxnet_tpu_torch.executor.Executor`. ``grad_req``
        (``write``, ``add`` or ``null``; one for all, a list or a dict)
        defaults to ``write`` as in the reference; gradients land only in
        the arrays ``args_grad`` provides."""
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None, **shapes):
        """Infer every shape from the given input shapes and bind zeros:
        arguments, gradients (for each argument whose ``grad_req`` is not
        ``null``) and auxiliary states, float32 on ``ctx``."""
        from ..executor import Executor
        from ..ndarray.utils import zeros
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        arg_names = self.list_arguments()
        if isinstance(grad_req, str):
            reqs = dict.fromkeys(arg_names, grad_req)
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(arg_names, grad_req))
        else:
            reqs = dict(grad_req)
        args = {n: zeros(s, ctx=ctx) for n, s in zip(arg_names, arg_shapes)}
        grads = {n: zeros(s, ctx=ctx) for n, s in zip(arg_names, arg_shapes)
                 if reqs.get(n, "null") != "null"}
        aux = {n: zeros(s, ctx=ctx) for n, s in
               zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, ctx, args, grads, reqs, aux)

    def eval(self, ctx=None, **kwargs):
        """Bind the named arrays and run the graph forward once; the
        outputs."""
        return self.bind(ctx, kwargs).forward()

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


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    """A named graph input, with the JAX package's signature. The current
    :class:`~mxnet_tpu_torch.attribute.AttrScope`, ``attr`` and the hints
    go to the node's attribute dict as strings (``__shape__``,
    ``__dtype__``, ``__lr_mult__``, ``__wd_mult__`` and each other keyword),
    explicit keywords last. As in the JAX package, ``init`` and ``stype``
    are accepted and dropped, and no optimizer reads the multipliers
    (standing faults of the JAX package, ROADMAP C). A ``shape`` hint is
    also kept as the node's ``__shape__`` op attribute, written to the
    graph JSON, which ``infer_shape`` takes where no shape is given."""
    from ..attribute import AttrScope
    attrs = {} if shape is None else {"__shape__": tuple(int(d)
                                                         for d in shape)}
    node = _Node(None, name, attrs, [])
    meta = dict(AttrScope.current().get(attr))
    if shape is not None:
        meta["__shape__"] = str(tuple(shape))
    if dtype is not None:
        meta["__dtype__"] = str(dtype)
    if lr_mult is not None:
        meta["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        meta["__wd_mult__"] = str(wd_mult)
    meta.update({k: str(v) for k, v in kwargs.items()})
    node._attr_dict.update(meta)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([entry for s in symbols for entry in s._outputs])


def load_json(json_str: str) -> Symbol:
    """Parse the JAX package's graph JSON, or the reference's own (nnvm
    attrs, every era, through ``interop.symbol_from_reference_json``).
    Control-flow subgraphs wait for a later slice."""
    data = json.loads(json_str)
    from ..interop import is_reference_symbol_json, symbol_from_reference_json
    if is_reference_symbol_json(data):
        return symbol_from_reference_json(data)
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


def load(fname: str) -> Symbol:
    """Read a graph JSON file (:meth:`Symbol.save` of either package, or
    the reference's ``-symbol.json``)."""
    with open(fname) as f:
        return load_json(f.read())

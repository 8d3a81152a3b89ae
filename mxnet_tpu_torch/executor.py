"""Executor — runs a bound Symbol graph.

Counterpart of ``mxnet_tpu/executor.py``. Where the JAX package lowers the
whole graph to one jitted XLA program, the port interprets it eagerly over
its op registry: each node is one call of its op, launched asynchronously
on the card's stream. XLA's buffer assignment becomes a last-use rule: a
node's outputs are dropped as soon as their last consumer has run, so the
interpreter holds only live activations.

Inference only: ``forward(is_train=False)`` runs under
``torch.inference_mode()``. Training goes through gluon and
``autograd``; the symbolic executor's train step and ``backward`` wait
for a later slice (ROADMAP A1).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ._imperative import _op_signature_flags
from .base import MXNetError
from .ops.registry import get_op

__all__ = ["Executor", "_GraphLowering"]


# Per-op parameter shape rules: op -> fn(attrs, data_shape) -> {param: shape}
# (each op's FInferShape filling in weight shapes from the data shape).
def _fc_param_shapes(attrs, ds):
    nh = int(attrs["num_hidden"])
    flat = math.prod(ds[1:]) if attrs.get("flatten", True) else ds[-1]
    shapes = {"weight": (nh, flat)}
    if not attrs.get("no_bias", False):
        shapes["bias"] = (nh,)
    return shapes


def _ln_param_shapes(attrs, ds):
    ax = int(attrs.get("axis", -1)) % len(ds)
    return {"gamma": (ds[ax],), "beta": (ds[ax],)}


def _emb_param_shapes(attrs, ds):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


_PARAM_SHAPE_RULES: Dict[str, Callable] = {
    "FullyConnected": _fc_param_shapes,
    "LayerNorm": _ln_param_shapes,
    "Embedding": _emb_param_shapes,
}


class _GraphLowering:
    """Turns a Symbol DAG into ``fn(inputs: dict) -> outputs: list``."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.nodes = symbol.topo_nodes()
        pinned = {id(node) for (node, _) in symbol._outputs}
        # last consumer of every node's outputs (graph outputs never die)
        self.last_use: Dict[int, int] = {}
        for i, node in enumerate(self.nodes):
            for (src, _) in node.inputs:
                if id(src) not in pinned:
                    self.last_use[id(src)] = i

    def lower(self) -> Callable:
        """The inference function: ops that take ``is_train`` get False,
        random ops no generator (Dropout is the identity)."""
        nodes, out_entries = self.nodes, self.symbol._outputs
        dying: Dict[int, List[int]] = {}
        for nid, i in self.last_use.items():
            dying.setdefault(i, []).append(nid)

        def fn(inputs: Dict[str, Any]):
            vals: Dict[int, Tuple] = {}
            for i, node in enumerate(nodes):
                if node.is_var:
                    vals[id(node)] = (inputs[node.name],)
                    continue
                opdef = get_op(node.op)
                in_arrays = [vals[id(src)][idx] for (src, idx) in node.inputs]
                attrs = dict(node.attrs)
                if _op_signature_flags(opdef)[0]:
                    attrs.setdefault("is_train", False)
                out = opdef.fn(*in_arrays, **attrs)
                vals[id(node)] = out if isinstance(out, tuple) else (out,)
                for nid in dying.get(i, ()):
                    vals.pop(nid, None)
            return [vals[id(node)][idx] for (node, idx) in out_entries]

        return fn

    def infer_shapes(self, known: Dict[str, Tuple[int, ...]]):
        """Forward shape inference with parameter-shape backfill, in
        fixpoint sweeps (a node whose inputs are still unknown waits for
        the next sweep); each op runs on ``meta`` tensors. The backfill
        through pass-inserted transposes comes with the graph-pass layer."""
        shapes: Dict[str, Tuple[int, ...]] = dict(known)
        entry_shape: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        op_nodes = [n for n in self.nodes if not n.is_var]
        meta = torch.device("meta")
        for _ in range(len(op_nodes) + 1):
            progress = False
            for node in op_nodes:
                if (id(node), 0) in entry_shape:
                    continue
                opdef = get_op(node.op)
                arg_names = opdef.arg_names() or []
                rule = _PARAM_SHAPE_RULES.get(node.op)
                if rule is not None and node.inputs:
                    src0, idx0 = node.inputs[0]
                    ds = shapes.get(src0.name) if src0.is_var \
                        else entry_shape.get((id(src0), idx0))
                    if ds is not None:
                        try:
                            param_shapes = rule(dict(node.attrs), tuple(ds))
                        except KeyError:
                            param_shapes = {}
                        for i, (src, _) in enumerate(node.inputs):
                            if src.is_var and src.name not in shapes \
                                    and i < len(arg_names) \
                                    and arg_names[i] in param_shapes:
                                shapes[src.name] = param_shapes[arg_names[i]]
                                progress = True
                in_shapes = []
                for (src, idx) in node.inputs:
                    s = shapes.get(src.name) if src.is_var \
                        else entry_shape.get((id(src), idx))
                    if s is None:
                        break
                    in_shapes.append(s)
                else:
                    attrs = dict(node.attrs)
                    if _op_signature_flags(opdef)[0]:
                        attrs.setdefault("is_train", False)
                    try:
                        out = opdef.fn(*[torch.empty(s, device=meta)
                                         for s in in_shapes], **attrs)
                    except Exception as e:
                        raise MXNetError(f"shape inference failed at op "
                                         f"{node.op} ({node.name}): {e}") \
                            from e
                    for i, o in enumerate(out if isinstance(out, tuple)
                                          else (out,)):
                        entry_shape[(id(node), i)] = tuple(o.shape)
                    progress = True
            if not progress:
                break
        for node in op_nodes:
            if (id(node), 0) in entry_shape:
                continue
            for (src, _) in node.inputs:
                if src.is_var and src.name not in shapes:
                    raise MXNetError(
                        f"shape of variable {src.name!r} cannot be inferred;"
                        f" provide it to infer_shape")
            raise MXNetError(f"shape inference failed at op {node.op} "
                             f"({node.name}): inputs unresolved")
        shapes["__outputs__"] = [
            shapes.get(node.name) if node.is_var
            else entry_shape[(id(node), idx)]
            for (node, idx) in self.symbol._outputs]
        return shapes


class Executor:
    """Bound inference executor (reference ``GraphExecutor``): owns the
    argument and auxiliary arrays; :meth:`forward` runs the graph."""

    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        if isinstance(args, (list, tuple)):
            args = dict(zip(symbol.list_arguments(), args))
        self.arg_dict = dict(args or {})
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(symbol.list_auxiliary_states(),
                                  aux_states))
        self.aux_dict = dict(aux_states or {})
        missing = [n for n in symbol.list_inputs()
                   if n not in self.arg_dict and n not in self.aux_dict]
        if missing:
            raise MXNetError(f"bind: no array for inputs {missing}")
        self._fn = _GraphLowering(symbol).lower()
        self._outputs: List = []

    @property
    def outputs(self) -> List:
        return self._outputs

    def forward(self, is_train: bool = False):
        """Run the graph over the bound arrays; returns the outputs."""
        from .ndarray.ndarray import NDArray
        if is_train:
            raise NotImplementedError(
                "forward(is_train=True) and backward of the symbolic "
                "executor wait for a later slice (ROADMAP A1); train "
                "through gluon and autograd")
        inputs = {n: a._data for n, a in self.arg_dict.items()}
        inputs.update({n: a._data for n, a in self.aux_dict.items()})
        with torch.inference_mode():
            outs = self._fn(inputs)
        self._outputs = [NDArray(o) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        raise NotImplementedError("backward of the symbolic executor "
                                  "waits for a later slice (ROADMAP A1)")

"""Executor — runs a bound Symbol graph, forward and backward.

Counterpart of ``mxnet_tpu/executor.py``. Where the JAX package lowers the
whole graph to one jitted XLA program (and its gradient to ``jax.vjp`` of
that program), the port interprets it eagerly over its op registry: each
node is one call of its op, launched asynchronously on the card's stream,
so the graph reaches the same op functions, and the same Hopper kernels,
as gluon does. XLA's buffer assignment becomes a last-use rule: a node's
outputs are dropped as soon as their last consumer has run, so the
interpreter holds only live activations (and, in training, what torch
autograd saved for the backward).

``forward(is_train=False)`` runs under ``torch.inference_mode()``, a
graph-mode ``Custom`` op (``mx.operator``) included, forward only as in
the JAX package. ``forward(is_train=True)`` records the graph with torch
autograd and keeps it only until :meth:`Executor.backward` (or the next
forward) consumes it; the BatchNorm moving statistics are written after
the forward, outside autograd (``_AUX_UPDATE_RULES``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
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


def _conv_param_shapes(attrs, ds):
    """(num_filter, C/g, *kernel), or (num_filter, *kernel, C/g) when the
    layout puts the channels last."""
    nf = int(attrs["num_filter"])
    g = int(attrs.get("num_group", 1))
    kernel = tuple(attrs["kernel"])
    if str(attrs.get("layout") or "").endswith("C"):
        shapes = {"weight": (nf,) + kernel + (ds[-1] // g,)}
    else:
        shapes = {"weight": (nf, ds[1] // g) + kernel}
    if not attrs.get("no_bias", False):
        shapes["bias"] = (nf,)
    return shapes


def _deconv_param_shapes(attrs, ds):
    """(C, num_filter/g, *kernel); no bias unless ``no_bias`` is false."""
    nf = int(attrs["num_filter"])
    g = int(attrs.get("num_group", 1))
    shapes = {"weight": (ds[1], nf // g) + tuple(attrs["kernel"])}
    if not attrs.get("no_bias", True):
        shapes["bias"] = (nf,)
    return shapes


def _ln_param_shapes(attrs, ds):
    ax = int(attrs.get("axis", -1)) % len(ds)
    return {"gamma": (ds[ax],), "beta": (ds[ax],)}


def _bn_param_shapes(attrs, ds):
    c = ds[int(attrs.get("axis", 1)) % len(ds)]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _emb_param_shapes(attrs, ds):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


_PARAM_SHAPE_RULES: Dict[str, Callable] = {
    "FullyConnected": _fc_param_shapes,
    "Convolution": _conv_param_shapes,
    "Deconvolution": _deconv_param_shapes,
    "BatchNorm": _bn_param_shapes,
    "LayerNorm": _ln_param_shapes,
    "Embedding": _emb_param_shapes,
}


# Ops whose extra outputs update auxiliary state during training:
# op -> fn(attrs, in_arrays, out_tuple) -> {input_index: new_value}
def _bn_aux_update(attrs, ins, outs):
    """``moving ← moving·momentum + batch·(1 − momentum)``, the batch's
    biased variance; nothing under ``use_global_stats``."""
    if attrs.get("use_global_stats", False):
        return {}
    mom = float(attrs.get("momentum", 0.9))
    _, mean, var = outs
    return {3: ins[3] * mom + mean.detach() * (1.0 - mom),
            4: ins[4] * mom + var.detach() * (1.0 - mom)}


_AUX_UPDATE_RULES: Dict[str, Callable] = {"BatchNorm": _bn_aux_update}


class _GraphLowering:
    """Turns a Symbol DAG into ``fn(inputs: dict) -> (outputs: list,
    aux_updates: dict)``."""

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

    def _run_node(self, node, vals, aux_updates, is_train: bool) -> None:
        """One op node: its outputs into ``vals``, the moving statistics it
        updates (training only, without gradient) into ``aux_updates``."""
        from . import random as _random
        opdef = get_op(node.op)
        in_arrays = [vals[id(src)][idx] for (src, idx) in node.inputs]
        attrs = dict(node.attrs)
        accepts_train, accepts_rng = _op_signature_flags(opdef)
        if accepts_train:
            attrs.setdefault("is_train", is_train)
        if accepts_rng and is_train and in_arrays:
            attrs["rng"] = _random.generator(in_arrays[0].device)
        out = opdef.fn(*in_arrays, **attrs)
        out = out if isinstance(out, tuple) else (out,)
        vals[id(node)] = out
        rule = _AUX_UPDATE_RULES.get(node.op) if is_train else None
        if rule is not None:
            with torch.no_grad():
                upd = rule(attrs, in_arrays, out)
            for in_idx, new_val in upd.items():
                src, _ = node.inputs[in_idx]
                if src.is_var:
                    aux_updates[src.name] = new_val

    def lower(self, is_train: bool = False,
              segment: Callable = None) -> Callable:
        """The graph as a function. Ops that take ``is_train`` get it; in
        training a random op draws from the generator of its first input's
        device and the aux-update rules give the new moving statistics
        (computed without gradient); at inference random ops get no
        generator (Dropout is the identity) and nothing is updated.

        With ``segment`` the n op nodes run in ⌈√n⌉ consecutive segments
        of about equal length, each as ``segment(run, *tensors)``: ``run``
        maps the tensors the segment reads to those it leaves for later
        nodes and the outputs. The trainer's rematerialisation passes
        ``torch.utils.checkpoint`` there, so that only the tensors between
        segments are kept for the backward and each segment is recomputed
        when the backward reaches it."""
        nodes, out_entries = self.nodes, self.symbol._outputs
        dying: Dict[int, List[int]] = {}
        for nid, i in self.last_use.items():
            dying.setdefault(i, []).append(nid)
        ops = [i for i, node in enumerate(nodes) if not node.is_var]
        size = max(1, len(ops))
        if segment is not None:
            size = max(1, math.ceil(len(ops) / math.ceil(math.sqrt(size))))
        chunks = [ops[j:j + size] for j in range(0, len(ops), size)]
        # each chunk's (node indices, entries it reads from earlier nodes,
        # entries it leaves for later chunks and the outputs)
        plans = []
        pinned = {(id(node), idx) for (node, idx) in out_entries}
        for c, chunk in enumerate(chunks):
            pos = {id(nodes[i]): j for j, i in enumerate(chunk)}
            reads = list(dict.fromkeys(
                (id(src), idx) for i in chunk
                for (src, idx) in nodes[i].inputs if id(src) not in pos))
            later = pinned | {(id(src), idx) for rest in chunks[c + 1:]
                              for i in rest for (src, idx) in nodes[i].inputs}
            leaves = sorted((e for e in later if e[0] in pos),
                            key=lambda e: (pos[e[0]], e[1]))
            plans.append((chunk, reads, leaves))

        def run_nodes(chunk, vals, aux_updates) -> None:
            for i in chunk:
                self._run_node(nodes[i], vals, aux_updates, is_train)
                for nid in dying.get(i, ()):
                    vals.pop(nid, None)

        def fn(inputs: Dict[str, Any]):
            vals: Dict[int, Any] = {id(node): (inputs[node.name],)
                                    for node in nodes if node.is_var}
            aux_updates: Dict[str, Any] = {}
            for chunk, reads, leaves in plans:
                if segment is None:
                    run_nodes(chunk, vals, aux_updates)
                    continue

                def run(*tensors, chunk=chunk, reads=reads, leaves=leaves):
                    seg: Dict[int, Dict[int, Any]] = {}
                    for (nid, idx), t in zip(reads, tensors):
                        seg.setdefault(nid, {})[idx] = t
                    run_nodes(chunk, seg, aux_updates)
                    return tuple(seg[nid][idx] for nid, idx in leaves)

                got = segment(run, *[vals[nid][idx] for nid, idx in reads])
                for i in chunk:
                    for nid in dying.get(i, ()):
                        vals.pop(nid, None)
                for (nid, idx), t in zip(leaves, got):
                    vals.setdefault(nid, {})[idx] = t
            return ([vals[id(node)][idx] for (node, idx) in out_entries],
                    aux_updates)

        return fn

    def infer_shapes(self, known: Dict[str, Tuple[int, ...]]):
        """Forward shape inference with parameter-shape backfill (and the
        variables' ``__shape__`` hints where ``known`` has no shape), in
        fixpoint sweeps (a node whose inputs are still unknown waits for
        the next sweep); each op runs on ``meta`` tensors. The backfill
        through pass-inserted transposes comes with the graph-pass layer."""
        shapes: Dict[str, Tuple[int, ...]] = {
            n.name: tuple(n.attrs["__shape__"]) for n in self.nodes
            if n.is_var and all(d > 0 for d in
                                n.attrs.get("__shape__", (0,)))}
        shapes.update(known)
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


_GRAD_REQS = ("write", "add", "null")


class Executor:
    """Bound executor (reference ``GraphExecutor``): owns the argument,
    gradient and auxiliary arrays; :meth:`forward` runs the graph,
    :meth:`backward` delivers the gradients by each argument's
    ``grad_req``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
        arg_names = symbol.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        self.arg_dict = dict(args or {})
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_dict = {n: g for n, g in (args_grad or {}).items()
                          if g is not None}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(symbol.list_auxiliary_states(),
                                  aux_states))
        self.aux_dict = dict(aux_states or {})
        if isinstance(grad_req, str):
            grad_req = dict.fromkeys(arg_names, grad_req)
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        bad = {r for r in self.grad_req.values() if r not in _GRAD_REQS}
        if bad:
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{sorted(bad)}")
        missing = [n for n in symbol.list_inputs()
                   if n not in self.arg_dict and n not in self.aux_dict]
        if missing:
            raise MXNetError(f"bind: no array for inputs {missing}")
        self._lowering = _GraphLowering(symbol)
        self._fns: Dict[bool, Callable] = {}
        # (differentiated leaves by name, graph outputs) of the last train
        # forward, until backward consumes them
        self._pending = None
        self._outputs: List = []

    @property
    def outputs(self) -> List:
        return self._outputs

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    def _fn(self, is_train: bool) -> Callable:
        if is_train not in self._fns:
            self._fns[is_train] = self._lowering.lower(is_train)
        return self._fns[is_train]

    def forward(self, is_train: bool = False, **kwargs):
        """Run the graph over the bound arrays (``kwargs`` first set named
        arguments, copied onto their arrays' device); returns the outputs.
        With ``is_train`` the graph is recorded for :meth:`backward` and
        the moving statistics are updated."""
        from .ndarray.ndarray import NDArray, array
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(v._data if isinstance(v, NDArray)
                                           else v)
            else:
                self.arg_dict[k] = v if isinstance(v, NDArray) \
                    else array(v, ctx=self._ctx)
        # a new forward drops the graph of the last one, failed or not
        self._pending = None
        inputs = {n: a._data for n, a in self.aux_dict.items()}
        leaves = {}
        for n, a in self.arg_dict.items():
            t = a._data
            if is_train and self.grad_req.get(n, "null") != "null" \
                    and t.is_floating_point():
                t = leaves[n] = t.detach().requires_grad_()
            inputs[n] = t
        try:
            if is_train:
                with torch.enable_grad():
                    outs, aux_updates = self._fn(True)(inputs)
            else:
                with torch.inference_mode():
                    outs, aux_updates = self._fn(False)(inputs)
        except (TypeError, ValueError) as e:
            raise MXNetError(f"graph execution failed: {e}") from e
        with torch.no_grad():
            for name, val in aux_updates.items():
                if name in self.aux_dict:
                    self.aux_dict[name]._data.copy_(val)
        if is_train:
            self._pending = (leaves, outs)
        self._outputs = [NDArray(o.detach()) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Deliver the gradients of the last train forward's outputs,
        seeded with ``out_grads`` (one array or a list; ones on every
        output by default), to ``grad_dict`` by ``grad_req``: ``write``
        overwrites, ``add`` adds, ``null`` takes nothing. Loss heads
        (``MakeLoss``, ``SoftmaxOutput``) ignore their seed. The recorded
        graph is released: a second backward needs a new forward."""
        from .ndarray.ndarray import NDArray
        if self._pending is None:
            raise MXNetError("backward called without forward(is_train=True)")
        leaves, outs = self._pending
        self._pending = None
        if out_grads is not None and not isinstance(out_grads,
                                                    (list, tuple)):
            out_grads = [out_grads]
        if out_grads is not None and len(out_grads) != len(outs):
            raise MXNetError(f"backward: {len(out_grads)} head gradients "
                             f"for {len(outs)} outputs")
        heads, seeds = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            heads.append(o)
            if out_grads is None:
                # one element expanded: a (8192, 50272) head needs no 1.6 GB
                # of ones
                seeds.append(torch.ones((), dtype=o.dtype,
                                        device=o.device).expand(o.shape))
            else:
                g = out_grads[i]
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                seeds.append(g.to(device=o.device, dtype=o.dtype))
        names = list(leaves)
        got = [None] * len(names)
        if heads and names:
            got = torch.autograd.grad(heads, [leaves[n] for n in names],
                                      seeds, allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, got):
                buf = self.grad_dict.get(name)
                req = self.grad_req.get(name, "null")
                if buf is None or req == "null":
                    continue
                if g is None:     # not reached from the outputs
                    g = torch.zeros((), dtype=buf._data.dtype,
                                    device=buf._data.device)
                if req == "add":
                    buf._data.add_(g)
                else:
                    buf._data.copy_(g)
        return self.grad_arrays

    # ------------------------------------------------------------- misc API
    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at the given input shapes: arrays whose shape is
        unchanged are shared, the others are new zeros."""
        from .ndarray.utils import zeros
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args, new_grads = {}, {}
        for n, s in zip(self._symbol.list_arguments(), arg_shapes):
            old = self.arg_dict.get(n)
            if old is not None and tuple(old.shape) == tuple(s):
                new_args[n] = old
                if n in self.grad_dict:
                    new_grads[n] = self.grad_dict[n]
            else:
                new_args[n] = zeros(s, ctx=self._ctx)
                if self.grad_req.get(n, "null") != "null":
                    new_grads[n] = zeros(s, ctx=self._ctx)
        new_aux = {n: self.aux_dict.get(n, zeros(s, ctx=self._ctx))
                   for n, s in zip(self._symbol.list_auxiliary_states(),
                                   aux_shapes)}
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self.grad_req, new_aux)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arguments and auxiliary states, in
        place (onto each bound array's device)."""
        for src, dst, what in ((arg_params, self.arg_dict, "argument"),
                               (aux_params, self.aux_dict, "aux state")):
            for k, v in (src or {}).items():
                if k in dst:
                    _copy_into(dst[k], v)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {k}")


def _copy_into(dst, src) -> None:
    """Copy an NDArray, tensor or array-like into ``dst`` in place; a value
    of another shape replaces the tensor."""
    from .ndarray.ndarray import NDArray
    t = src._data if isinstance(src, NDArray) else torch.as_tensor(
        np.asarray(src))
    if tuple(t.shape) == tuple(dst.shape):
        with torch.no_grad():
            dst._data.copy_(t)
    else:
        dst._set_data(t.detach().to(dst._data.dtype))

"""Quantization as graph-rewrite passes: three
:class:`~mxnet_tpu_torch.passes.manager.Pass` subclasses that together turn
eligible float Convolution/FullyConnected nodes into the reference int8
island ``quantize → int8 op → requantize → dequantize``
(``quantize_graph_pass.cc``), composed through the
:class:`~mxnet_tpu_torch.passes.manager.PassManager`.

Counterpart of ``mxnet_tpu/quant/qpass.py``:

* :class:`QuantizePass` — picks the eligible nodes (the excluded names and
  the reference's first/last-layer defaults), inserts ``_contrib_quantize``
  on their data edge (calibrated constant ranges from a
  :class:`~mxnet_tpu_torch.quant.calib.CalibTable` when present, runtime
  min/max otherwise) and swaps the float op for its ``_contrib_quantized_*``
  twin with int8 weight and bias variables (synthesized parameters,
  materialized by ``PassResult.materialize_params``);
* :class:`RequantizePass` — narrows every raw int32 accumulator to int8
  with ``_contrib_requantize`` (a calibrated output range under the
  ``<node>_out`` key when the table has one);
* :class:`DequantizePass` — returns to float wherever an int8 value flows
  into a non-quantized consumer or a graph head.

All three are opt-in: registered as ``quantize``/``requantize``/
``dequantize`` but never in ``DEFAULT_PIPELINE``. Run in order they give
the graph of ``contrib.quantization.quantize_graph`` (same node names,
ops, attributes and wiring); each is idempotent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..symbol.symbol import Symbol, _Node
from ..passes.manager import (Namer, Pass, PassContext, is_barrier,
                              register_pass)

__all__ = ["QuantizePass", "RequantizePass", "DequantizePass",
           "QUANT_PIPELINE", "ACC_OPS", "QUANT_FAMILY_OPS"]

#: the opt-in pipeline, in order (PassManager(QUANT_PIPELINE) spelling)
QUANT_PIPELINE = ("quantize", "requantize", "dequantize")

#: quantized compute ops producing the raw (int32 acc, min, max) triple
ACC_OPS = frozenset({"_contrib_quantized_conv",
                     "_contrib_quantized_fully_connected"})

#: everything that CONSUMES the (int8/int32, min, max) triple natively — a
#: consumer in this set does NOT need a dequantize in front of it.  NOTE
#: ``_contrib_quantize`` is deliberately absent: it takes FLOAT data (it is
#: an island *entrance*), so two directly-adjacent islands still dequantize
#: between them, exactly like ``contrib.quantization.quantize_graph``.
QUANT_FAMILY_OPS = ACC_OPS | frozenset({
    "_contrib_requantize", "_contrib_dequantize",
    "_contrib_quantized_pooling", "_contrib_quantized_flatten",
    "_contrib_quantized_concat"})


class _Rebuild:
    """Shared functional-rebuild scaffolding: walk topo order, remap
    entries, reuse untouched nodes (the pass contract: zero rewrites
    returns the input symbol object)."""

    def __init__(self, sym: Symbol):
        self.sym = sym
        self.nodes = sym.topo_nodes()
        self.remap: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        self.changed = False

    def ent(self, entry):
        src, idx = entry
        if src.is_var:
            return (src, idx)
        return self.remap[(id(src), idx)]

    def passthrough(self, node: _Node) -> _Node:
        """Rebuild ``node`` against the remapped inputs, reusing it when
        nothing upstream changed."""
        ins = [self.ent(e) for e in node.inputs]
        if all(a is b[0] and i == b[1]
               for (a, i), b in zip(node.inputs, ins)):
            nn = node
        else:
            nn = _Node(node.op, node.name, dict(node.attrs), ins)
            nn._attr_dict = dict(node._attr_dict)
            self.changed = True
        for i in range(node.num_outputs):
            self.remap[(id(node), i)] = (nn, i)
        return nn

    def finish(self) -> Symbol:
        heads = [self.ent(e) for e in self.sym._outputs]
        return Symbol(heads)


def _consumer_ops(nodes) -> Dict[Tuple[int, int], List[str]]:
    """entry -> op names of every node consuming it (heads excluded)."""
    out: Dict[Tuple[int, int], List[str]] = {}
    for n in nodes:
        if n.is_var:
            continue
        for (src, idx) in n.inputs:
            out.setdefault((id(src), idx), []).append(n.op)
    return out


@register_pass
class QuantizePass(Pass):
    """Insert ``_contrib_quantize`` + the int8 compute op for every
    eligible Convolution/FullyConnected.

    ``table`` supplies calibrated activation ranges (baked in as constant
    range variables); nodes absent from the table quantize from runtime
    min/max — mxlint MXL-G108 flags the resulting graph as uncalibrated.
    ``excluded`` is the reference's excluded-op name list;
    ``exclude_first_conv``/``exclude_last_fc`` are the reference recipe's
    first/last-layer defaults (``imagenet_gen_qsym.py`` keeps the input
    conv and the classifier head in float — they are the accuracy-critical
    layers and the cheapest to leave alone)."""

    name = "quantize"

    def __init__(self, table=None, excluded: Sequence[str] = (),
                 exclude_first_conv: bool = True,
                 exclude_last_fc: bool = True):
        self.table = table
        self.excluded = set(excluded)
        self.exclude_first_conv = bool(exclude_first_conv)
        self.exclude_last_fc = bool(exclude_last_fc)

    def _eligible(self, nodes, ctx: PassContext) -> set:
        def param_ok(entry):
            src = entry[0]
            return src.is_var and (ctx.param_names is None
                                   or src.name in ctx.param_names)

        def bias_ok(n):
            # a no_bias node legitimately synthesizes a zero bias; a node
            # WITH a bias must have it as a param var — quantizing a
            # computed (or missing) bias would silently zero it out, so
            # such nodes stay float instead
            if str(n.attrs.get("no_bias", False)).lower() in ("true", "1"):
                return True
            return len(n.inputs) >= 3 and param_ok(n.inputs[2])

        cand = [n for n in nodes
                if not n.is_var and not is_barrier(n)
                and n.op in ("Convolution", "FullyConnected")
                and n.name not in self.excluded
                and len(n.inputs) >= 2 and param_ok(n.inputs[1])
                and bias_ok(n)]
        # the first/last defaults protect the accuracy-critical edge
        # layers of a DEEP net; they never empty the candidate set — a
        # net too shallow to afford an exclusion quantizes anyway
        # (explicit ``excluded`` names always win, defaults only yield)
        if self.exclude_first_conv and len(cand) > 1:
            convs = [n for n in cand if n.op == "Convolution"]
            if convs:
                cand.remove(convs[0])
        if self.exclude_last_fc and len(cand) > 1:
            fcs = [n for n in cand if n.op == "FullyConnected"]
            if fcs:
                cand.remove(fcs[-1])
        return {id(n) for n in cand}

    def apply(self, sym: Symbol, ctx: PassContext):
        rb = _Rebuild(sym)
        eligible = self._eligible(rb.nodes, ctx)
        if not eligible:
            return sym, 0
        namer = Namer(sym)
        q_var_cache: Dict[str, tuple] = {}

        def q_param_vars(pname: str) -> tuple:
            """int8 weight/bias variable triple backed by synthesized
            params; tied layers quantize once and share the var nodes."""
            if pname not in q_var_cache:
                vars3 = []
                for part in ("quantized", "min", "max"):
                    vname = f"{pname}_{part}"
                    ctx.add_synth_param(vname, ("quant_of", pname, part))
                    vars3.append(_Node(None, vname, {}, []))
                q_var_cache[pname] = tuple(vars3)
            return q_var_cache[pname]

        count = 0
        for node in rb.nodes:
            if node.is_var:
                continue
            if id(node) not in eligible:
                rb.passthrough(node)
                continue
            data_e = rb.ent(node.inputs[0])
            wname = node.inputs[1][0].name
            wq, wmin, wmax = q_param_vars(wname)

            # activation range: calibrated constants, else runtime min/max
            crange = self.table.get(node.name) if self.table is not None \
                else None
            if crange is not None:
                mn_v, mx_v = crange
                ctx.add_synth_param(node.name + "_data_min",
                                    ("const", float(mn_v)))
                ctx.add_synth_param(node.name + "_data_max",
                                    ("const", float(mx_v)))
                mn_e = (_Node(None, node.name + "_data_min", {}, []), 0)
                mx_e = (_Node(None, node.name + "_data_max", {}, []), 0)
            else:
                mn_e = (_Node("min", namer.fresh(node.name + "_rt_min"),
                              {}, [data_e]), 0)
                mx_e = (_Node("max", namer.fresh(node.name + "_rt_max"),
                              {}, [data_e]), 0)
            qd = _Node("_contrib_quantize",
                       namer.fresh(node.name + "_quantize"), {},
                       [data_e, mn_e, mx_e])

            no_bias = str(node.attrs.get("no_bias", False)).lower() \
                in ("true", "1")
            if not no_bias and len(node.inputs) >= 3 \
                    and node.inputs[2][0].is_var \
                    and (ctx.param_names is None
                         or node.inputs[2][0].name in ctx.param_names):
                bname = node.inputs[2][0].name
            else:
                # the int8 ops take bias positionally: synthesize zeros
                bname = node.name + "_zero_bias"
                out_ch = int(node.attrs.get("num_hidden",
                                            node.attrs.get("num_filter", 1)))
                ctx.add_synth_source(bname, ("zeros", (out_ch,)))
            bq, bmin, bmax = q_param_vars(bname)

            qop = ("_contrib_quantized_fully_connected"
                   if node.op == "FullyConnected"
                   else "_contrib_quantized_conv")
            attrs = dict(node.attrs)
            attrs["no_bias"] = False
            # positional order: data, weight, bias, min_data, max_data,
            # min_weight, max_weight, min_bias, max_bias
            qn = _Node(qop, namer.fresh(node.name + "_int8"), attrs,
                       [(qd, 0), (wq, 0), (bq, 0), (qd, 1), (qd, 2),
                        (wmin, 0), (wmax, 0), (bmin, 0), (bmax, 0)])
            for i in range(min(3, max(1, node.num_outputs))):
                rb.remap[(id(node), i)] = (qn, i)
            rb.changed = True
            count += 1
        if not count:
            return sym, 0
        return rb.finish(), count


def _island_base(name: str, suffix: str) -> str:
    return name[:-len(suffix)] if name.endswith(suffix) else name


@register_pass
class RequantizePass(Pass):
    """Narrow every raw int32 accumulator (a ``_contrib_quantized_*``
    compute output with no requantize consumer yet) to int8.  ``table``
    may carry calibrated OUTPUT ranges under the ``<node>_out`` key —
    baked in as ``min_calib_range``/``max_calib_range`` attrs (reference
    requantize-inl.h); absent, the requantize derives the range from the
    batch (the reference's uncalibrated path)."""

    name = "requantize"

    def __init__(self, table=None):
        self.table = table

    def apply(self, sym: Symbol, ctx: PassContext):
        rb = _Rebuild(sym)
        consumers = _consumer_ops(rb.nodes)
        targets = {
            id(n) for n in rb.nodes
            if not n.is_var and not is_barrier(n) and n.op in ACC_OPS
            and "_contrib_requantize" not in consumers.get((id(n), 0), ())}
        if not targets:
            return sym, 0
        namer = Namer(sym)
        count = 0
        for node in rb.nodes:
            if node.is_var:
                continue
            nn = rb.passthrough(node)
            if id(node) not in targets:
                continue
            base = _island_base(node.name, "_int8")
            attrs = {}
            orange = self.table.get(base + "_out") if self.table is not None \
                else None
            if orange is not None:
                attrs = {"min_calib_range": float(orange[0]),
                         "max_calib_range": float(orange[1])}
            rq = _Node("_contrib_requantize",
                       namer.fresh(base + "_requantize"), attrs,
                       [(nn, 0), (nn, 1), (nn, 2)])
            for i in range(3):
                rb.remap[(id(node), i)] = (rq, i)
            rb.changed = True
            count += 1
        return rb.finish(), count


@register_pass
class DequantizePass(Pass):
    """Return to float: every ``_contrib_requantize`` whose int8 output
    still flows into a non-quantized consumer (or a graph head) gets a
    ``_contrib_dequantize`` — the island's exit back into the fp32 graph."""

    name = "dequantize"

    def apply(self, sym: Symbol, ctx: PassContext):
        rb = _Rebuild(sym)
        consumers = _consumer_ops(rb.nodes)
        head_ids = {(id(n), i) for (n, i) in sym._outputs}

        def needs_deq(n) -> bool:
            cons = consumers.get((id(n), 0), [])
            if any(op == "_contrib_dequantize" for op in cons):
                return False
            non_quant = [op for op in cons if op not in QUANT_FAMILY_OPS]
            return bool(non_quant) or (id(n), 0) in head_ids

        targets = {id(n) for n in rb.nodes
                   if not n.is_var and not is_barrier(n)
                   and n.op == "_contrib_requantize" and needs_deq(n)}
        if not targets:
            return sym, 0
        namer = Namer(sym)
        count = 0
        for node in rb.nodes:
            if node.is_var:
                continue
            nn = rb.passthrough(node)
            if id(node) not in targets:
                continue
            base = _island_base(node.name, "_requantize")
            deq = _Node("_contrib_dequantize",
                        namer.fresh(base + "_dequantize"), {},
                        [(nn, 0), (nn, 1), (nn, 2)])
            rb.remap[(id(node), 0)] = (deq, 0)
            rb.changed = True
            count += 1
        return rb.finish(), count

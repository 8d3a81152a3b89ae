"""Automatic NCHW→NHWC layout propagation.

Counterpart of ``mxnet_tpu/passes/layout.py``: every NCHW 2-D
Convolution/Pooling (and the BatchNorms riding on them) becomes its NHWC
twin, the layout is pushed through elementwise ops so interior transposes
cancel structurally, and, where the caller allows re-homing, conv weight
variables become OHWI and rank-4 input variables channel-last.

Layout decisions are dataflow: an entry is *NHWC-homed* when its producer
emits channel-last; elementwise consumers follow when every operand is
homed, rank-0 or a transposable rank-4; everything else consumes the
original layout through a back-transpose made on demand. Global-pool
outputs are marked spatially degenerate so Flatten/FullyConnected consume
them channel-last directly ((B,1,1,C) and (B,C,1,1) flatten alike).

In the port a ``transpose`` is a ``permute`` view and a channel-last
convolution or pooling reaches cuDNN through views
(:mod:`mxnet_tpu_torch.ops.nn`): on ``Module``'s path, where no variable
is re-homed, a converted NCHW graph runs the same cuDNN calls on the same
memory, with no layout copy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..symbol.symbol import Symbol, _Node
from .manager import (Pass, PassContext, Namer, is_barrier, register_pass,
                      _NCHW_SPELLINGS, _parse_shape_attr)

__all__ = ["LayoutPass", "is_nchw_conv"]

TO_NHWC = (0, 2, 3, 1)     # NCHW data -> NHWC; OIHW weight -> OHWI
TO_NCHW = (0, 3, 1, 2)

#: shape-preserving single-array-input ops the layout propagates through
#: bitwise (note: Dropout is deliberately absent — its mask draw depends on
#: the operand shape ORDER, so a permuted trace is only statistically
#: equivalent and would break the bitwise/tolerance equivalence contract)
UNARY_ELEMWISE = frozenset({
    "Activation", "relu", "sigmoid", "tanh", "softsign", "exp", "log",
    "sqrt", "square", "abs", "negative", "clip", "Cast", "cast",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_power_scalar", "_maximum_scalar",
    "_minimum_scalar",
})

#: broadcasting/elementwise multi-input ops: safe when every operand is
#: homed, rank-0, or a transposable rank-4 (a 0<rank<4 operand would
#: broadcast against DIFFERENT axes after the permutation — bail)
MULTI_ELEMWISE = frozenset({
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
})

FLATTEN_OPS = frozenset({"Flatten", "flatten"})


def _conv_eligible(node) -> bool:
    if node.op != "Convolution":
        return False
    attrs = node.attrs or {}
    if attrs.get("layout") not in _NCHW_SPELLINGS:
        return False
    return len(tuple(attrs.get("kernel") or ())) == 2


#: the one "NCHW 2-D conv the layout pass would convert" predicate (the
#: trainer counts them at capture)
is_nchw_conv = _conv_eligible


def _pool_eligible(node, rank: Optional[int] = None) -> bool:
    """2-D pooling only.  A len-2 kernel implies rank-4 data by op
    semantics; a global pool declares no meaningful kernel, so it needs
    the annotated rank (``rank=None`` = unknown => not eligible) — an NCW/
    NCDHW global pool must never receive rank-4 transposes."""
    if node.op != "Pooling":
        return False
    attrs = node.attrs or {}
    if attrs.get("layout") not in _NCHW_SPELLINGS:
        return False
    kernel = tuple(attrs.get("kernel") or ())
    if len(kernel) == 2 and not attrs.get("global_pool"):
        return True
    return bool(attrs.get("global_pool")) and rank == 4


def _bn_eligible(node, rank: Optional[int]) -> bool:
    if node.op != "BatchNorm":
        return False
    try:
        axis = int((node.attrs or {}).get("axis", 1))
    except (TypeError, ValueError):
        return False
    return axis == 1 and rank == 4


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


@register_pass
class LayoutPass(Pass):
    name = "layout"

    def apply(self, sym: Symbol, ctx: PassContext):
        nodes = sym.topo_nodes()
        has_conv_pool = any(_conv_eligible(n) or _pool_eligible(n)
                            for n in nodes if not n.is_var and
                            not is_barrier(n))
        if not has_conv_pool:
            return sym, 0
        avals = ctx.annotate(sym)

        def rank_of(entry) -> Optional[int]:
            av = avals.get((id(entry[0]), entry[1]))
            return len(av.shape) if av is not None else None

        namer = Namer(sym)
        orig_map: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        nhwc_map: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        degen = set()          # old entries with 1x1 spatial extent
        used_orig_vars = set()  # ids of vars consumed in original layout
        var_ph: Dict[int, Dict] = {}   # var id -> placeholder info
        rehomed_inputs: Dict[int, _Node] = {}   # var id -> NHWC var clone
        count = 0

        # rank-4 input variables under the NHWC feed contract are
        # re-declared channel-last up front: the caller COMMITS to feeding
        # NHWC, so even partially-converted graphs stay consistent
        for n in nodes:
            if n.is_var and ctx.can_rehome_input(n.name):
                shp = ctx.shapes.get(n.name)
                if shp is not None and len(shp) == 4:
                    clone = _Node(None, n.name, {}, [])
                    clone._attr_dict = dict(n._attr_dict)
                    if "__shape__" in clone._attr_dict:
                        clone._attr_dict["__shape__"] = str(
                            tuple(shp[i] for i in TO_NHWC))
                    rehomed_inputs[id(n)] = clone
                    ctx.input_layouts[n.name] = "NHWC"

        def get_orig(entry):
            src, idx = entry
            if src.is_var:
                if id(src) in rehomed_inputs:
                    # NHWC-declared input: original layout via back-transpose
                    k = (id(src), idx)
                    if k not in orig_map:
                        t = _Node("transpose",
                                  namer.fresh(src.name + "_nchw"),
                                  {"axes": TO_NCHW},
                                  [(rehomed_inputs[id(src)], 0)])
                        orig_map[k] = (t, 0)
                    return orig_map[k]
                used_orig_vars.add(id(src))
                return (src, idx)
            k = (id(src), idx)
            if k in orig_map:
                return orig_map[k]
            nh = nhwc_map[k]
            t = _Node("transpose", namer.fresh(src.name + "_nchw"),
                      {"axes": TO_NCHW}, [nh])
            orig_map[k] = (t, 0)
            return (t, 0)

        def nhwc_available(entry) -> bool:
            src, idx = entry
            if src.is_var:
                return id(src) in rehomed_inputs
            return (id(src), idx) in nhwc_map

        def get_nhwc(entry, perm=TO_NHWC):
            src, idx = entry
            if src.is_var:
                if id(src) in rehomed_inputs:
                    return (rehomed_inputs[id(src)], 0)
                ph = var_ph.get(id(src))
                if ph is not None:
                    if ph["perm"] == perm:
                        return (ph["node"], 0)
                    # conflicting perms on one var: plain transpose
                    t = _Node("transpose", namer.fresh(src.name + "_nhwc"),
                              {"axes": perm}, [(src, 0)])
                    used_orig_vars.add(id(src))
                    return (t, 0)
                node = _Node("transpose", namer.fresh(src.name + "_nhwc"),
                             {"axes": perm}, [(src, 0)])
                var_ph[id(src)] = {"node": node, "perm": perm, "var": src}
                return (node, 0)
            k = (id(src), idx)
            if k in nhwc_map:
                return nhwc_map[k]
            o = orig_map[k]
            t = _Node("transpose", namer.fresh(src.name + "_nhwc"),
                      {"axes": TO_NHWC}, [o])
            nhwc_map[k] = (t, 0)
            return (t, 0)

        def emit(node, new_inputs, attrs=None):
            """Clone ``node`` with mapped inputs; reuse the original object
            when nothing changed (keeps untouched subtrees shared)."""
            if attrs is None and \
                    all(a is b[0] and i == b[1]
                        for (a, i), b in zip(node.inputs, new_inputs)) \
                    and len(new_inputs) == len(node.inputs):
                return node
            nn = _Node(node.op, node.name,
                       dict(node.attrs) if attrs is None else attrs,
                       list(new_inputs))
            nn._attr_dict = dict(node._attr_dict)
            return nn

        def register(node, nn, target_map):
            for i in range(node.num_outputs):
                target_map[(id(node), i)] = (nn, i)

        for node in nodes:
            if node.is_var:
                continue
            if is_barrier(node):
                nn = emit(node, [get_orig(e) for e in node.inputs])
                register(node, nn, orig_map)
                continue

            if _conv_eligible(node):
                attrs = dict(node.attrs)
                attrs["layout"] = "NHWC"
                ins = [get_nhwc(node.inputs[0]),
                       get_nhwc(node.inputs[1], perm=TO_NHWC)]
                ins += [get_orig(e) for e in node.inputs[2:]]
                nn = emit(node, ins, attrs)
                register(node, nn, nhwc_map)
                count += 1
                continue

            if _pool_eligible(node, rank_of(node.inputs[0])):
                attrs = dict(node.attrs)
                attrs["layout"] = "NHWC"
                nn = emit(node, [get_nhwc(node.inputs[0])], attrs)
                register(node, nn, nhwc_map)
                if _truthy(attrs.get("global_pool")):
                    degen.add((id(node), 0))
                elif (id(node.inputs[0][0]), node.inputs[0][1]) in degen:
                    degen.add((id(node), 0))
                count += 1
                continue

            if _bn_eligible(node, rank_of(node.inputs[0])) \
                    and nhwc_available(node.inputs[0]):
                attrs = dict(node.attrs)
                attrs["axis"] = -1
                ins = [get_nhwc(node.inputs[0])]
                ins += [get_orig(e) for e in node.inputs[1:]]
                nn = emit(node, ins, attrs)
                # out0 is channel-last; the mean/var outputs are rank-1 and
                # layout-free (registered identically in both views)
                nhwc_map[(id(node), 0)] = (nn, 0)
                for i in range(1, node.num_outputs):
                    nhwc_map[(id(node), i)] = (nn, i)
                    orig_map[(id(node), i)] = (nn, i)
                if (id(node.inputs[0][0]), node.inputs[0][1]) in degen:
                    degen.add((id(node), 0))
                count += 1
                continue

            if node.op in UNARY_ELEMWISE and len(node.inputs) == 1 \
                    and nhwc_available(node.inputs[0]):
                nn = emit(node, [get_nhwc(node.inputs[0])])
                register(node, nn, nhwc_map)
                if (id(node.inputs[0][0]), node.inputs[0][1]) in degen:
                    degen.add((id(node), 0))
                continue

            if node.op in MULTI_ELEMWISE and node.inputs:
                homed = [nhwc_available(e) for e in node.inputs]
                ranks = [rank_of(e) for e in node.inputs]
                convertible = any(homed) and all(
                    h or r == 0 or r == 4
                    for h, r in zip(homed, ranks))
                if convertible:
                    ins = [get_orig(e) if (not h and r == 0)
                           else get_nhwc(e)
                           for e, h, r in zip(node.inputs, homed, ranks)]
                    nn = emit(node, ins)
                    register(node, nn, nhwc_map)
                    if all((id(e[0]), e[1]) in degen or r == 0
                           for e, r in zip(node.inputs, ranks)):
                        degen.add((id(node), 0))
                    continue

            if node.op in FLATTEN_OPS and len(node.inputs) == 1:
                e = node.inputs[0]
                if nhwc_available(e) and (id(e[0]), e[1]) in degen:
                    # (B,1,1,C) flattens to the same (B,C) as (B,C,1,1):
                    # consume channel-last directly, no transpose
                    nn = emit(node, [get_nhwc(e)])
                    register(node, nn, orig_map)
                    continue

            if node.op == "FullyConnected" and node.inputs:
                e = node.inputs[0]
                if nhwc_available(e) and (id(e[0]), e[1]) in degen \
                        and (node.attrs or {}).get("flatten", True) \
                        is not False:
                    ins = [get_nhwc(e)] + [get_orig(x)
                                           for x in node.inputs[1:]]
                    nn = emit(node, ins)
                    register(node, nn, orig_map)
                    continue

            # default: consume and produce the original layout
            nn = emit(node, [get_orig(e) for e in node.inputs])
            register(node, nn, orig_map)

        if count == 0:
            return sym, 0

        # resolve variable placeholders: a var consumed ONLY channel-last
        # (and re-homable by policy) mutates its placeholder into a fresh
        # NHWC-declared variable, recording the value transform; otherwise
        # the placeholder stays a real transpose
        for vid, ph in var_ph.items():
            var = ph["var"]
            if vid in used_orig_vars or not ctx.can_rehome_param(var.name):
                continue
            node = ph["node"]
            node.op = None
            node.name = var.name
            node.attrs = {}
            node.inputs = []
            node.num_outputs = 1
            node._attr_dict = dict(var._attr_dict)
            if "__shape__" in node._attr_dict:
                shp = _parse_shape_attr(node._attr_dict["__shape__"])
                if shp is not None and len(shp) == len(ph["perm"]):
                    node._attr_dict["__shape__"] = str(
                        tuple(shp[i] for i in ph["perm"]))
            ctx.add_var_transform(var.name, ("transpose", ph["perm"]))

        new_heads = [get_orig(e) for e in sym._outputs]
        return Symbol(new_heads), count

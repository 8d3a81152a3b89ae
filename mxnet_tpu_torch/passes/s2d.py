"""Space-to-depth rewrite of stride-2 stem convolutions.

Counterpart of ``mxnet_tpu/passes/s2d.py``: a 7x7/s2 convolution over 3
input channels becomes the block-2 space-to-depth reparameterization (pad
→ reshape → transpose → reshape → 4x4/s1 convolution over 12 channels),
exactly the same linear map. The pass applies to any eligible NHWC conv:
stride (2,2), dilation 1, no groups, few input channels, even padded
spatial extent.

The conv weight re-homes from (O,kh,kw,C) to (O,⌈kh/2⌉,⌈kw/2⌉,4C), the
value transform recorded in the :class:`~.manager.PassResult` (the trainer
applies it at capture and ``sync_to_net`` inverts it). Where the weight
cannot be re-homed (shared, or re-homing off) the same rearrangement is
emitted as graph ops on the weight.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..symbol.symbol import Symbol, _Node
from .manager import Pass, PassContext, Namer, is_barrier, register_pass

__all__ = ["SpaceToDepthPass"]

#: a conv is stem-shaped when quadrupling its channels keeps the
#: contraction short (3 -> 12 channels; the JAX package's bound)
MAX_IN_CHANNELS = 4


def _pair(v) -> Tuple[int, ...]:
    t = tuple(v) if isinstance(v, (tuple, list)) else (v, v)
    return tuple(int(x) for x in t)


@register_pass
class SpaceToDepthPass(Pass):
    name = "s2d"

    def _eligible(self, node, avals) -> Optional[Dict]:
        if node.op != "Convolution" or is_barrier(node):
            return None
        attrs = node.attrs or {}
        if str(attrs.get("layout")) != "NHWC":
            return None
        kernel = tuple(attrs.get("kernel") or ())
        if len(kernel) != 2 or max(kernel) < 2:
            return None
        if _pair(attrs.get("stride") or (1, 1)) != (2, 2):
            return None
        dil = tuple(attrs.get("dilate") or ())
        if dil and _pair(dil) != (1, 1):
            return None
        if int(attrs.get("num_group", 1) or 1) != 1:
            return None
        av = avals.get((id(node.inputs[0][0]), node.inputs[0][1]))
        if av is None or len(av.shape) != 4:
            return None
        B, H, W, C = av.shape
        if C > MAX_IN_CHANNELS:
            return None
        pad = _pair(attrs.get("pad") or (0, 0))
        if (H + 2 * pad[0]) % 2 or (W + 2 * pad[1]) % 2:
            return None
        kh, kw = int(kernel[0]), int(kernel[1])
        return {"kh": kh, "kw": kw, "pad": pad, "C": int(C),
                "O": int(attrs.get("num_filter", 0) or 0)}

    def apply(self, sym: Symbol, ctx: PassContext):
        nodes = sym.topo_nodes()
        if not any(n.op == "Convolution" for n in nodes if not n.is_var):
            return sym, 0
        avals = ctx.annotate(sym)
        plans = {id(n): p for n in nodes if not n.is_var
                 for p in (self._eligible(n, avals),) if p is not None}
        if not plans:
            return sym, 0

        # weight vars re-home only when this conv is their sole consumer
        consumers: Dict[int, int] = {}
        for n in nodes:
            for (src, _) in n.inputs:
                consumers[id(src)] = consumers.get(id(src), 0) + 1
        for (hn, _) in sym._outputs:
            consumers[id(hn)] = consumers.get(id(hn), 0) + 1

        namer = Namer(sym)
        remap: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        var_sub: Dict[int, _Node] = {}
        count = 0

        def map_entry(entry):
            src, idx = entry
            if src.is_var:
                return (var_sub.get(id(src), src), idx)
            return remap[(id(src), idx)]

        def clone_default(node):
            ins = [map_entry(e) for e in node.inputs]
            if all(a is b[0] and i == b[1]
                   for (a, i), b in zip(node.inputs, ins)):
                return node
            nn = _Node(node.op, node.name, dict(node.attrs), ins)
            nn._attr_dict = dict(node._attr_dict)
            return nn

        for node in nodes:
            if node.is_var:
                continue
            plan = plans.get(id(node))
            if plan is None:
                nn = clone_default(node)
                for i in range(node.num_outputs):
                    remap[(id(node), i)] = (nn, i)
                continue

            kh, kw, (ph, pw), C = (plan["kh"], plan["kw"], plan["pad"],
                                   plan["C"])
            kh2, kw2 = (kh + 1) // 2, (kw + 1) // 2
            O = plan["O"]
            base = node.name

            # ---- data side: pad -> s2d (reshape/transpose/reshape), the
            # exact node sequence SpaceToDepthStem's forward traces
            cur = map_entry(node.inputs[0])
            if ph or pw:
                cur = (_Node("pad", namer.fresh(base + "_s2d_pad"),
                             {"mode": "constant",
                              "pad_width": (0, 0, ph, ph, pw, pw, 0, 0)},
                             [cur]), 0)
            cur = (_Node("reshape", namer.fresh(base + "_s2d_split"),
                         {"shape": (0, -4, -1, 2, -4, -1, 2, 0)}, [cur]), 0)
            cur = (_Node("transpose", namer.fresh(base + "_s2d_perm"),
                         {"axes": (0, 1, 3, 2, 4, 5)}, [cur]), 0)
            cur = (_Node("reshape", namer.fresh(base + "_s2d_merge"),
                         {"shape": (0, 0, 0, -1)}, [cur]), 0)

            # ---- weight side: re-home the variable when possible, else
            # emit the same block rearrangement as in-graph ops
            wsrc, widx = node.inputs[1]
            if wsrc.is_var and consumers.get(id(wsrc), 0) == 1 \
                    and ctx.can_rehome_param(wsrc.name):
                wclone = var_sub.get(id(wsrc))
                if wclone is None:
                    wclone = _Node(None, wsrc.name, {}, [])
                    wclone._attr_dict = dict(wsrc._attr_dict)
                    if "__shape__" in wclone._attr_dict:
                        wclone._attr_dict["__shape__"] = str(
                            (O, kh2, kw2, 4 * C)) if O else \
                            wclone._attr_dict["__shape__"]
                    var_sub[id(wsrc)] = wclone
                ctx.add_var_transform(wsrc.name, ("s2d_weight", kh, kw))
                w_entry = (wclone, 0)
            else:
                w_entry = map_entry(node.inputs[1])
                if O:
                    if 2 * kh2 - kh or 2 * kw2 - kw:
                        w_entry = (_Node(
                            "pad", namer.fresh(base + "_s2dw_pad"),
                            {"mode": "constant",
                             "pad_width": (0, 0, 0, 2 * kh2 - kh,
                                           0, 2 * kw2 - kw, 0, 0)},
                            [w_entry]), 0)
                    w_entry = (_Node(
                        "reshape", namer.fresh(base + "_s2dw_split"),
                        {"shape": (O, kh2, 2, kw2, 2, C)}, [w_entry]), 0)
                    w_entry = (_Node(
                        "transpose", namer.fresh(base + "_s2dw_perm"),
                        {"axes": (0, 1, 3, 2, 4, 5)}, [w_entry]), 0)
                    w_entry = (_Node(
                        "reshape", namer.fresh(base + "_s2dw_merge"),
                        {"shape": (O, kh2, kw2, 4 * C)}, [w_entry]), 0)
                else:   # num_filter unknown: cannot rearrange — skip conv
                    nn = clone_default(node)
                    for i in range(node.num_outputs):
                        remap[(id(node), i)] = (nn, i)
                    continue

            attrs = dict(node.attrs)
            attrs.update(kernel=(kh2, kw2), stride=(1, 1), pad=(0, 0))
            ins = [cur, w_entry] + [map_entry(e) for e in node.inputs[2:]]
            nn = _Node(node.op, node.name, attrs, ins)
            nn._attr_dict = dict(node._attr_dict)
            for i in range(node.num_outputs):
                remap[(id(node), i)] = (nn, i)
            count += 1

        if count == 0:
            return sym, 0
        new_heads = [map_entry(e) for e in sym._outputs]
        return Symbol(new_heads), count

"""Post-training int8 quantization with the reference's signatures.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference
``python/mxnet/contrib/quantization.py``): the calibration estimators
(``calib_minmax``, ``calib_entropy``), ``quantize_params``, the int8 graph
rewrite ``quantize_graph`` and ``quantize_model``. The ops
themselves are :mod:`mxnet_tpu_torch.ops.quantize_ops`, registered at
import; the pass route is :mod:`mxnet_tpu_torch.quant`.

Calibration binds the float graph on the caller's context (the card by
default, where the JAX package binds on the host), reduces each probed
activation's min and max there, and copies to the host only the entropy
search's subsample: at most ``2^20`` elements a layer, taken at the
indices ``RandomState(0)`` draws, in the JAX package's order. The
subsample's values and the ranges are those of the JAX code over the
same activations.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["calib_minmax", "calib_entropy", "quantize_params",
           "quantize_graph", "quantize_model"]


def calib_minmax(activations: np.ndarray):
    return float(np.min(activations)), float(np.max(activations))


def calib_entropy(activations: np.ndarray, num_bins: int = 8001,
                  num_quantized_bins: int = 255,
                  min_percentile: float = None):
    """KL-divergence threshold search (reference ``quantization.py``
    ``_get_optimal_threshold``), the JAX package's numpy arithmetic.

    ``min_percentile`` (None: the reference's behaviour) floors the
    KL-optimal threshold at that percentile of |x|."""
    arr = np.abs(activations.ravel())
    amax = float(arr.max()) if arr.size else 1.0
    if amax == 0:
        return -1.0, 1.0
    if arr.size < 4 * num_quantized_bins:
        # too few samples for a meaningful histogram search: min/max
        return -amax, amax
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    best_kl, best_t = np.inf, amax
    for i in range(num_quantized_bins, num_bins + 1, num_bins // 64 or 1):
        t = edges[i] if i < len(edges) else amax
        p = hist[:i].astype(np.float64).copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        # quantize p into num_quantized_bins, then expand back
        factor = len(p) / num_quantized_bins
        q = np.zeros_like(p)
        for j in range(num_quantized_bins):
            lo, hi = int(j * factor), int((j + 1) * factor) or 1
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        p /= p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        mask = p > 0
        kl = float(np.sum(p[mask] * np.log(p[mask]
                                            / np.maximum(q[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_t = kl, t
    if min_percentile is not None:
        best_t = max(best_t, float(np.percentile(arr, min_percentile)))
    return -best_t, best_t


def _tensor(arr) -> torch.Tensor:
    return arr._data if isinstance(arr, NDArray) else \
        torch.as_tensor(np.asarray(arr))


def quantize_params(params: Dict[str, NDArray]):
    """Each parameter -> its int8 codes (``name_quantized``) and its range
    scalars (``name_min``, ``name_max``), on the parameter's device. The
    JAX package's numpy arithmetic: ``amax`` the largest |value| (1 when
    all are 0), the scale ``127 / amax`` rounded to the parameter's type,
    ``round`` half to even."""
    out = {}
    for name, arr in params.items():
        t = _tensor(arr).detach()
        amax = float(t.abs().max()) or 1.0
        scale = torch.tensor(127.0 / amax, dtype=t.dtype, device=t.device)
        q = torch.round(t * scale).clamp(-127, 127).to(torch.int8)
        out[name + "_quantized"] = NDArray(q)
        out[name + "_min"] = NDArray(torch.tensor(
            np.float32(-amax), device=t.device))
        out[name + "_max"] = NDArray(torch.tensor(
            np.float32(amax), device=t.device))
    return out


def _params_ctx(arg_params):
    """The context of the first parameter (where synthesized values go),
    else the current one."""
    from ..context import current_context
    for v in arg_params.values():
        if isinstance(v, NDArray):
            return v.context
    return current_context()


def quantize_graph(sym, arg_params, excluded_sym_names=(),
                   calib_ranges=None):
    """The int8 graph pass (reference ``quantize_graph_pass.cc``): every
    FullyConnected/Convolution becomes a quantize -> int8 op -> requantize
    -> dequantize island. Weights and biases become int8 variables
    (``*_quantized`` with ``*_min``/``*_max``); activations quantize from
    their runtime min/max, or from the calibrated ranges ``calib_ranges``
    maps a node name to.

    Returns (new_symbol, extra_arg_params): merge the extras into
    arg_params."""
    from .. import ndarray as nd_mod
    from ..symbol.symbol import Symbol, _Node

    calib_ranges = calib_ranges or {}
    excluded = set(excluded_sym_names)
    ctx = _params_ctx(arg_params)
    extra: Dict[str, object] = {}
    remap: Dict[int, _Node] = {}
    q_var_cache: Dict[str, tuple] = {}

    def q_param_vars(pname):
        """int8 weight/bias variables; tied parameters quantize once and
        share the variable nodes."""
        if pname in q_var_cache:
            return q_var_cache[pname]
        extra.update(quantize_params({pname: arg_params[pname]}))
        nodes = (_Node(None, pname + "_quantized", {}, []),
                 _Node(None, pname + "_min", {}, []),
                 _Node(None, pname + "_max", {}, []))
        q_var_cache[pname] = nodes
        return nodes

    def new_entry(entry):
        src, idx = entry
        return (remap[id(src)], idx)

    for node in sym.topo_nodes():
        if node.is_var:
            remap[id(node)] = node
            continue
        inputs = [new_entry(e) for e in node.inputs]
        no_bias = str(node.attrs.get("no_bias", False)).lower() in ("true",
                                                                    "1")
        # as quant.qpass: a node WITH a bias must have it as a parameter
        # variable (a computed bias is never zeroed)
        bias_quantizable = no_bias or (
            len(node.inputs) >= 3 and node.inputs[2][0].is_var
            and node.inputs[2][0].name in arg_params)
        quantizable = (node.op in ("FullyConnected", "Convolution")
                       and node.name not in excluded
                       and len(node.inputs) >= 2
                       and node.inputs[1][0].is_var
                       and node.inputs[1][0].name in arg_params
                       and bias_quantizable)
        if not quantizable:
            remap[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                    inputs)
            continue

        data_e = inputs[0]
        wq, wmin, wmax = q_param_vars(node.inputs[1][0].name)
        if node.name in calib_ranges:
            mn_v, mx_v = calib_ranges[node.name]
            extra[node.name + "_data_min"] = nd_mod.array(np.float32(mn_v),
                                                          ctx=ctx)
            extra[node.name + "_data_max"] = nd_mod.array(np.float32(mx_v),
                                                          ctx=ctx)
            mn_e = (_Node(None, node.name + "_data_min", {}, []), 0)
            mx_e = (_Node(None, node.name + "_data_max", {}, []), 0)
        else:
            mn_e = (_Node("min", node.name + "_rt_min", {}, [data_e]), 0)
            mx_e = (_Node("max", node.name + "_rt_max", {}, [data_e]), 0)
        qd = _Node("_contrib_quantize", node.name + "_quantize", {},
                   [data_e, mn_e, mx_e])

        if not no_bias and len(node.inputs) >= 3 \
                and node.inputs[2][0].is_var \
                and node.inputs[2][0].name in arg_params:
            bname = node.inputs[2][0].name
        else:
            # the int8 ops take a bias by position: zeros
            bname = node.name + "_zero_bias"
            out_ch = int(node.attrs.get("num_hidden",
                                        node.attrs.get("num_filter", 1)))
            arg_params = dict(arg_params)
            arg_params[bname] = nd_mod.zeros((out_ch,), ctx=ctx)
        bq, bmin, bmax = q_param_vars(bname)

        qop = ("_contrib_quantized_fully_connected"
               if node.op == "FullyConnected" else "_contrib_quantized_conv")
        attrs = dict(node.attrs)
        attrs["no_bias"] = False
        # by position: data, weight, bias, min_data, max_data, min_weight,
        # max_weight, min_bias, max_bias
        qn = _Node(qop, node.name + "_int8", attrs,
                   [(qd, 0), (wq, 0), (bq, 0), (qd, 1), (qd, 2),
                    (wmin, 0), (wmax, 0), (bmin, 0), (bmax, 0)])
        rq = _Node("_contrib_requantize", node.name + "_requantize", {},
                   [(qn, 0), (qn, 1), (qn, 2)])
        remap[id(node)] = _Node("_contrib_dequantize",
                                node.name + "_dequantize", {},
                                [(rq, 0), (rq, 1), (rq, 2)])

    new_sym = Symbol([(remap[id(n)], i) for (n, i) in sym._outputs])
    return new_sym, extra


def _collect_calib_ranges(sym, arg_params, aux_params, data_names,
                          calib_data, num_calib_examples, mode,
                          min_percentile=None, ctx=None):
    """Run the FLOAT graph over the calibration batches on ``ctx`` (the
    current context by default), recording each quantizable node's input
    range (the reference's calibration pass). Min and max are reduced on
    the device; only the entropy subsample reaches the host."""
    from ..context import current_context
    from ..symbol.symbol import Symbol

    targets = {}
    for node in sym.topo_nodes():
        if node.op in ("FullyConnected", "Convolution"):
            targets[node.name] = node.inputs[0]
    if not targets:
        return {}
    ctx = ctx or current_context()
    probe = Symbol(list(targets.values()))
    names = list(targets)
    # streaming statistics: 'naive' keeps a running min/max, 'entropy' a
    # bounded subsample a layer, never the whole activation history
    minmax = {n: (np.inf, -np.inf) for n in names}
    samples = {n: [] for n in names}
    cap = 1 << 20         # elements a layer for the entropy search
    kept = {n: 0 for n in names}
    seen = 0
    exe = None
    rs = np.random.RandomState(0)

    def on_ctx(d):
        return d.as_in_context(ctx) if isinstance(d, NDArray) else \
            NDArray(torch.as_tensor(np.asarray(d))).as_in_context(ctx)

    for batch in calib_data:
        datas = [on_ctx(d) for d in
                 (batch.data if hasattr(batch, "data") else [batch])]
        if exe is None:   # bind once; later batches reuse the executor
            feed = {dn: d for dn, d in zip(data_names, datas)}
            for k, v in arg_params.items():
                feed.setdefault(k, on_ctx(v))
            live = set(probe.list_inputs())
            exe = probe.bind(ctx, {k: v for k, v in feed.items()
                                   if k in live}, grad_req="null",
                             aux_states={k: on_ctx(v) for k, v in
                                         dict(aux_params).items()} or None)
            outs = exe.forward()
        else:
            outs = exe.forward(**{dn: d for dn, d in zip(data_names, datas)})
        for n, o in zip(names, outs):
            a = o._data.reshape(-1)
            lo, hi = minmax[n]
            minmax[n] = (min(lo, float(a.min())), max(hi, float(a.max())))
            if mode == "entropy" and kept[n] < cap:
                take = min(cap - kept[n], a.numel())
                # with replacement: O(take), the JAX package's draws
                if take == a.numel():
                    sel = a
                else:
                    idx = torch.from_numpy(rs.randint(0, a.numel(), take))
                    sel = a[idx.to(a.device)]
                samples[n].append(sel.cpu().numpy())
                kept[n] += take
        seen += datas[0].shape[0]
        if num_calib_examples and seen >= num_calib_examples:
            break
    ranges = {}
    for n in names:
        if mode == "entropy":
            ranges[n] = calib_entropy(np.concatenate(samples[n])
                                      if samples[n] else np.zeros(1),
                                      min_percentile=min_percentile)
        else:
            ranges[n] = minmax[n]
    return ranges


def _trace_gluon(net):
    """An initialized gluon net as (symbol, arg_params, aux_params),
    through the Symbol trace ``hybridize()`` uses."""
    from .. import symbol as sym_mod

    out = net(sym_mod.Variable("data"))
    if isinstance(out, (list, tuple)):
        out = out[0]
    var_names = {n.name for n in out.topo_nodes() if n.is_var}
    arg_params, aux_params = {}, {}
    for p in net.collect_params().values():
        if p.name in var_names and p.name != "data":
            dst = aux_params if p.grad_req == "null" else arg_params
            dst[p.name] = p.data()
    return out, arg_params, aux_params


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=(), calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   calib_min_percentile=99.0, ctx=None, **kwargs):
    """``quantize_model`` with the reference's signature
    (``contrib/quantization.py:quantize_model``): conv/FC become int8
    islands through :func:`quantize_graph`. ``calib_mode`` 'none'
    quantizes activations from their runtime min/max; 'naive' (min/max
    over ``calib_data``) and 'entropy' (the KL threshold) bake calibrated
    constant ranges in. Calibration runs on ``ctx`` (the current context
    by default).

    ``calib_min_percentile`` (the JAX package's extension, default 99.0;
    None for the reference's calibration) floors the entropy threshold at
    that percentile of |x|."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype!r}")
    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} requires calib_data")
        calib_ranges = _collect_calib_ranges(
            sym, arg_params, aux_params, data_names, calib_data,
            num_calib_examples, calib_mode,
            min_percentile=calib_min_percentile, ctx=ctx)
    elif calib_mode != "none":
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    qsym, extra = quantize_graph(sym, arg_params,
                                 excluded_sym_names=excluded_sym_names,
                                 calib_ranges=calib_ranges)
    qarg = dict(arg_params)
    qarg.update(extra)
    return qsym, qarg, dict(aux_params)

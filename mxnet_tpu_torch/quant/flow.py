"""The quantization flow: calibrate → quantize (through the passes) →
evaluate → serve.

Counterpart of ``mxnet_tpu/quant/flow.py``, after the reference's recipe
``example/quantization/imagenet_gen_qsym.py`` (calibrate a float model
over a small iterator, rewrite it to int8, ship the quantized symbol and
parameters). The quantized model drops into the serving stack as a tier
of its own (``ModelConfig(tier="int8")``, ``MXNET_SERVE_TIER=int8``).
The latency rows of the tuner's cost ledger (``compare_latency``,
``quant_rows``, ``best_int8_cached``) and the quant telemetry wait for the
tuner and observability layers (ROADMAP A9).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

from ..base import MXNetError
from .calib import CalibTable, collect
from .qpass import ACC_OPS, DequantizePass, QuantizePass, RequantizePass

__all__ = ["quantize_symbol", "quantize_model", "evaluate_agreement",
           "compare_latency", "quant_rows", "best_int8_cached",
           "is_quantized_symbol", "quantize_model_config", "ensure_tier"]

_A9 = ("the tuner's cost ledger waits for ROADMAP A9 (the tuner and "
       "observability layers)")


def is_quantized_symbol(sym) -> bool:
    """True when the graph already holds int8 compute islands."""
    return any(not n.is_var and n.op in ACC_OPS for n in sym.topo_nodes())


def quantize_symbol(sym, arg_params, *, table: Optional[CalibTable] = None,
                    excluded_sym_names: Sequence[str] = (),
                    exclude_first_conv: bool = True,
                    exclude_last_fc: bool = True,
                    model: Optional[str] = None):
    """Rewrite ``sym`` through the opt-in quantization passes.

    Returns ``(qsym, extra_params, pass_result)``: merge ``extra_params``
    (int8 weights and range scalars, made from ``arg_params`` on their
    device) into the bind dict. The graph is the one
    ``contrib.quantization.quantize_graph`` makes."""
    from ..passes import PassManager
    mgr = PassManager([
        QuantizePass(table=table, excluded=excluded_sym_names,
                     exclude_first_conv=exclude_first_conv,
                     exclude_last_fc=exclude_last_fc),
        RequantizePass(table=table),
        DequantizePass(),
    ], rehome_params=False)
    res = mgr.run(sym, param_names=list(arg_params))
    return res.symbol, res.materialize_params(arg_params), res


def quantize_model(sym, arg_params, aux_params=None, *,
                   calib_iter: Optional[Iterable] = None,
                   calib_mode: str = "entropy",
                   data_names: Sequence[str] = ("data",),
                   num_calib_examples: Optional[int] = None,
                   excluded_sym_names: Sequence[str] = (),
                   exclude_first_conv: bool = True,
                   exclude_last_fc: bool = True,
                   table: Optional[CalibTable] = None,
                   calib_min_percentile: Optional[float] = 99.0,
                   model: Optional[str] = None, ctx=None):
    """The one-call flow: calibrate on ``ctx`` (unless a ``table`` or
    ``calib_mode='none'`` says otherwise) and quantize by the pass route.

    Returns ``(qsym, qarg_params, qaux_params, table)``; ``table`` is
    None under ``calib_mode='none'`` (runtime ranges)."""
    aux_params = dict(aux_params or {})
    if table is None and calib_mode != "none":
        if calib_iter is None:
            raise MXNetError(
                f"calib_mode={calib_mode!r} needs calib_iter (or pass a "
                "pre-collected table=CalibTable)")
        table = collect(sym, arg_params, aux_params, calib_iter,
                        data_names=data_names, mode=calib_mode,
                        num_calib_examples=num_calib_examples,
                        min_percentile=calib_min_percentile, model=model,
                        ctx=ctx)
    qsym, extra, _res = quantize_symbol(
        sym, arg_params, table=table, excluded_sym_names=excluded_sym_names,
        exclude_first_conv=exclude_first_conv,
        exclude_last_fc=exclude_last_fc, model=model)
    qarg = dict(arg_params)
    qarg.update(extra)
    return qsym, qarg, aux_params, table


# --------------------------------------------------------------------------
# accuracy harness
# --------------------------------------------------------------------------

def _bind_forward(sym, params, aux, ctx=None):
    """x -> the graph's first output as numpy, one executor a batch shape
    on ``ctx`` (the current context by default)."""
    from .. import ndarray as nd_mod
    from ..context import current_context
    ctx = ctx or current_context()
    params = {k: v.as_in_context(ctx) for k, v in params.items()}
    aux = {k: v.as_in_context(ctx) for k, v in dict(aux or {}).items()}
    live = set(sym.list_arguments())
    exes: Dict[tuple, Any] = {}

    def run(x):
        key = tuple(np.asarray(x).shape)
        exe = exes.get(key)
        if exe is None:
            feed = {k: v for k, v in params.items() if k in live}
            feed["data"] = nd_mod.array(x, ctx=ctx)
            exes[key] = exe = sym.bind(ctx, feed, grad_req="null",
                                       aux_states=aux or None)
            return exe.forward()[0].asnumpy()
        return exe.forward(data=nd_mod.array(x, ctx=ctx))[0].asnumpy()

    return run


def evaluate_agreement(sym, arg_params, aux_params, qsym, qarg_params,
                       qaux_params, eval_data: Iterable,
                       labels: Optional[np.ndarray] = None, ctx=None
                       ) -> Dict[str, Any]:
    """Top-1 accuracy of the float and int8 models over ``eval_data`` (an
    iterable of input batches or ``DataBatch``es), on ``ctx``.

    ``labels`` (over all batches) ground the accuracy; without them the
    float model's own argmax is the label, and the accuracy reads as top-1
    agreement (float accuracy 1.0 by construction). Returns ``{"fp32_acc",
    "int8_acc", "acc_delta", "n"}``."""
    f32 = _bind_forward(sym, arg_params, aux_params, ctx)
    int8 = _bind_forward(qsym, qarg_params, qaux_params, ctx)
    f32_top, int8_top = [], []
    for batch in eval_data:
        is_databatch = (hasattr(batch, "data")
                        and not isinstance(batch, np.ndarray))
        x = np.asarray(batch.data[0].asnumpy() if is_databatch else batch)
        f32_top.append(np.argmax(f32(x), axis=-1))
        int8_top.append(np.argmax(int8(x), axis=-1))
    f32_top = np.concatenate(f32_top) if f32_top else np.zeros(0, np.int64)
    int8_top = np.concatenate(int8_top) if int8_top else np.zeros(0, np.int64)
    n = int(f32_top.size)
    if labels is None:
        labels = f32_top
    labels = np.asarray(labels).ravel()[:n]
    fp32_acc = float((f32_top == labels).mean()) if n else 0.0
    int8_acc = float((int8_top == labels).mean()) if n else 0.0
    return {"fp32_acc": fp32_acc, "int8_acc": int8_acc,
            "acc_delta": fp32_acc - int8_acc, "n": n}


def compare_latency(*args, **kwargs):
    raise NotImplementedError(f"compare_latency: {_A9}")


def quant_rows(*args, **kwargs):
    raise NotImplementedError(f"quant_rows: {_A9}")


def best_int8_cached(*args, **kwargs):
    raise NotImplementedError(f"best_int8_cached: {_A9}")


# --------------------------------------------------------------------------
# serving tier
# --------------------------------------------------------------------------

def quantize_model_config(cfg, *, table: Optional[CalibTable] = None,
                          excluded_sym_names: Sequence[str] = (),
                          exclude_first_conv: bool = True,
                          exclude_last_fc: bool = True):
    """A serving :class:`~mxnet_tpu_torch.serving.server.ModelConfig` ->
    its int8 tier: the symbol rewritten through the passes on the
    config's device (runtime ranges unless ``table`` gives calibrated
    ones), the parameters written as the reference's ``.params`` (int8
    codes, float32 range scalars), every serving knob carried over and
    ``tier`` set to ``"int8"``."""
    from .. import interop
    from ..context import Context
    from ..native.predict_bridge import _load_param_bytes
    from ..serving.server import ModelConfig
    from ..symbol import load_json

    ctx = Context("cpu" if cfg.dev_type == 1 else "gpu", cfg.dev_id)
    sym = load_json(cfg.symbol_json)
    arg, aux = _load_param_bytes(cfg.param_bytes, ctx)
    qsym, qarg, qaux, _ = quantize_model(
        sym, arg, aux, calib_mode="none", table=table,
        excluded_sym_names=excluded_sym_names,
        exclude_first_conv=exclude_first_conv,
        exclude_last_fc=exclude_last_fc, model=cfg.name)
    live = set(qsym.list_arguments())
    params = {f"arg:{k}": v for k, v in qarg.items() if k in live}
    params.update({f"aux:{k}": v for k, v in qaux.items()
                   if k in set(qsym.list_auxiliary_states())})
    fd, pfile = tempfile.mkstemp(suffix=".params")
    os.close(fd)
    try:
        interop.save_reference_params(pfile, params)
        with open(pfile, "rb") as f:
            pbytes = f.read()
    finally:
        os.unlink(pfile)
    qcfg = ModelConfig(
        cfg.name, qsym.tojson(), pbytes,
        feature_shape=cfg.feature_shape, input_name=cfg.input_name,
        buckets=cfg.buckets, max_queue=cfg.max_queue,
        deadline_ms=cfg.deadline_ms, max_wait_ms=cfg.max_wait_ms,
        retries=cfg.retries, breaker_threshold=cfg.breaker_threshold,
        breaker_cooldown_s=cfg.breaker_cooldown_s, dev_type=cfg.dev_type,
        dev_id=cfg.dev_id, output_keys=cfg.output_keys,
        retry_budget=cfg.retry_budget, tier="int8")
    qcfg.bucket_provenance = cfg.bucket_provenance
    return qcfg


def ensure_tier(cfg):
    """A ModelConfig resolved to its serving tier: one asking for
    ``tier="int8"`` (or through ``MXNET_SERVE_TIER``) whose graph is still
    float is quantized here; ``ModelServer`` calls this once a model when
    it builds the model's state."""
    if getattr(cfg, "tier", "f32") != "int8":
        return cfg
    from ..symbol import load_json
    if is_quantized_symbol(load_json(cfg.symbol_json)):
        return cfg
    return quantize_model_config(cfg)

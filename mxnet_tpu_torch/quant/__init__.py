"""mxnet_tpu_torch.quant — post-training int8 quantization: calibrate →
quantize (as graph passes) → evaluate → serve int8.

Counterpart of ``mxnet_tpu/quant``:

=========  =============================================================
piece       what it gives
=========  =============================================================
calib       :class:`CalibTable` (per-tensor activation ranges, the JAX
            package's JSON) and :func:`collect` (streaming naive or
            entropy calibration of a float model)
qpass       :class:`QuantizePass` / :class:`RequantizePass` /
            :class:`DequantizePass` — the reference's int8 island as
            opt-in passes, never in the default pipeline
flow        :func:`quantize_model` (the ``imagenet_gen_qsym.py`` flow),
            :func:`evaluate_agreement` (top-1 of float against int8),
            :func:`quantize_model_config` / :func:`ensure_tier` (the
            serving stack's int8 tier)
=========  =============================================================

``compare_latency``, ``quant_rows`` and ``best_int8_cached`` raise
``NotImplementedError``: they read and write the tuner's cost ledger,
which waits for ROADMAP A9.
"""
from __future__ import annotations

from .calib import CalibTable, collect
from .qpass import (ACC_OPS, QUANT_PIPELINE, QUANT_FAMILY_OPS,
                    DequantizePass, QuantizePass, RequantizePass)
from .flow import (best_int8_cached, compare_latency, ensure_tier,
                   evaluate_agreement, is_quantized_symbol, quant_rows,
                   quantize_model, quantize_model_config, quantize_symbol)

__all__ = ["CalibTable", "collect",
           "ACC_OPS", "QUANT_PIPELINE", "QUANT_FAMILY_OPS",
           "QuantizePass", "RequantizePass", "DequantizePass",
           "quantize_symbol", "quantize_model", "evaluate_agreement",
           "compare_latency", "quant_rows", "best_int8_cached",
           "is_quantized_symbol", "quantize_model_config", "ensure_tier"]

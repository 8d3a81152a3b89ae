"""Dynamic loss scaling for the fused trainer's step.

The port's own copy of the scaler in ``mxnet_tpu/resilience/recovery.py``
(``:121-209``): ``scaler_config`` normalises
``DataParallelTrainer(loss_scaling=...)`` with the same defaults and
errors, ``scaler_init_state`` makes the scaler's state as 0-d tensors on
the trainer's device, and ``scaler_apply`` is one scale transition made on
that device (``torch.where``, no host read). The rest of the JAX module
(``ResilientTrainer``, the recovery ladder, snapshots) waits for ROADMAP
A9.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..base import MXNetError

__all__ = ["scaler_config", "scaler_init_state", "scaler_apply"]


def _require_pow2(name: str, value) -> None:
    """Scale arithmetic is only bitwise-exact (``loss * s`` then ``g / s``
    round-trips in f32) when every factor the scale is built from is a
    power of two: anything else is refused."""
    v = float(value)
    if v <= 0 or math.frexp(v)[0] != 0.5:
        raise MXNetError(
            "%s must be a positive power of two (got %r): non-power-of-two "
            "loss-scale factors make scaling inexact in f32, breaking the "
            "bitwise resume-equivalence guarantee" % (name, value))


_SCALER_DEFAULTS = {"init_scale": 2.0 ** 10, "growth_interval": 200,
                    "growth": 2.0, "backoff": 0.5, "min_scale": 1.0,
                    "max_scale": 2.0 ** 24}


def scaler_config(loss_scaling) -> Optional[Dict[str, float]]:
    """Normalize ``DataParallelTrainer(loss_scaling=...)``: any falsy
    spelling (None/False/0/{}) = off; True = the defaults; a non-empty dict
    overrides ``init_scale``/``growth_interval``/``growth``/``backoff``/
    ``min_scale``/``max_scale``."""
    if not loss_scaling:
        return None
    over = dict(loss_scaling) if isinstance(loss_scaling, dict) else {}
    unknown = set(over) - set(_SCALER_DEFAULTS)
    if unknown:
        raise MXNetError("unknown loss_scaling knob(s) %s; valid: %s"
                         % (sorted(unknown), sorted(_SCALER_DEFAULTS)))
    cfg = dict(_SCALER_DEFAULTS, **over)
    cfg["growth_interval"] = int(cfg["growth_interval"])
    for knob in ("init_scale", "growth", "backoff", "min_scale", "max_scale"):
        _require_pow2("loss_scaling %s" % knob, cfg[knob])
    return cfg


def scaler_init_state(cfg, device) -> Dict[str, torch.Tensor]:
    """Fresh scaler state, 0-d tensors on ``device``, merged into the
    trainer's guard state."""
    return {"loss_scale": torch.tensor(float(cfg["init_scale"]),
                                       dtype=torch.float32, device=device),
            "ls_good": torch.zeros((), dtype=torch.int32, device=device),
            "ls_overflows": torch.zeros((), dtype=torch.int32,
                                        device=device)}


def scaler_apply(cfg, gstate, overflow, bad) -> Dict[str, torch.Tensor]:
    """One scale transition. ``overflow``: the gradient was non-finite;
    ``bad``: the guard skipped the step for any reason (overflow or a norm
    spike). Overflow halves the scale and resets the growth counter; a
    clean step advances it and every ``growth_interval`` of them doubles
    the scale; a spike-skip leaves both alone."""
    scale, good = gstate["loss_scale"], gstate["ls_good"]
    halved = torch.clamp_min(scale * cfg["backoff"], cfg["min_scale"])
    good2 = torch.where(overflow, torch.zeros_like(good),
                        torch.where(bad, good, good + 1))
    grow = ~bad & (good2 >= cfg["growth_interval"])
    new_scale = torch.where(
        overflow, halved,
        torch.where(grow, torch.clamp_max(scale * cfg["growth"],
                                          cfg["max_scale"]), scale))
    new_good = torch.where(grow | overflow, torch.zeros_like(good2), good2)
    return {"loss_scale": new_scale.to(torch.float32),
            "ls_good": new_good.to(torch.int32),
            "ls_overflows": gstate["ls_overflows"] + overflow.to(torch.int32)}

"""Global seed and per-device generators.

Counterpart of ``mxnet_tpu/random.py``. Where the JAX package threads a
counter-based key stream, the port keeps one ``torch.Generator`` per
device, all derived from the global seed: ``seed(n)`` resets them, and an
op that draws random numbers takes the generator of its input's device.
Torch's streams do not reproduce JAX's bits; tests that compare the two
packages feed both the same numpy noise or compare statistics.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np
import torch

from .base import get_env

__all__ = ["seed", "generator", "host_rng"]

_lock = threading.Lock()
_state: Dict[str, object] = {"seed": None, "gens": {}, "host": None}


def _root() -> int:
    if _state["seed"] is None:
        env = int(get_env("MXNET_SEED", -1))
        _state["seed"] = env if env >= 0 else (time.time_ns() & 0x7FFFFFFF)
    return _state["seed"]


def seed(seed_state: int, ctx="all") -> None:
    """Reset the global seed; every device's generator restarts from it
    (``ctx`` is accepted for API parity)."""
    with _lock:
        _state["seed"] = int(seed_state)
        _state["gens"] = {}
        _state["host"] = None


def generator(device: torch.device) -> torch.Generator:
    """The generator that random ops on ``device`` draw from."""
    key = str(torch.device(device))
    with _lock:
        gen = _state["gens"].get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(_root())
            _state["gens"][key] = gen
        return gen


def host_rng() -> np.random.RandomState:
    """The numpy stream of host-side draws (``NDArrayIter``'s shuffle
    seed), restarted by :func:`seed`."""
    with _lock:
        if _state["host"] is None:
            _state["host"] = np.random.RandomState(_root())
        return _state["host"]

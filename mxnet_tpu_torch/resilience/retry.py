"""Retry-with-backoff around transiently failing operations.

Port-local counterpart of ``retry_transient`` in
``mxnet_tpu/resilience/retry.py``, the policy the serving dispatch retries
executor faults with. A fault is transient only when it says so: typed
framework errors and device errors (a CUDA fault, an out-of-memory) are
never retried in place.
"""
from __future__ import annotations

import random as _pyrandom
import time
from typing import Callable, Optional

from ..base import MXNetError, logger

__all__ = ["retry_transient", "is_transient", "backoff_delay"]

_TRANSIENT_MARKERS = ("unavailable", "aborted", "deadline exceeded",
                      "cancelled", "connection reset", "socket closed",
                      "failed to connect")


def is_transient(exc: BaseException) -> bool:
    """Is this exception worth retrying? Only an ``OSError`` carrying a
    retryable status marker is."""
    if isinstance(exc, MXNetError) or not isinstance(exc, OSError):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


def backoff_delay(attempt: int, base: float, cap: float,
                  jitter: float = 0.25) -> float:
    """Sleep before retry ``attempt + 1``: exponential from ``base``,
    capped at ``cap``, with multiplicative jitter."""
    d = min(cap, base * (2.0 ** attempt))
    return d * (1.0 + jitter * _pyrandom.random()) if jitter > 0 else d


def retry_transient(fn: Callable, *, attempts: int = 3,
                    base_delay: float = 0.5, max_delay: float = 30.0,
                    on_retry: Optional[Callable] = None,
                    gate: Optional[Callable[[BaseException], bool]] = None):
    """Call ``fn()``; on a transient failure (:func:`is_transient`), back
    off and retry. ``gate(exc)`` must return True to spend a retry
    (the serving retry budget plugs in here); ``on_retry(attempt, exc,
    delay)`` runs before each sleep. The final failure is re-raised
    unchanged.
    """
    attempts = max(1, int(attempts))
    for i in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - reclassified below
            if not is_transient(e) or i >= attempts - 1:
                raise
            if gate is not None and not gate(e):
                raise
            delay = backoff_delay(i, base_delay, max_delay)
            if on_retry is not None:
                on_retry(i, e, delay)
            else:
                logger.warning("transient failure (attempt %d/%d), retrying "
                               "in %.2fs: %r", i + 1, attempts, delay, e)
            time.sleep(delay)

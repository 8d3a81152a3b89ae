"""Per-model circuit breaker: fail fast after repeated executor faults.

Counterpart of ``mxnet_tpu/serving/breaker.py``: closed -> open after
``threshold`` consecutive failed dispatches; after ``cooldown_s`` one
half-open probe is let through, whose success closes the breaker and whose
failure re-opens it. A probe whose verdict never arrives re-admits another
after a further cooldown.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    """Thread-safe consecutive-failure breaker."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if int(threshold) < 1:
            raise ValueError("breaker threshold must be >= 1, got %r"
                             % (threshold,))
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a dispatch proceed now? Past its cooldown an open breaker
        goes half-open and admits one probe."""
        with self._lock:
            now = self._clock()
            if self._state == "closed":
                return True
            if self._state == "open":
                if now - self._opened_at >= self.cooldown_s:
                    self._state = "half-open"
                    self._half_open_at = now
                    return True
                return False
            if now - self._half_open_at >= self.cooldown_s:
                self._half_open_at = now       # the probe's verdict was lost
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0

    def record_failure(self) -> bool:
        """Count one failed dispatch; True when it opened the circuit."""
        with self._lock:
            self._failures += 1
            if self._state == "half-open" \
                    or self._failures >= self.threshold:
                opened = self._state != "open"
                self._state = "open"
                self._opened_at = self._clock()
                if opened:
                    self._trips += 1
                return opened
            return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s, "trips": self._trips}

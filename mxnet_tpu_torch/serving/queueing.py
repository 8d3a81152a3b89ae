"""Bounded per-model request queue, deadline-aware batch assembly, and the
retry budget.

Counterpart of ``BoundedRequestQueue`` and ``RetryBudget`` in
``mxnet_tpu/serving/queueing.py``. :meth:`BoundedRequestQueue.put` runs on
the client thread (one lock, one append): a full queue first sheds entries
already past their deadline, then rejects with a typed ``Overloaded``.
:meth:`BoundedRequestQueue.take_batch` runs on the model's worker: once the
first request is in hand it waits up to an assembly window that shrinks
linearly with queue depth (zero at capacity), and diverts expired requests
to a separate list, so no request past its deadline is ever dispatched.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .errors import Draining, Overloaded

__all__ = ["BoundedRequestQueue", "RetryBudget"]


class BoundedRequestQueue:
    """Deque + condition with admission control and batch assembly.

    ``capacity`` <= 0 means unbounded. Items expose ``deadline``, an
    absolute :func:`time.monotonic` second or None.
    """

    def __init__(self, capacity: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = int(capacity or 0)
        self._clock = clock
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def depth(self) -> int:
        return len(self)

    def _drop_expired_locked(self, now: float) -> List:
        alive, expired = deque(), []
        for r in self._q:
            (expired if r.deadline is not None and r.deadline <= now
             else alive).append(r)
        self._q = alive
        return expired

    def put(self, req) -> List:
        """Admit one request or raise :class:`Overloaded`; a closed queue
        raises :class:`Draining`. Returns the expired entries shed to make
        room (the caller answers them ``DeadlineExceeded``)."""
        with self._lock:
            if self._closed:
                raise Draining("queue closed: server is draining")
            expired: List = []
            if self.capacity > 0 and len(self._q) >= self.capacity:
                expired = self._drop_expired_locked(self._clock())
                if len(self._q) >= self.capacity:
                    raise Overloaded(
                        "request queue full (%d/%d): overloaded — retry "
                        "with backoff" % (len(self._q), self.capacity))
            self._q.append(req)
            self._cond.notify()
            return expired

    def close(self) -> None:
        """Reject every later :meth:`put`; queued work stays takeable."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    def effective_wait(self, base_wait_s: float) -> float:
        """The assembly window under current load: ``base_wait_s`` idle,
        shrinking linearly with depth, zero at capacity."""
        if self.capacity <= 0:
            return base_wait_s
        with self._lock:
            depth = len(self._q)
        return base_wait_s * max(0.0, 1.0 - depth / float(self.capacity))

    def take_batch(self, max_size: int, wait_s: float,
                   should_stop: Callable[[], bool],
                   idle_poll_s: float = 0.1) -> Tuple[Optional[List], List]:
        """Assemble the next batch: ``(batch, expired)``.

        ``batch`` is None only when the queue is closed and empty; an empty
        ``batch`` with the queue open means ``should_stop`` asked to wind
        down. ``should_stop`` runs under the queue lock and must be a pure
        flag check.
        """
        with self._lock:
            while not self._q:
                if self._closed:
                    return None, []
                if should_stop():
                    return [], []
                self._cond.wait(timeout=idle_poll_s)
            now = self._clock()
            batch: List = []
            expired: List = []

            def _collect():
                while self._q and len(batch) < max_size:
                    r = self._q.popleft()
                    (expired if r.deadline is not None
                     and r.deadline <= self._clock() else batch).append(r)

            _collect()
            assembly_end = now + max(0.0, wait_s)
            while batch and len(batch) < max_size and not should_stop():
                remaining = assembly_end - self._clock()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
                _collect()
            return batch, expired

    def drain_remaining(self) -> List:
        """Pop everything (stop path: the caller fails them typed)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out


class RetryBudget:
    """Token bucket for retries: every admitted request deposits
    ``fraction`` of a token, every retry spends one, so retries stay near
    ``fraction`` of offered traffic and cannot amplify an overload."""

    def __init__(self, fraction: float = 0.1, burst: float = 5.0):
        if not 0.0 < fraction <= 1.0:
            raise ValueError("RetryBudget fraction must be in (0, 1], "
                             "got %r" % (fraction,))
        self.fraction = float(fraction)
        self.burst = float(burst)
        self._tokens = self.burst
        self._denied: Dict[str, int] = {}
        self._spent: Dict[str, int] = {}
        self._lock = threading.Lock()

    def deposit(self, n: float = 1.0) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n * self.fraction)

    def try_spend(self, kind: str = "retry") -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._spent[kind] = self._spent.get(kind, 0) + 1
                return True
            self._denied[kind] = self._denied.get(kind, 0) + 1
            return False

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"fraction": self.fraction, "tokens": self._tokens,
                    "spent": dict(self._spent), "denied": dict(self._denied)}

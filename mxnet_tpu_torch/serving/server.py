"""Overload-safe batching model server.

Counterpart of the core of ``mxnet_tpu/serving/server.py``. A
:class:`ModelServer` owns, per model, a bounded request queue
(:mod:`.queueing`), one dispatch worker over the bucket executor cache
(:mod:`.executors`) and a circuit breaker (:mod:`.breaker`). It degrades
instead of collapsing:

- **admission control** — a full queue answers a typed ``Overloaded`` at
  once instead of accepting work it cannot finish;
- **deadlines end to end** — every request carries an absolute deadline;
  expired work is shed before dispatch and never reaches the card;
- **load shedding under depth** — the batch-assembly window shrinks
  linearly as the queue fills (zero at capacity);
- **fault isolation** — executor faults retry with
  :func:`~mxnet_tpu_torch.resilience.retry.retry_transient` under a retry
  budget; a batch that still fails is re-dispatched request by request, so
  one poison request cannot fail its batchmates; repeated faults open the
  model's breaker, which fails fast until a cooldown probe succeeds;
- **drain** — :meth:`ModelServer.drain` / :meth:`ModelServer.close`:
  accepted work finishes, new work gets a typed ``Draining``.

Request tracing, hedging, the device sentinel and degraded ladder, the
fleet, rollouts, the int8 tier, memory accounting and the SIGTERM drain
hook are later slices of the port (ROADMAP A); a keyword that would turn
one of them on raises ``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..base import MXNetError, get_env, logger, register_config
from .breaker import CircuitBreaker
from .errors import (CircuitOpen, DeadlineExceeded, Draining, ExecutorFault,
                     ServingError)
from .executors import BucketExecutorCache, default_buckets
from .queueing import BoundedRequestQueue, RetryBudget

__all__ = ["ModelConfig", "ModelServer", "PendingResult"]

register_config("MXNET_SERVE_MAX_QUEUE", 64, int,
                "Default per-model request-queue bound (admission control). "
                "0 = unbounded.")
register_config("MXNET_SERVE_DEADLINE_MS", 250.0, float,
                "Default per-request latency deadline. Expired requests "
                "are answered DeadlineExceeded and never dispatched. "
                "0 = no default deadline.")
register_config("MXNET_SERVE_MAX_WAIT_MS", 5.0, float,
                "Base batch-assembly window; shrinks linearly with queue "
                "depth, zero at capacity.")
register_config("MXNET_SERVE_RETRIES", 2, int,
                "Transient-executor-fault retries per dispatch.")
register_config("MXNET_SERVE_BREAKER_THRESHOLD", 3, int,
                "Consecutive failed dispatches that open a model's "
                "circuit breaker.")
register_config("MXNET_SERVE_BREAKER_COOLDOWN", 5.0, float,
                "Seconds an open breaker waits before one half-open probe.")
register_config("MXNET_SERVE_RETRY_BUDGET", 0.1, float,
                "Retry-budget fraction: retries may spend at most ~this "
                "fraction of admitted traffic. 0 disables the budget.")

#: keyword -> (value that leaves the feature off, ROADMAP item)
_LATER_SLICES = {
    "tier": ((None, "f32"), "A4 serving: int8 tier"),
    "trace": ((None, False), "A4 serving: request tracing"),
    "trace_sample": ((None,), "A4 serving: request tracing"),
    "slo_p99_ms": ((None, 0, 0.0), "A4 serving: SLO burn-rate tracking"),
    "slo_availability": ((None,), "A4 serving: SLO burn-rate tracking"),
    "hedge": ((None, False), "A4 serving: hedged requests"),
    "hedge_delay_ms": ((None,), "A4 serving: hedged requests"),
}


def _now() -> float:
    return time.monotonic()


class PendingResult:
    """Client-side future for one submitted request; completed once."""

    __slots__ = ("_ev", "_win", "_value", "_error", "_outcome")

    def __init__(self):
        self._ev = threading.Event()
        self._win = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self._outcome: Optional[str] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def outcome(self) -> Optional[str]:
        """'ok' | 'shed' | 'expired' | 'error' once completed."""
        return self._outcome

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._ev.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def _claim(self, value=None, error=None, outcome="ok") -> bool:
        """Claim the result without waking waiters (the completer finishes
        its accounting first)."""
        with self._win:
            if self._outcome is not None:
                return False
            self._value, self._error, self._outcome = value, error, outcome
        return True


class _Request:
    __slots__ = ("data", "deadline", "submitted_at", "dispatch_at",
                 "pending")

    def __init__(self, data: np.ndarray, deadline: Optional[float],
                 submitted_at: float):
        self.data = data
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.dispatch_at: Optional[float] = None
        self.pending = PendingResult()


class ModelConfig:
    """Everything the server needs to serve one model.

    ``max_queue`` / ``deadline_ms`` / ``max_wait_ms`` / retry and breaker
    knobs default from the ``MXNET_SERVE_*`` environment; ``max_queue=0``
    or ``deadline_ms=0`` mean unbounded / no default deadline.

    ``dev_type`` defaults to 2, the GPU ``dev_id``: unlike the JAX package,
    whose ``ModelConfig`` defaults to the host (``dev_type=1``), the port
    serves on the card unless the caller asks for the CPU with
    ``dev_type=1``. Asking for the card without CUDA raises when the
    server binds the model. ``param_bytes`` is the bytes of an ``MXTPU001``
    params file, or the dict :func:`~mxnet_tpu_torch.interop.
    params_from_numpy` returns.
    """

    def __init__(self, name: str, symbol_json: str, param_bytes=b"", *,
                 feature_shape: Sequence[int], input_name: str = "data",
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_wait_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 dev_type: int = 2, dev_id: int = 0,
                 output_keys: Optional[List[str]] = None,
                 retry_budget: Optional[float] = None,
                 **later):
        for key, value in later.items():
            if key not in _LATER_SLICES:
                raise TypeError(f"ModelConfig got an unexpected keyword "
                                f"{key!r}")
            off, item = _LATER_SLICES[key]
            if value not in off:
                raise NotImplementedError(
                    f"ModelConfig({key}={value!r}) needs a layer the PyTorch "
                    f"port does not have yet (ROADMAP {item})")
        if not name:
            raise MXNetError("ModelConfig needs a model name")
        self.name = str(name)
        self.symbol_json = symbol_json
        self.param_bytes = param_bytes
        self.input_name = str(input_name)
        self.feature_shape = tuple(int(x) for x in feature_shape)
        if buckets is not None:
            self.buckets = tuple(sorted({int(b) for b in buckets}))
            self.bucket_provenance = "explicit"
        else:
            self.buckets, self.bucket_provenance = default_buckets()

        def knob(value, env, default, typ):
            return typ(get_env(env, default) if value is None else value)

        self.max_queue = knob(max_queue, "MXNET_SERVE_MAX_QUEUE", 64, int)
        self.deadline_ms = knob(deadline_ms, "MXNET_SERVE_DEADLINE_MS",
                                250.0, float)
        self.max_wait_ms = knob(max_wait_ms, "MXNET_SERVE_MAX_WAIT_MS", 5.0,
                                float)
        self.retries = knob(retries, "MXNET_SERVE_RETRIES", 2, int)
        self.breaker_threshold = knob(breaker_threshold,
                                      "MXNET_SERVE_BREAKER_THRESHOLD", 3, int)
        self.breaker_cooldown_s = knob(breaker_cooldown_s,
                                       "MXNET_SERVE_BREAKER_COOLDOWN", 5.0,
                                       float)
        self.retry_budget = knob(retry_budget, "MXNET_SERVE_RETRY_BUDGET",
                                 0.1, float)
        if self.max_queue < 0:
            raise MXNetError("max_queue must be >= 0 (0 = unbounded)")
        if self.deadline_ms < 0 or self.max_wait_ms < 0:
            raise MXNetError("deadline_ms/max_wait_ms must be >= 0")
        if not 0.0 <= self.retry_budget <= 1.0:
            raise MXNetError("retry_budget must be in [0, 1], got %r"
                             % (self.retry_budget,))
        self.dev_type, self.dev_id = int(dev_type), int(dev_id)
        self.output_keys = output_keys


class _ModelState:
    """Per-model runtime: queue, worker, bucket cache, breaker, stats."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.queue = BoundedRequestQueue(cfg.max_queue)
        self.cache = BucketExecutorCache(
            cfg.symbol_json, cfg.param_bytes, input_name=cfg.input_name,
            feature_shape=cfg.feature_shape, buckets=cfg.buckets,
            dev_type=cfg.dev_type, dev_id=cfg.dev_id,
            output_keys=cfg.output_keys)
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s)
        self.budget = (RetryBudget(cfg.retry_budget)
                       if cfg.retry_budget > 0 else None)
        self.worker: Optional[threading.Thread] = None
        self.lock = threading.Lock()
        self.counts = {"ok": 0, "shed": 0, "expired": 0, "error": 0}
        self.batches = 0
        self.singles = 0
        self.retries = 0
        self.deadline_violations = 0
        self.latencies: List[float] = []   # ok-request ms, bounded ring


_LAT_RING = 8192


class ModelServer:
    """The batching front end: construct with configs, :meth:`start`,
    :meth:`submit`/:meth:`predict`, then :meth:`close`.

    >>> server = ModelServer([ModelConfig("m", sym_json, params,
    ...                                   feature_shape=(4,), dev_type=1)])
    >>> server.start(warm=True)
    >>> out = server.predict("m", np.zeros(4, "float32"))
    """

    def __init__(self, models: Sequence[ModelConfig], *,
                 drain_on_preemption: bool = False):
        if drain_on_preemption:
            raise NotImplementedError(
                "drain_on_preemption (the SIGTERM drain hook) needs the "
                "resilience layer's preemption guard (ROADMAP A4); call "
                "drain()/close() instead")
        if not models:
            raise MXNetError("ModelServer needs at least one ModelConfig")
        self._models: Dict[str, _ModelState] = {}
        for cfg in models:
            if cfg.name in self._models:
                raise MXNetError("duplicate model name %r" % cfg.name)
            self._models[cfg.name] = _ModelState(cfg)
        self._started = False
        self._stopped = False
        self._draining = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self, warm: bool = False) -> "ModelServer":
        """Start one worker per model; ``warm`` binds and runs every bucket
        once first (the kernel build included)."""
        if self._started:
            return self
        if self._stopped:
            raise MXNetError("server was closed; build a new one")
        for name, st in self._models.items():
            if warm:
                st.cache.warm()
            st.worker = threading.Thread(target=self._worker, args=(st,),
                                         daemon=True,
                                         name="mxserve-%s" % name)
            st.worker.start()
        self._started = True
        return self

    def begin_drain(self) -> None:
        """Enter draining: accepted work finishes, new work is rejected
        with :class:`Draining`. Closing the queues makes admission and
        drain atomic: no request can land after a worker decided to exit."""
        if not self._draining.is_set():
            self._draining.set()
            logger.info("model server draining: queues reject new work, "
                        "in-flight batches finish")
            for st in self._models.values():
                st.queue.close()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """begin_drain + wait for every worker to exit. True when fully
        drained within ``timeout``."""
        self.begin_drain()
        deadline = None if timeout is None else _now() + timeout
        for st in self._models.values():
            if st.worker is not None:
                left = None if deadline is None \
                    else max(0.0, deadline - _now())
                st.worker.join(timeout=left)
                if st.worker.is_alive():
                    return False
        return True

    def close(self, timeout: float = 30.0) -> bool:
        """Drain (bounded), then fail anything still queued with
        ``Draining``. Returns the drain() verdict."""
        if self._stopped:
            return True
        ok = self.drain(timeout=timeout)
        for st in self._models.values():
            for req in st.queue.drain_remaining():
                self._complete(st, req, error=Draining(
                    "server closed before this request was dispatched"),
                    outcome="shed")
        self._stopped = True
        return ok

    # ------------------------------------------------------------ admission
    def submit(self, model: str, data, deadline_ms: Optional[float] = None,
               deadline_at: Optional[float] = None) -> PendingResult:
        """Admit one request (one sample of the model's feature shape).

        ``deadline_ms`` overrides the model's default; ``deadline_at`` is an
        absolute :func:`time.monotonic` deadline and wins over both. Raises
        typed ``Overloaded`` / ``Draining``; executor errors surface on the
        returned :class:`PendingResult`.
        """
        st = self._models.get(model)
        if st is None:
            raise MXNetError("unknown model %r (serving: %s)"
                             % (model, ", ".join(sorted(self._models))))
        if not self._started:
            raise MXNetError("server not started")
        if self._draining.is_set() or self._stopped:
            self._count(st, "shed")
            raise Draining("server is draining: retry against another "
                           "replica")
        arr = np.asarray(data, dtype=np.float32)
        if tuple(arr.shape) != st.cfg.feature_shape:
            raise MXNetError(
                "request shape %r does not match model %r feature shape %r"
                % (tuple(arr.shape), model, st.cfg.feature_shape))
        now = _now()
        if deadline_at is None:
            dl_ms = st.cfg.deadline_ms if deadline_ms is None \
                else float(deadline_ms)
            deadline_at = now + dl_ms / 1e3 if dl_ms else None
        req = _Request(arr, deadline_at, now)
        try:
            shed = st.queue.put(req)
        except ServingError:
            self._count(st, "shed")
            raise
        if st.budget is not None:
            st.budget.deposit()
        for dead in shed:
            self._complete(st, dead, error=DeadlineExceeded(
                "deadline passed while queued (shed at admission)"),
                outcome="expired")
        return req.pending

    def predict(self, model: str, data, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """submit + wait."""
        return self.submit(model, data, deadline_ms=deadline_ms
                           ).result(timeout=timeout)

    # ------------------------------------------------------------- workers
    def _worker(self, st: _ModelState) -> None:
        cfg = st.cfg

        def stop_requested() -> bool:
            # flag only: take_batch calls this under the queue lock
            return self._draining.is_set() or self._stopped

        while True:
            wait_s = st.queue.effective_wait(cfg.max_wait_ms / 1e3)
            batch, expired = st.queue.take_batch(
                st.cache.max_bucket, wait_s, stop_requested)
            for req in expired:
                self._complete(st, req, error=DeadlineExceeded(
                    "deadline passed while queued (shed before dispatch)"),
                    outcome="expired")
            if batch is None:
                return              # queue closed and empty
            if not batch:
                continue
            try:
                self._dispatch(st, batch)
            except Exception as e:  # a worker must never die
                logger.exception("serving worker for %r: unexpected "
                                 "dispatch error: %r", cfg.name, e)
                st.breaker.record_failure()
                for req in batch:
                    if not req.pending.done():
                        self._complete(st, req, error=ExecutorFault(
                            "internal dispatch error: %r" % (e,)),
                            outcome="error")

    def _dispatch(self, st: _ModelState, batch: List[_Request]) -> None:
        # one timestamp for the expiry filter and the dispatch stamp, so a
        # dispatch past its deadline cannot slip in between two reads
        dispatch_at = _now()
        ready: List[_Request] = []
        for req in batch:
            if req.deadline is not None and req.deadline <= dispatch_at:
                self._complete(st, req, error=DeadlineExceeded(
                    "deadline passed at dispatch"), outcome="expired")
            else:
                ready.append(req)
        if not ready:
            return
        if not st.breaker.allow():
            for req in ready:
                self._complete(st, req, error=CircuitOpen(
                    "circuit breaker open for model %r after repeated "
                    "executor faults" % st.cfg.name), outcome="shed")
            return
        for req in ready:
            req.dispatch_at = dispatch_at
        try:
            rows = self._run_with_retry(st, np.stack([r.data for r in ready]))
        except Exception as e:
            if len(ready) > 1:
                self._dispatch_singly(st, ready, cause=e)
            else:
                st.breaker.record_failure()
                self._complete(st, ready[0], error=self._fault(e),
                               outcome="error")
            return
        st.breaker.record_success()
        with st.lock:
            st.batches += 1
        for i, req in enumerate(ready):
            self._complete(st, req, value=rows[i], outcome="ok")

    def _dispatch_singly(self, st: _ModelState, ready: List[_Request],
                         cause: BaseException) -> None:
        """Isolation: re-dispatch a failed batch one request at a time, so
        the fault stays with the poison request(s)."""
        logger.warning("batch of %d failed for model %r (%r): isolating "
                       "per-request", len(ready), st.cfg.name, cause)
        any_ok = False
        for req in ready:
            t = _now()
            if req.deadline is not None and req.deadline <= t:
                self._complete(st, req, error=DeadlineExceeded(
                    "deadline passed during fault isolation"),
                    outcome="expired")
                continue
            with st.lock:
                st.singles += 1
            req.dispatch_at = t
            try:
                rows = self._run_with_retry(st, req.data[None])
            except Exception as e:
                self._complete(st, req, error=self._fault(e),
                               outcome="error")
            else:
                any_ok = True
                self._complete(st, req, value=rows[0], outcome="ok")
        # one isolated success means the executor is healthy: a persistent
        # poison client must not open the breaker for the whole model
        if any_ok:
            st.breaker.record_success()
        else:
            st.breaker.record_failure()

    def _run_with_retry(self, st: _ModelState, arr: np.ndarray) -> np.ndarray:
        from ..resilience.retry import retry_transient

        def on_retry(i, exc, delay):
            with st.lock:
                st.retries += 1
            logger.warning("model %r: transient executor fault "
                           "(attempt %d), retrying in %.3fs: %r",
                           st.cfg.name, i + 1, delay, exc)

        def gate(exc):
            return st.budget is None or st.budget.try_spend("retry")

        return retry_transient(lambda: st.cache.run(arr),
                               attempts=st.cfg.retries + 1,
                               base_delay=0.01, max_delay=0.5,
                               on_retry=on_retry, gate=gate)

    @staticmethod
    def _fault(e: BaseException) -> MXNetError:
        if isinstance(e, ServingError):
            return e
        return ExecutorFault("executor failed: %r" % (e,))

    # ---------------------------------------------------------- accounting
    def _complete(self, st: _ModelState, req: _Request, value=None,
                  error=None, outcome="ok") -> bool:
        """Claim the request's result, account it, then wake its waiter,
        so a client that saw ``result()`` can trust the counters."""
        if not req.pending._claim(value=value, error=error, outcome=outcome):
            return False
        try:
            done_at = _now()
            with st.lock:
                if outcome == "ok" and req.deadline is not None \
                        and req.dispatch_at is not None \
                        and req.dispatch_at > req.deadline:
                    st.deadline_violations += 1    # must stay zero
                if outcome == "ok":
                    st.latencies.append((done_at - req.submitted_at) * 1e3)
                    if len(st.latencies) > _LAT_RING:
                        del st.latencies[:len(st.latencies) - _LAT_RING]
        finally:
            self._count(st, outcome)
            req.pending._ev.set()
        return True

    @staticmethod
    def _count(st: _ModelState, outcome: str) -> None:
        with st.lock:
            st.counts[outcome] = st.counts.get(outcome, 0) + 1

    # ------------------------------------------------------------- surface
    def stats(self, model: str) -> Dict[str, Any]:
        st = self._models[model]
        with st.lock:
            lat = np.asarray(st.latencies, np.float64)
            out = {
                "model": model,
                "counts": dict(st.counts),
                "batches": st.batches,
                "singles": st.singles,
                "retries": st.retries,
                "deadline_violations": st.deadline_violations,
                "queue_depth": st.queue.depth,
                "breaker": st.breaker.snapshot(),
                "buckets": list(st.cache.buckets),
                "buckets_compiled": st.cache.compiled_buckets(),
                "bucket_provenance": st.cfg.bucket_provenance,
            }
        if st.budget is not None:
            out["retry_budget"] = st.budget.stats()
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50))
            out["p99_ms"] = float(np.percentile(lat, 99))
            out["mean_ms"] = float(lat.mean())
        return out

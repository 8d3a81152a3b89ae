"""Typed rejection surface of the model server.

Counterpart of ``mxnet_tpu/serving/errors.py``: every way the server
refuses or fails a request is a distinct
:class:`~mxnet_tpu_torch.base.MXNetError` subclass, so clients can tell
shed load from expired work from a broken executor without parsing
messages.

================  ====================================================
error             meaning / right client reaction
================  ====================================================
Overloaded        the model's bounded queue is full: back off (429)
DeadlineExceeded  the deadline passed before dispatch; the request never
                  reached the device (504)
Draining          the server finishes accepted work and takes no new
                  work: retry elsewhere (503)
CircuitOpen       repeated executor faults opened the model's breaker;
                  the server fails fast (503)
ExecutorFault     the executor failed this request after retries and
                  request-by-request isolation (500)
================  ====================================================
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded", "Draining",
           "CircuitOpen", "ExecutorFault"]


class ServingError(MXNetError):
    """Base of every typed serving rejection/failure."""


class Overloaded(ServingError):
    """The model's bounded request queue is full (admission control)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before dispatch; it never reached
    the device."""


class Draining(ServingError):
    """The server is draining: in-flight batches finish, new work is
    rejected."""


class CircuitOpen(ServingError):
    """The per-model circuit breaker is open after repeated executor
    faults."""


class ExecutorFault(ServingError):
    """The executor failed this request after transient retries and
    single-request isolation."""

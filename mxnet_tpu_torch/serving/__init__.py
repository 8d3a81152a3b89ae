"""Inference serving of the PyTorch port: the batching :class:`ModelServer`
with admission control, deadlines, retries, isolation, a circuit breaker
and drain (counterpart of ``mxnet_tpu/serving``)."""
from .errors import (CircuitOpen, DeadlineExceeded, Draining, ExecutorFault,
                     Overloaded, ServingError)
from .breaker import CircuitBreaker
from .queueing import BoundedRequestQueue, RetryBudget
from .executors import BucketExecutorCache, default_buckets
from .server import ModelConfig, ModelServer, PendingResult
from . import load

__all__ = ["ModelConfig", "ModelServer", "PendingResult",
           "BucketExecutorCache", "default_buckets", "CircuitBreaker",
           "BoundedRequestQueue", "RetryBudget", "ServingError",
           "Overloaded", "DeadlineExceeded", "Draining", "CircuitOpen",
           "ExecutorFault", "load"]

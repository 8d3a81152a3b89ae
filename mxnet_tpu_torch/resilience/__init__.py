"""Resilience layer of the PyTorch port: the retry policy the serving
dispatch uses, and the fused trainer's dynamic loss scaler
(:mod:`.recovery`)."""
from .retry import retry_transient, is_transient, backoff_delay  # noqa: F401
from . import recovery  # noqa: F401

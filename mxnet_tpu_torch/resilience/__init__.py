"""Resilience layer of the PyTorch port: in this slice, the retry policy the
serving dispatch uses."""
from .retry import retry_transient, is_transient, backoff_delay  # noqa: F401

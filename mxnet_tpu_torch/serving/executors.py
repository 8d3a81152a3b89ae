"""Bucketed executor cache — "bind few executors, route many requests".

Counterpart of ``BucketExecutorCache`` and ``default_buckets`` in
``mxnet_tpu/serving/executors.py`` (the environment and static ladder; the
tuner warm-start branch and the memory-ledger row wait for their layers).
A model owns a small ladder of padded batch buckets; each bucket binds one
:class:`~mxnet_tpu_torch.native.predict_bridge.Predictor` with fixed
shapes, built lazily and kept for the life of the server. A batch of ``n``
rows is padded to the smallest bucket ``>= n``. Every predictor after the
first shares the parameters via ``Predictor.reshape``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env, register_config

__all__ = ["BucketExecutorCache", "default_buckets"]

register_config("MXNET_SERVE_BUCKETS", "", str,
                "Comma list of padded-batch bucket sizes for the serving "
                "executor cache (e.g. '1,4,16,64'). Empty = 1,2,4,8,16,32.")

_FALLBACK_BUCKETS = (1, 2, 4, 8, 16, 32)


def default_buckets() -> Tuple[Tuple[int, ...], str]:
    """The bucket ladder to serve with, plus its provenance:
    ``MXNET_SERVE_BUCKETS`` ("env"), else the static ladder ("default")."""
    env = str(get_env("MXNET_SERVE_BUCKETS", "") or "").strip()
    if not env:
        return _FALLBACK_BUCKETS, "default"
    try:
        buckets = tuple(sorted({int(t) for t in env.split(",")
                                if t.strip()}))
    except ValueError as e:
        raise MXNetError("MXNET_SERVE_BUCKETS: bad bucket list %r (%s)"
                         % (env, e))
    if not buckets or any(b < 1 for b in buckets):
        raise MXNetError("MXNET_SERVE_BUCKETS: buckets must be positive "
                         "ints, got %r" % (env,))
    return buckets, "env"


class BucketExecutorCache:
    """bucket batch size -> bound Predictor, built lazily, params shared.
    The server drives each model from one worker thread, so dispatches
    never contend on a predictor."""

    def __init__(self, symbol_json: str, param_bytes=b"", *,
                 input_name: str = "data", feature_shape: Sequence[int],
                 buckets: Sequence[int], dev_type: int = 2, dev_id: int = 0,
                 output_keys: Optional[List[str]] = None):
        if not buckets:
            raise MXNetError("BucketExecutorCache needs at least one bucket")
        self.input_name = str(input_name)
        self.feature_shape = tuple(int(x) for x in feature_shape)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise MXNetError("bucket sizes must be >= 1, got %r"
                             % (self.buckets,))
        self._symbol_json = symbol_json
        self._param_bytes = param_bytes
        self._dev = (int(dev_type), int(dev_id))
        self._output_keys = output_keys
        self._lock = threading.Lock()
        self._preds: Dict[int, object] = {}
        self._base = None           # first-built predictor: owns the params

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n."""
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError("batch of %d rows exceeds the largest bucket %d"
                         % (n, self.buckets[-1]))

    def get(self, bucket: int):
        """The bound predictor for one bucket, built on first use."""
        with self._lock:
            p = self._preds.get(bucket)
            if p is not None:
                return p
            if bucket not in self.buckets:
                raise MXNetError("unknown bucket %d (ladder: %r)"
                                 % (bucket, self.buckets))
            from ..native.predict_bridge import Predictor
            shape = {self.input_name: (bucket,) + self.feature_shape}
            if self._base is None:
                p = self._base = Predictor(
                    self._symbol_json, self._param_bytes, self._dev[0],
                    self._dev[1], shape, output_keys=self._output_keys)
            else:
                p = self._base.reshape(shape)
            self._preds[bucket] = p
            return p

    def warm(self, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Bind and run one dummy forward through the given buckets (all by
        default), so the first real request pays no bind or kernel build."""
        done = []
        for b in (buckets or self.buckets):
            dummy = np.zeros((int(b),) + self.feature_shape, np.float32)
            self.get(int(b)).predict({self.input_name: dummy})
            done.append(int(b))
        return done

    def compiled_buckets(self) -> List[int]:
        with self._lock:
            return sorted(self._preds)

    def run(self, batch: np.ndarray) -> np.ndarray:
        """Dispatch ``batch`` (n rows of ``feature_shape``) through the
        right bucket; returns the first output's first ``n`` rows."""
        batch = np.ascontiguousarray(batch, dtype=np.float32)
        n = int(batch.shape[0])
        b = self.bucket_for(n)
        if batch.shape[1:] != self.feature_shape:
            raise MXNetError(
                "batch feature shape %r does not match the model's %r"
                % (tuple(batch.shape[1:]), self.feature_shape))
        if b != n:
            padded = np.zeros((b,) + self.feature_shape, np.float32)
            padded[:n] = batch
            batch = padded
        outs = self.get(b).predict({self.input_name: batch})
        return np.asarray(outs[0])[:n]

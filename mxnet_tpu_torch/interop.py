"""Weights from outside the framework.

Counterpart of the weight-carrying part of ``mxnet_tpu/interop.py``: in
this slice, only :func:`params_from_numpy`. The reference's ``.params``
and graph-JSON readers and writers wait for the interop slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .ndarray.ndarray import NDArray, array

__all__ = ["params_from_numpy"]


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      ctx) -> Dict[str, NDArray]:
    """numpy arrays -> NDArrays on ``ctx``, keys unchanged: ``arg:``/
    ``aux:`` prefixes are kept, so the result can stand where a ``.params``
    file's bytes would (e.g. ``ModelConfig(param_bytes=...)``)."""
    return {str(k): array(np.asarray(v), ctx=ctx) for k, v in arrays.items()}

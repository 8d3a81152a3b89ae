"""Model loading for the server.

Counterpart of ``model_config_from_files`` in
``mxnet_tpu/serving/load.py`` (the load generator, ledger rows and the
built-in demo model wait for later slices).
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["model_config_from_files"]


def model_config_from_files(model: str, *, params: Optional[str] = None,
                            feature_shape: Optional[str] = None,
                            name: Optional[str] = None,
                            input_name: str = "data",
                            buckets: Optional[str] = None,
                            **config_kwargs):
    """A :class:`~mxnet_tpu_torch.serving.server.ModelConfig` from a
    symbol-JSON path and an optional params file. ``feature_shape`` and
    ``buckets`` are comma strings, as on the JAX package's command lines;
    other keywords pass through to ``ModelConfig``."""
    from .server import ModelConfig
    if not feature_shape:
        raise ValueError("--feature-shape is required for a model file")
    with open(model) as f:
        sym_json = f.read()
    pbytes = b""
    if params:
        with open(params, "rb") as f:
            pbytes = f.read()
    feat = tuple(int(t) for t in feature_shape.split(",") if t.strip())
    bucket_list = (tuple(int(t) for t in buckets.split(",") if t.strip())
                   if buckets else None)
    return ModelConfig(name or os.path.splitext(os.path.basename(model))[0],
                       sym_json, pbytes, feature_shape=feat,
                       input_name=input_name, buckets=bucket_list,
                       **config_kwargs)

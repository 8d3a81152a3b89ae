"""mxnet_tpu_torch — the PyTorch / CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package keeps its
module paths and public names (``mx.nd``, ``mx.sym``, the op registry, the
executor, the predictor, the serving stack, and ``mx.autograd``,
``mx.gluon``, ``mx.init``, ``mx.optimizer`` and ``mx.lr_scheduler`` for
training, ``mx.operator`` and ``mx.rtc`` for user extensions, ``mx.mod``,
``mx.io``, ``mx.metric``, ``mx.callback``, ``mx.model``,
``mx.kvstore`` and ``mx.parallel`` for symbolic and fused training, ``mx.rnn`` for the
symbolic recurrent cells, ``mx.recordio`` and ``mx.image`` for the image
data pipeline, ``mx.AttrScope`` for symbol attributes, ``mx.engine``,
``mx.registry``, ``mx.util`` and ``mx.test_utils``, ``mx.passes`` for
graph rewrites, ``mx.quant`` and ``mx.contrib.quantization`` for int8,
``mx.monitor``, ``mx.viz`` and ``mx.checkpoint``)
over plain
PyTorch: tensors on an explicit ``torch.device``, explicit
``torch.Generator``s, eager execution, torch autograd as the tape. Each
TPU (Pallas) kernel on a ported path is a hand-written Hopper kernel in
:mod:`mxnet_tpu_torch.ops.hopper_kernels`; the user-kernel escape hatch
(``mxnet_tpu/rtc.py``) is :mod:`mxnet_tpu_torch.rtc`, CUDA source compiled
by NVRTC.

Entry points run on the card (``gpu(0)``) unless the caller asks for the
CPU (``mx.cpu()``, ``dev_type=1``); asking for the card without CUDA
raises. This package imports neither ``jax`` nor ``mxnet_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from . import base
from .base import MXNetError
from .context import (Context, cpu, gpu, tpu, cpu_pinned, current_context,
                      num_gpus, num_tpus, gpu_memory_info)
from . import ops
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import random
from .ndarray import NDArray
from . import name
from . import autograd
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import gluon
from . import operator
from . import rtc
from . import io
from . import metric
from . import callback
from . import model
from . import kvstore
from . import kvstore as kv
from . import module
from . import module as mod
from . import parallel
from . import rnn
from . import attribute
from .attribute import AttrScope
from . import recordio
from . import image

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "cpu_pinned",
           "current_context", "num_gpus", "num_tpus", "gpu_memory_info", "nd",
           "ndarray", "sym", "symbol", "random", "NDArray", "ops", "base",
           "name", "autograd", "initializer", "init", "lr_scheduler", "optimizer",
           "gluon", "operator", "rtc", "io", "metric", "callback", "model", "kvstore",
           "module", "mod", "parallel", "rnn", "attribute", "AttrScope",
           "recordio", "image", "kv", "serving", "interop", "engine",
           "registry", "util", "test_utils", "contrib", "passes", "quant",
           "monitor", "visualization", "viz", "checkpoint"]


_LAZY = {"serving": "serving", "interop": "interop", "engine": "engine",
         "registry": "registry", "util": "util", "test_utils": "test_utils",
         "contrib": "contrib", "passes": "passes", "quant": "quant",
         "monitor": "monitor", "visualization": "visualization",
         "viz": "visualization", "checkpoint": "checkpoint"}


def __getattr__(name):
    """``mx.serving``, ``mx.interop``, ``mx.engine``, ``mx.registry``,
    ``mx.util``, ``mx.test_utils``, ``mx.contrib``, ``mx.passes``,
    ``mx.quant``, ``mx.monitor``, ``mx.visualization`` (``mx.viz``) and
    ``mx.checkpoint`` import on first use, as in the JAX package."""
    if name in _LAZY:
        import importlib
        mod = importlib.import_module("." + _LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch' has no attribute "
                         f"{name!r}")

"""mxnet_tpu_torch — the PyTorch / CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package keeps its
module paths and public names (``mx.nd``, ``mx.sym``, the op registry, the
executor, the predictor, the serving stack, and ``mx.autograd``,
``mx.gluon``, ``mx.init``, ``mx.optimizer`` and ``mx.lr_scheduler`` for
training, ``mx.operator`` and ``mx.rtc`` for user extensions, ``mx.mod``,
``mx.io``, ``mx.metric``, ``mx.callback``, ``mx.model`` and
``mx.parallel`` for symbolic and fused training, ``mx.rnn`` for the
symbolic recurrent cells, ``mx.recordio`` and ``mx.image`` for the image
data pipeline, ``mx.AttrScope`` for symbol attributes) over plain
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
from .context import Context, cpu, gpu, current_context
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
from . import module
from . import module as mod
from . import parallel
from . import rnn
from . import attribute
from .attribute import AttrScope
from . import recordio
from . import image

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context", "nd",
           "ndarray", "sym", "symbol", "random", "NDArray", "ops", "base",
           "name", "autograd", "initializer", "init", "lr_scheduler", "optimizer",
           "gluon", "operator", "rtc", "io", "metric", "callback", "model",
           "module", "mod", "parallel", "rnn", "attribute", "AttrScope",
           "recordio", "image"]

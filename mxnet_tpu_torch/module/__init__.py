"""``mx.mod`` — the Module API (counterpart of ``mxnet_tpu/module``;
reference ``python/mxnet/module``)."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module
from .sequential_module import PythonModule, SequentialModule

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module",
           "PythonModule", "SequentialModule"]

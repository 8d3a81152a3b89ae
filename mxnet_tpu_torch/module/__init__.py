"""``mx.mod`` — the Module API (counterpart of ``mxnet_tpu/module``;
reference ``python/mxnet/module``). ``BucketingModule`` and
``SequentialModule`` wait for a later slice (ROADMAP A1)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]

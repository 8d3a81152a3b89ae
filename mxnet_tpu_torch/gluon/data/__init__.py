"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``; reference
``python/mxnet/gluon/data``): datasets, samplers, ``DataLoader`` and the
vision datasets and transforms."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from . import vision  # noqa: F401

"""``mx.io`` — data iterators (counterpart of ``mxnet_tpu/io``): what the
Module API needs and the record iterators; the CSV, MNIST and LibSVM
iterators, ``ResizeIter``, ``PrefetchingIter`` and the device feed wait
for a later slice (ROADMAP A7)."""
from .io import (DataBatch, DataDesc, DataIter, ImageDetRecordIter,
                 ImageRecordIter, NDArrayIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ImageRecordIter", "ImageDetRecordIter"]

"""``mx.io`` — data iterators (counterpart of ``mxnet_tpu/io``): the
in-memory, CSV, MNIST, LibSVM and record iterators, ``ResizeIter`` and
``PrefetchingIter`` with the state protocol, and the device feed
(``DeviceFeedIter``, ``prefetch_to_device``). ``ResilientDataIter``
waits for the operational layers (ROADMAP A9)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageDetRecordIter,
                 ImageRecordIter, LibSVMIter, MNISTIter, NDArrayIter,
                 PrefetchingIter, ResizeIter, has_state)
from .device_feed import DeviceFeedIter, prefetch_to_device

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "ImageRecordIter",
           "ImageDetRecordIter", "MNISTIter", "LibSVMIter", "DeviceFeedIter",
           "prefetch_to_device", "has_state"]

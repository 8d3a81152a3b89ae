"""``mx.io`` — data iterators (counterpart of ``mxnet_tpu/io``): what the
Module API needs; the record, image and CSV iterators and the device feed
wait for a later slice (ROADMAP A7)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]

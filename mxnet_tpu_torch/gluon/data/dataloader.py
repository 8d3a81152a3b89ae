"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
reference ``python/mxnet/gluon/data/dataloader.py``).

Batches are host arrays (``cpu()``), as in the reference; with
``pin_memory=True`` they are page-locked (``torch.Tensor.pin_memory``), so
that a copy to the card can run asynchronously, which needs CUDA.
``num_workers > 0`` loads batches on a thread pool, as the JAX package
does (decoding in numpy and Pillow releases the GIL), ``prefetch``
batches ahead.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...base import MXNetError
from ...context import cpu
from ...ndarray import NDArray, array, stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference
    dataloader.py:default_batchify_fn): NDArrays stacked on their device,
    tuples field by field, anything else through numpy (float64 as
    float32) into a host array."""
    if isinstance(data[0], NDArray):
        return stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(d)) for d in zip(*data))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return array(arr, ctx=cpu())


def _pinned(batch):
    if isinstance(batch, NDArray):
        return NDArray(batch._data.pin_memory())
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pinned(b) for b in batch)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size is required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        if pin_memory and not torch.cuda.is_available():
            raise MXNetError("DataLoader(pin_memory=True) asks for page-locked"
                             " host memory, which needs CUDA; it is not "
                             "available")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = bool(pin_memory)
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pinned(batch) if self._pin_memory else batch

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return

        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = []
            it = iter(self._batch_sampler)
            depth = self._prefetch or (2 * self._num_workers)
            try:
                for _ in range(depth):
                    futures.append(pool.submit(self._load_batch, next(it)))
            except StopIteration:
                pass
            while futures:
                batch = futures.pop(0).result()
                try:
                    futures.append(pool.submit(self._load_batch, next(it)))
                except StopIteration:
                    pass
                yield batch

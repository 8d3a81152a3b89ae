"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``; reference
``python/mxnet/gluon/data/dataset.py``). Arrays a dataset makes live on
the host (``cpu()``), as the reference's do."""
from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from ...base import MXNetError
from ...context import cpu
from ...ndarray import array

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "_DownloadedDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        def first(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(first, lazy)

    def filter(self, fn: Callable) -> "Dataset":
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count: int) -> "Dataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset: Dataset, fn: Callable):
        self._dataset = dataset
        self._fn = fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/lists (reference dataset.py:ArrayDataset);
    a numpy array becomes a host NDArray."""

    def __init__(self, *args):
        assert args, "needs at least 1 array"
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
            if isinstance(a, np.ndarray):
                a = array(a, ctx=cpu())
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file: item ``i`` is the raw bytes of its
    ``i``-th record (reference dataset.py:RecordFileDataset)."""

    def __init__(self, filename: str):
        from ...recordio import MXIndexedRecordIO
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])


class _DownloadedDataset(Dataset):
    """Base for vision datasets stored locally: files in the reference's
    formats under ``root``, else synthetic data where the subclass allows
    it. Nothing is downloaded, and ``root`` is only read."""

    def __init__(self, root, transform):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError

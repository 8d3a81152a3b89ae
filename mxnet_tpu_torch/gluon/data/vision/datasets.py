"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; reference
``python/mxnet/gluon/data/vision/datasets.py``).

Nothing is downloaded: a dataset loads local files in the reference's
formats (MNIST idx, CIFAR binary) under ``root`` when they are there, and
otherwise makes deterministic synthetic data from a fixed seed, as the JAX
package does (``synthetic=False`` raises instead). Images are uint8 host
arrays (``cpu()``), labels int32 numpy arrays.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....context import cpu
from ....ndarray import array
from ..dataset import _DownloadedDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"]


def _synthetic(num, shape, num_classes, seed):
    rs = np.random.RandomState(seed)
    data = (rs.rand(num, *shape) * 255).astype(np.uint8)
    label = rs.randint(0, num_classes, size=(num,)).astype(np.int32)
    return data, label


class MNIST(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None,
                 synthetic=None, synthetic_size=4096):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _get_data(self):
        prefix = "train" if self._train else "t10k"
        img = os.path.join(self._root, f"{prefix}-images-idx3-ubyte")
        lbl = os.path.join(self._root, f"{prefix}-labels-idx1-ubyte")
        found = False
        for opener, suffix in ((open, ""), (gzip.open, ".gz")):
            if os.path.exists(img + suffix) and os.path.exists(lbl + suffix):
                with opener(lbl + suffix, "rb") as f:
                    struct.unpack(">II", f.read(8))
                    label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
                with opener(img + suffix, "rb") as f:
                    _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                    data = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                        num, rows, cols, 1)
                found = True
                break
        if not found:
            if self._synthetic is False:
                raise FileNotFoundError(
                    f"MNIST files not found under {self._root} and synthetic "
                    f"fallback disabled")
            data, label = _synthetic(self._synthetic_size, (28, 28, 1), 10,
                                     42 if self._train else 43)
        self._data = array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, **kw):
        super().__init__(root, train, transform, **kw)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None,
                 synthetic=None, synthetic_size=4096):
        self._train = train
        self._synthetic = synthetic
        self._synthetic_size = synthetic_size
        self._num_classes = 10
        super().__init__(root, transform)

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}.bin" for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        files = [os.path.join(self._root, f) for f in self._file_list()]
        if all(os.path.exists(f) for f in files):
            data_list, label_list = [], []
            row = 3073 if self._num_classes == 10 else 3074
            for fname in files:
                raw = np.fromfile(fname, dtype=np.uint8).reshape(-1, row)
                label_list.append(raw[:, row - 3073].astype(np.int32))
                data_list.append(raw[:, row - 3072:].reshape(-1, 3, 32, 32)
                                 .transpose(0, 2, 3, 1))
            data = np.concatenate(data_list)
            label = np.concatenate(label_list)
        else:
            if self._synthetic is False:
                raise FileNotFoundError(f"CIFAR files not found under {self._root}")
            data, label = _synthetic(self._synthetic_size, (32, 32, 3),
                                     self._num_classes,
                                     44 if self._train else 45)
        self._data = array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None, **kw):
        self._fine = fine_label
        super().__init__(root, train, transform, **kw)
        self._num_classes = 100

    def _file_list(self):
        return ["train.bin"] if self._train else ["test.bin"]

"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``MNISTIter``, ``LibSVMIter``, ``ImageRecordIter`` and
``ImageDetRecordIter``, with the
state protocol (``has_state``; ``state()``/``set_state()``: epoch, cursor
and shuffle seed, so that a resumed epoch neither skips nor repeats a
batch).

Counterpart of the same names in ``mxnet_tpu/io/io.py`` (reference
``python/mxnet/io/io.py`` and ``src/io/iter_image_recordio_2.cc``,
``iter_image_det_recordio.cc``, ``iter_csv.cc``, ``iter_mnist.cc``,
``iter_libsvm.cc``). ``LibSVMIter`` gives ``CSRNDArray`` batches on its
``ctx``. ``NDArrayIter``'s batches are NDArrays
on the host (``cpu()``), as the reference's iterators give them;
``Module.forward`` copies them onto its card. The record iterators decode
on host threads and copy each batch to their ``ctx`` (the card by
default). ``NDArrayIter`` keeps its data as numpy arrays and, with
``shuffle``, permutes it with a numpy ``RandomState`` seeded once from the
framework's host stream (``mx.random.seed`` pins it), as the JAX package
does.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from collections import namedtuple
from typing import Dict

import numpy as np

from .. import random as _random
from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "LibSVMIter",
           "ImageRecordIter", "ImageDetRecordIter", "has_state"]


def has_state(it) -> bool:
    """Whether ``it`` has the state protocol: ``state() -> dict`` and
    ``set_state(dict)``."""
    return callable(getattr(it, "state", None)) \
        and callable(getattr(it, "set_state", None))


def _put_or_stop(q, item, stop) -> bool:
    """``q.put(item)`` that gives up once ``stop`` is set, so that a
    producer never stays blocked on a queue nobody reads. False if it
    gave up."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _join_producer(thread, q, stop, what: str, deadline_s: float = 60.0):
    """Stop a producer thread and join it, draining ``q`` meanwhile so that
    a blocked put sees ``stop``; raise if it has not exited by the
    deadline. Whatever it staged is dropped."""
    stop.set()
    deadline = time.monotonic() + deadline_s
    while thread is not None and thread.is_alive():
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=0.1)
        if time.monotonic() > deadline:
            raise MXNetError(f"{what}: producer thread failed to stop "
                             f"(base iterator blocked in next()?)")
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """A named input shape, with its dtype and layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One batch: lists of data and label arrays, and how many of its
    samples are padding."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference ``io.py:DataIter``)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    def close(self):
        """Release what the iterator holds (threads, staged batches);
        nothing here. A closed iterator is not iterated again."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _init_data(data, allow_empty, default_name):
    """[(name, numpy array)] from an array, a list or a dict of them."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("data cannot be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("data must be NDArray, numpy array, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """In-memory iterator with ``pad``/``discard``/``roll_over`` handling
    of the last batch (reference ``io.py:NDArrayIter``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"last_batch_handle must be pad, discard or "
                             f"roll_over, got {last_batch_handle!r}")
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        # the order is a function of (seed, epoch), so the state is O(1)
        self._shuffle_seed = (int(_random.host_rng().randint(0, 2 ** 31 - 1))
                              if shuffle else None)
        self._shuffle_rng = (np.random.RandomState(self._shuffle_seed)
                             if shuffle else None)
        self._epoch = -1
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.label]

    def reset(self):
        self._epoch += 1
        if self.shuffle:
            self._shuffle_rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def state(self) -> Dict:
        """Epoch count, cursor and shuffle seed; :meth:`set_state` replays
        the shuffles."""
        return {"iter": "NDArrayIter", "epoch": self._epoch,
                "cursor": int(self.cursor), "num_data": int(self.num_data),
                "shuffle_seed": self._shuffle_seed}

    def set_state(self, state: Dict) -> None:
        if int(state["num_data"]) != self.num_data:
            raise MXNetError(
                f"NDArrayIter.set_state: checkpointed iterator had "
                f"{int(state['num_data'])} samples, this one has "
                f"{self.num_data}: not the same dataset")
        if bool(self.shuffle) != (state.get("shuffle_seed") is not None):
            raise MXNetError(
                f"NDArrayIter.set_state: checkpoint was written with "
                f"shuffle={state.get('shuffle_seed') is not None} but this "
                f"iterator has shuffle={self.shuffle}")
        epoch = int(state["epoch"])
        self.idx = np.arange(self.num_data)
        if self.shuffle:
            self._shuffle_seed = int(state["shuffle_seed"])
            self._shuffle_rng = np.random.RandomState(self._shuffle_seed)
            for _ in range(epoch + 1):
                self._shuffle_rng.shuffle(self.idx)
        self._epoch = epoch
        self.cursor = int(state["cursor"])

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        take = self.idx[max(self.cursor, 0):self.cursor + self.batch_size]
        if len(take) < self.batch_size and self.last_batch_handle == "pad":
            take = np.concatenate([take,
                                   self.idx[:self.batch_size - len(take)]])
        return [array(v[take], ctx=cpu()) for _, v in arrays]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """A fixed number of batches an epoch from another iterator, which is
    reset when it runs out (reference ``io.py:ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        for attr in ("provide_data", "provide_label", "default_bucket_key"):
            if hasattr(data_iter, attr):
                setattr(self, attr, getattr(data_iter, attr))

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def state(self) -> Dict:
        if not has_state(self.data_iter):
            raise MXNetError(f"ResizeIter.state: base iterator "
                             f"{type(self.data_iter).__name__} has no state "
                             f"protocol")
        return {"iter": "ResizeIter", "cur": int(self.cur),
                "base": self.data_iter.state()}

    def set_state(self, state: Dict) -> None:
        self.cur = int(state["cur"])
        self.data_iter.set_state(state["base"])
        self.current_batch = None

    def close(self):
        self.data_iter.close()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Batches of one or more iterators, read ahead by a thread
    (reference ``io.py:PrefetchingIter``). The state is the base
    iterators' state after the last batch delivered: batches read ahead
    and not delivered are read again after ``set_state``. A producer's
    error is raised by every ``next()`` until ``reset()``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._track_state = all(has_state(it) for it in iters)
        self._last_states = ([it.state() for it in iters]
                             if self._track_state else None)
        self._closed = False
        self._terminal = None     # StopIteration or the producer's error
        # the producer reads under the caller's context (its own Context:
        # entering one records the thread's previous context on it)
        ctx = current_context()
        self._ctx = type(ctx)(ctx.device_type, ctx.device_id)
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    def _descs(self, attr, rename):
        return [DataDesc(rename[i][d.name] if rename else d.name, d.shape,
                         d.dtype)
                for i, it in enumerate(self.iters)
                for d in getattr(it, attr)]

    @property
    def provide_data(self):
        return self._descs("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._descs("provide_label", self.rename_label)

    def _producer(self, q, stop):
        # q and stop are arguments: a thread from before a reset() never
        # touches the new queue
        with self._ctx:
            self._produce(q, stop)

    def _produce(self, q, stop):
        try:
            while not stop.is_set():
                try:
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    _put_or_stop(q, None, stop)
                    return
                states = ([it.state() for it in self.iters]
                          if self._track_state else None)
                if not _put_or_stop(q, (batches, states), stop):
                    return
        except Exception as e:          # raised at the consumer
            _put_or_stop(q, e, stop)

    def _start(self):
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue, self._stop),
            daemon=True, name="mxtorch-prefetch-iter")
        self._thread.start()

    def _stop_producer(self):
        _join_producer(self._thread, self._queue, self._stop,
                       "PrefetchingIter")
        self._thread = None
        self._terminal = None
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=4)

    def reset(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        self._stop_producer()
        for it in self.iters:
            it.reset()
        if self._track_state:
            self._last_states = [it.state() for it in self.iters]
        self._start()

    def state(self) -> Dict:
        if not self._track_state:
            raise MXNetError(
                "PrefetchingIter.state: base iterator(s) without the state "
                "protocol: %s" % [type(it).__name__ for it in self.iters
                                  if not has_state(it)])
        return {"iter": "PrefetchingIter",
                "base": [dict(s) for s in self._last_states]}

    def set_state(self, state: Dict) -> None:
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        if not self._track_state:
            raise MXNetError("PrefetchingIter.set_state: base iterator(s) "
                             "without the state protocol")
        if len(state["base"]) != len(self.iters):
            raise MXNetError(
                f"PrefetchingIter.set_state: checkpoint carries "
                f"{len(state['base'])} base state(s) but this iterator "
                f"composes {len(self.iters)}")
        self._stop_producer()
        for it, s in zip(self.iters, state["base"]):
            it.set_state(s)
        self._last_states = [dict(s) for s in state["base"]]
        self._start()

    def close(self):
        """Stop the producer, drop what it read ahead and close the base
        iterators."""
        if self._closed:
            return
        self._closed = True
        self._stop_producer()
        for it in self.iters:
            it.close()

    def next(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        if self._terminal is not None:
            raise self._terminal
        item = self._queue.get()
        if item is None:
            self._terminal = StopIteration
            raise StopIteration
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        batches, states = item
        if states is not None:
            self._last_states = states
        return DataBatch(data=[d for b in batches for d in b.data],
                         label=[l for b in batches for l in (b.label or [])],
                         pad=batches[0].pad, index=batches[0].index)

    def iter_next(self):
        raise MXNetError("use next() on PrefetchingIter")


class _Delegating(DataIter):
    """An iterator over an inner ``NDArrayIter`` (CSV and MNIST)."""

    def _wrap(self, inner):
        self._inner = inner
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label

    def reset(self):
        self._inner.reset()

    def state(self) -> Dict:
        return {"iter": type(self).__name__, "base": self._inner.state()}

    def set_state(self, state: Dict) -> None:
        self._inner.set_state(state["base"])

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class CSVIter(_Delegating):
    """Rows of a CSV file as data (and of another as labels) (reference
    ``src/io/iter_csv.cc``); ``round_batch`` pads the last batch, else it
    is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        self._wrap(NDArrayIter(data, label, batch_size,
                               last_batch_handle="pad" if round_batch
                               else "discard"))


def _read_idx(path, is_image):
    """An MNIST idx file (gzip where the name ends in ``.gz``): images as
    (N, 1, rows, cols) float32 in [0, 1], labels as float32."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        if is_image:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            arr = np.frombuffer(f.read(), dtype=np.uint8)
            return arr.reshape(num, 1, rows, cols).astype("float32") / 255.0
        struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype("float32")


class MNISTIter(_Delegating):
    """MNIST's idx files (reference ``src/io/iter_mnist.cc``): images
    scaled to [0, 1], (N, 1, 28, 28) or ``flat`` (N, 784); the last short
    batch dropped. ``seed`` is accepted and ignored, as in the JAX
    package: the shuffle draws its seed from the host stream."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=None, **kwargs):
        super().__init__(batch_size)
        data = _read_idx(image, True)
        if flat:
            data = data.reshape(data.shape[0], -1)
        self._wrap(NDArrayIter(data, _read_idx(label, False), batch_size,
                               shuffle=shuffle, last_batch_handle="discard"))


def _read_libsvm(path):
    """A LibSVM text file, ``label idx:val idx:val ...`` a line (blank
    lines skipped): (labels, indptr, raw indices, values)."""
    labels, indptr, indices, values = [], [0], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                i, v = tok.split(":")
                indices.append(int(i))
                values.append(float(v))
            indptr.append(len(indices))
    return (np.asarray(labels, "float32"), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int64), np.asarray(values, "float32"))


class LibSVMIter(DataIter):
    """A LibSVM text file as ``CSRNDArray`` batches (reference
    ``src/io/iter_libsvm.cc``), data and labels on ``ctx`` (the current
    context by default).

    ``indexing_mode``: 0 (features numbered 0..ncol-1), 1 (the canonical
    1..ncol numbering), or ``"auto"``: 1-based iff the largest index is at
    least ncol, so a 1-based file that never uses feature ncol reads as
    0-based, as in the JAX package (pass the mode when that matters).
    An index out of range after decoding raises. ``label_libsvm`` gives
    the labels from a file of its own (``label_shape`` values a line).
    With ``round_batch`` the last batch is padded with copies of its own
    first row, as the JAX package pads (the reference wraps to the
    file's start); without it the last batch is short."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 data_name="data", label_name="softmax_label",
                 indexing_mode="auto", ctx=None, **kwargs):
        super().__init__(batch_size)
        self.data_name, self.label_name = data_name, label_name
        self.data_shape = tuple(data_shape)
        self.ctx = ctx or current_context()
        self._ncol = ncol = int(np.prod(self.data_shape))
        self._labels, self._indptr, indices, self._values = \
            _read_libsvm(data_libsvm)
        if indexing_mode == "auto":
            indexing_mode = 1 if indices.size and indices.max() >= ncol \
                else 0
        if int(indexing_mode) == 1:
            indices = indices - 1
        if indices.size and (indices.min() < 0 or indices.max() >= ncol):
            raise MXNetError(
                f"libsvm feature index out of range for data_shape "
                f"{self.data_shape} with indexing_mode={indexing_mode}: "
                f"[{indices.min()}, {indices.max()}]")
        self._indices = indices
        if label_libsvm is not None:
            with open(label_libsvm) as f:
                ext = [[float(t) for t in line.split()[
                    :1 if tuple(label_shape) == (1,) else None]]
                    for line in f if line.split()]
            self._labels = np.asarray(ext, "float32").reshape(
                (-1,) + tuple(label_shape))
            if self._labels.shape[-1] == 1:
                self._labels = self._labels.reshape(self._labels.shape[:-1])
        self._nrows = len(self._indptr) - 1
        self._round = round_batch
        self._pos = 0

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self._labels.shape[1:])]

    def reset(self):
        self._pos = 0

    def state(self) -> Dict:
        return {"iter": "LibSVMIter", "pos": int(self._pos),
                "nrows": int(self._nrows)}

    def set_state(self, state: Dict) -> None:
        if int(state["nrows"]) != self._nrows:
            raise MXNetError("LibSVMIter.set_state: row count mismatch")
        self._pos = int(state["pos"])

    def next(self) -> DataBatch:
        from ..ndarray import sparse as sp
        if self._pos >= self._nrows:
            raise StopIteration
        end = min(self._pos + self.batch_size, self._nrows)
        rows = np.arange(self._pos, end)
        pad = self.batch_size - len(rows)
        if pad and self._round:
            rows = np.concatenate([rows, np.full(pad, self._pos)])
        else:
            pad = 0
        starts = self._indptr[rows]
        counts = self._indptr[rows + 1] - starts
        ptr = np.concatenate([[0], np.cumsum(counts)])
        take = np.repeat(starts - ptr[:-1], counts) + np.arange(ptr[-1])
        self._pos = end
        data = sp.csr_matrix(
            (self._values[take], self._indices[take], ptr),
            shape=(len(rows), self._ncol), ctx=self.ctx)
        return DataBatch(data=[data],
                         label=[array(self._labels[rows], ctx=self.ctx)],
                         pad=pad)


class ImageRecordIter(DataIter):
    """RecordIO image iterator with augmentation and threaded decode
    (reference src/io/iter_image_recordio_2.cc: chunk read → JPEG decode →
    augment → batch; here a thread pool decodes with Pillow, which releases
    the GIL). Records are read through :mod:`~mxnet_tpu_torch.recordio`
    (the ``.idx`` file where there is one, else in sequence); batches are
    made on the host and copied to ``ctx`` (the current context by
    default: the card)."""

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 label_width=1, shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0, rand_crop=False,
                 rand_mirror=False, resize=-1, data_name="data",
                 label_name="softmax_label", preprocess_threads=4,
                 round_batch=True, seed=None, ctx=None, **kwargs):
        super().__init__(batch_size)
        from .. import recordio as rio
        self._rio = rio
        self.ctx = ctx or current_context()
        self.path_imgrec = path_imgrec
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.isfile(idx_path):
            self._rec = rio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            self._keys = None
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.scale = scale
        self.mean = np.array([mean_r, mean_g, mean_b], dtype="float32")
        self.std = np.array([std_r, std_g, std_b], dtype="float32")
        self._threads = max(1, preprocess_threads)
        self.data_name = data_name
        self.label_name = label_name
        self._order = None
        self._pos = 0
        # private shuffle RNG (see NDArrayIter): the record ORDER is a pure
        # function of (seed, epoch); state() is record-offset based. The
        # already-accepted ``seed`` kwarg (reference parity) pins it.
        self._shuffle_seed = (
            (int(seed) if seed is not None
             else int(_random.host_rng().randint(0, 2 ** 31 - 1)))
            if shuffle else None)
        self._shuffle_rng = (np.random.RandomState(self._shuffle_seed)
                             if shuffle else None)
        self._epoch = -1
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self._epoch += 1
        self._pos = 0
        if self._keys is not None:
            self._order = list(self._keys)
            if self.shuffle:
                self._shuffle_rng.shuffle(self._order)
        else:
            self._rec.reset()

    # ------------------------------------------------- checkpointable state
    def state(self) -> Dict:
        """Record-offset resume point: epoch count, position within the
        (seed, epoch)-determined record order. Augmentation randomness
        (rand_crop/rand_mirror) is deliberately NOT part of the state —
        record identity and order are exact on resume; pixel-level
        augmentation draws continue from the process RNG."""
        return {"iter": "ImageRecordIter", "epoch": self._epoch,
                "pos": int(self._pos),
                "num_records": (len(self._keys)
                                if self._keys is not None else None),
                "shuffle_seed": self._shuffle_seed}

    def set_state(self, state: Dict) -> None:
        epoch, pos = int(state["epoch"]), int(state["pos"])
        if bool(self.shuffle) != (state.get("shuffle_seed") is not None):
            raise MXNetError(
                "ImageRecordIter.set_state: checkpoint was written with "
                "shuffle=%s but this iterator has shuffle=%s"
                % (state.get("shuffle_seed") is not None, self.shuffle))
        if self._keys is not None:
            if state.get("num_records") != len(self._keys):
                raise MXNetError(
                    "ImageRecordIter.set_state: checkpointed iterator had "
                    "%s records, this one has %d — not the same recfile"
                    % (state.get("num_records"), len(self._keys)))
            if self.shuffle:
                seed = state.get("shuffle_seed")
                # each reset() shuffles a FRESH copy of keys: replaying
                # epoch+1 shuffles advances the stream to the same order
                self._shuffle_seed = int(seed)
                self._shuffle_rng = np.random.RandomState(self._shuffle_seed)
                for _ in range(epoch + 1):
                    self._order = list(self._keys)
                    self._shuffle_rng.shuffle(self._order)
            else:
                self._order = list(self._keys)
        else:
            # sequential (index-less) reader: rewind, then skip `pos`
            # records — offset-exact, O(pos) bytes re-read
            self._rec.reset()
            for _ in range(pos):
                self._rec.read()
        self._epoch = epoch
        self._pos = pos

    def _decode_one(self, raw):
        header, img = self._rio.unpack_img(raw, iscolor=1)
        Image = self._rio._pil()
        if self.resize > 0:
            h, w = img.shape[:2]
            short = min(h, w)
            ratio = self.resize / short
            img = np.asarray(Image.fromarray(img).resize(
                (int(w * ratio), int(h * ratio))))
        _, th, tw = self.data_shape
        h, w = img.shape[:2]
        if h < th or w < tw:
            img = np.asarray(Image.fromarray(img).resize((max(tw, w), max(th, h))))
            h, w = img.shape[:2]
        if self.rand_crop:
            y0 = np.random.randint(0, h - th + 1)
            x0 = np.random.randint(0, w - tw + 1)
        else:
            y0 = (h - th) // 2
            x0 = (w - tw) // 2
        img = img[y0:y0 + th, x0:x0 + tw]
        if self.rand_mirror and np.random.rand() < 0.5:
            img = img[:, ::-1]
        chw = self._normalize(img)
        label = header.label
        if isinstance(label, np.ndarray) and self.label_width == 1:
            label = float(label[0])
        return chw, label

    def _normalize(self, img):
        """HWC uint8 → normalized CHW float32 (shared by the classification
        and detection decode paths)."""
        chw = img.astype("float32").transpose(2, 0, 1)
        return (chw * self.scale - self.mean[:, None, None]) \
            / self.std[:, None, None]

    def _read_raw(self):
        if self._keys is not None:
            if self._pos >= len(self._order):
                return None
            raw = self._rec.read_idx(self._order[self._pos])
        else:
            raw = self._rec.read()
        self._pos += 1
        return raw

    def next(self) -> DataBatch:
        from concurrent.futures import ThreadPoolExecutor
        raws = []
        for _ in range(self.batch_size):
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        if not raws:
            raise StopIteration
        pad = self.batch_size - len(raws)
        if self._threads > 1 and len(raws) > 1:
            with ThreadPoolExecutor(max_workers=self._threads) as pool:
                decoded = list(pool.map(self._decode_one, raws))
        else:
            decoded = [self._decode_one(r) for r in raws]
        data = np.stack([d for d, _ in decoded])
        labels = np.asarray([l for _, l in decoded], dtype="float32")
        if pad:
            data = np.concatenate([data, np.repeat(data[:1], pad, axis=0)])
            labels = np.concatenate([labels, np.repeat(labels[:1], pad, axis=0)])
        return DataBatch(data=[array(data, ctx=self.ctx)],
                         label=[array(labels, ctx=self.ctx)], pad=pad)

    def iter_next(self):
        raise MXNetError("use next()")


class ImageDetRecordIter(ImageRecordIter):
    """Detection RecordIO iterator (reference src/io/iter_image_det_recordio.cc).

    Record label layout (the reference's detection list format,
    tools/im2rec detection lists): ``[header_width, obj_width,
    <extra header...>, obj0..., obj1...]`` where each object is
    ``obj_width`` floats starting with ``[class, xmin, ymin, xmax, ymax]``
    normalized to [0, 1]. Batches labels as (B, max_objs, 5) padded with
    -1 — exactly what _contrib_MultiBoxTarget consumes.

    The whole image is resized to data_shape (no random crop: crops would
    invalidate the normalized box coordinates).
    """

    def __init__(self, path_imgrec, data_shape, batch_size, max_objs=8,
                 **kwargs):
        self.max_objs = int(max_objs)
        kwargs.setdefault("label_name", "label")
        if kwargs.pop("rand_crop", False) or float(kwargs.pop("resize", -1)) > 0:
            raise MXNetError(
                "ImageDetRecordIter does not support rand_crop/resize: boxes "
                "are normalized to the full image, which is resized straight "
                "to data_shape")
        super().__init__(path_imgrec, data_shape, batch_size,
                         rand_crop=False, **kwargs)

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.max_objs, 5))]

    def _decode_one(self, raw):
        Image = self._rio._pil()
        header, img = self._rio.unpack_img(raw, iscolor=1)
        _, th, tw = self.data_shape
        if img.shape[:2] != (th, tw):
            img = np.asarray(Image.fromarray(img).resize((tw, th)))
        if self.rand_mirror and np.random.rand() < 0.5:
            img = img[:, ::-1]
            mirrored = True
        else:
            mirrored = False
        chw = self._normalize(img)

        lab = np.asarray(header.label, dtype="float32").ravel()
        hw = int(lab[0]) if lab.size else 2
        ow = int(lab[1]) if lab.size > 1 else 5
        objs = lab[hw:]
        n = objs.size // ow if ow else 0
        out = np.full((self.max_objs, 5), -1.0, dtype="float32")
        for i in range(min(n, self.max_objs)):
            o = objs[i * ow:(i + 1) * ow]
            cls, x1, y1, x2, y2 = o[0], o[1], o[2], o[3], o[4]
            if mirrored:
                x1, x2 = 1.0 - x2, 1.0 - x1
            out[i] = (cls, x1, y1, x2, y2)
        return chw, out

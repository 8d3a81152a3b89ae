"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ImageRecordIter`` and ``ImageDetRecordIter``.

Counterpart of the same names in ``mxnet_tpu/io/io.py`` (reference
``python/mxnet/io/io.py`` and ``src/io/iter_image_recordio_2.cc``,
``iter_image_det_recordio.cc``). ``NDArrayIter``'s batches are NDArrays
on the host (``cpu()``), as the reference's iterators give them;
``Module.forward`` copies them onto its card. The record iterators decode
on host threads and copy each batch to their ``ctx`` (the card by
default). ``NDArrayIter`` keeps its data as numpy arrays and, with
``shuffle``, permutes it with a numpy ``RandomState`` seeded once from the
framework's host stream (``mx.random.seed`` pins it), as the JAX package
does.
"""
from __future__ import annotations

import os
from collections import namedtuple
from typing import Dict

import numpy as np

from .. import random as _random
from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ImageRecordIter", "ImageDetRecordIter"]


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
        """Release what the iterator holds; nothing here."""


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
        self._shuffle_rng = (np.random.RandomState(
            int(_random.host_rng().randint(0, 2 ** 31 - 1)))
            if shuffle else None)
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
        if self.shuffle:
            self._shuffle_rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

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

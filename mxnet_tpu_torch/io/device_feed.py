"""Batches staged on the card ahead of the step: ``DeviceFeedIter`` and
``prefetch_to_device``.

Counterpart of ``mxnet_tpu/io/device_feed.py`` (the reference's
``PrefetcherIter``, ``src/io/iter_prefetcher.h``). A producer thread reads
the base iterator and stages ``depth`` batches ahead of the consumer:

* each host leaf is copied into a page-locked buffer and from there to the
  card with a ``non_blocking`` copy on a side CUDA stream, and an event is
  recorded after it. A buffer is refilled only after its last copy's
  event has completed (a ring of ``depth + 2`` buffers a leaf);
* ``next()`` makes the current stream wait on the batch's event and
  ``record_stream``s every staged tensor on it, so that the caching
  allocator does not hand a tensor's memory out again while the step on
  the current stream still reads it;
* with ``wire_dtype``, data leaves (never labels) are cast to it on the
  host before the copy and rescaled on the card (``x·scale + shift`` in
  float32, on the side stream);
* the state (``state()``/``set_state()``) is the base iterator's after
  the last batch delivered, so batches staged and not delivered are
  credited back; a producer's error is raised by every later ``next()``
  until ``reset()``.

A leaf already on the target device is passed through (cast and rescaled
there if ``wire_dtype`` asks). The producer reads the base iterator under
the context the feed was made in. On the CPU (``ctx=cpu()``) the same
thread and queue run over plain tensors. ``sharding`` (a mesh) waits for
ROADMAP A8.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, torch_dtype
from .io import DataBatch, DataIter, _join_producer, _put_or_stop, has_state

__all__ = ["prefetch_to_device", "DeviceFeedIter"]

_STOP = object()


def _no_sharding(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError("device feed sharding=: placing batches "
                                  "over a mesh waits for ROADMAP A8")


class _Stager:
    """Copies host leaves to ``device``: through page-locked buffers on a
    side stream on the card, directly on the CPU."""

    def __init__(self, device: torch.device, depth: int, wire_dtype=None,
                 scale: float = 1.0, shift: float = 0.0):
        self.device = device
        self.cuda = device.type == "cuda"
        self.wire = torch_dtype(np.dtype(wire_dtype).name) \
            if wire_dtype else None
        self.scale, self.shift = float(scale), float(shift)
        self.slots = depth + 2
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._buffers = {}            # (slot, leaf) -> page-locked tensor
        self._events = [None] * self.slots
        self._slot = 0
        self.copied_bytes = 0

    def _host(self, a) -> torch.Tensor:
        if isinstance(a, NDArray):
            return a._data
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a))

    def _leaf(self, slot, i, a, is_data) -> torch.Tensor:
        t = self._host(a)
        wire = is_data and self.wire is not None
        if wire and t.device.type == "cpu" and t.dtype != self.wire:
            t = t.to(self.wire)
        if t.device != self.device:
            self.copied_bytes += t.numel() * t.element_size()
            if self.cuda and t.device.type == "cpu":
                buf = self._buffers.get((slot, i))
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    self._buffers[(slot, i)] = buf
                buf.copy_(t)
                t = buf.to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
        if wire:
            if t.dtype != self.wire:
                t = t.to(self.wire)
            t = t.float() * self.scale + self.shift
        return t

    def stage(self, data, label):
        """Staged (data, label) tensor lists and the event to wait on."""
        slot = self._slot
        self._slot = (slot + 1) % self.slots
        if self._events[slot] is not None:
            # its page-locked buffers may still be read by an earlier copy
            self._events[slot].synchronize()
        ctx = torch.cuda.stream(self.stream) if self.cuda \
            else contextlib.nullcontext()
        with ctx:
            out_d = [self._leaf(slot, i, a, True)
                     for i, a in enumerate(data or [])]
            n = len(out_d)
            out_l = [self._leaf(slot, n + i, a, False)
                     for i, a in enumerate(label or [])]
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record(self.stream)
                self._events[slot] = event
        return out_d, out_l, event

    def deliver(self, tensors, event) -> None:
        """Make the current stream wait on the copies and keep each
        tensor's memory until the current stream is past it."""
        if event is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in tensors:
            t.record_stream(current)


def prefetch_to_device(source: Iterable, sharding=None, depth: int = 2,
                       ctx=None) -> Iterator:
    """Items of ``source`` (tuples, lists or dicts of numpy arrays,
    NDArrays or tensors) with their leaves as NDArrays on the card, staged
    ``depth`` items ahead by a thread. Closing the generator stops the
    thread."""
    _no_sharding(sharding)
    if depth < 1:
        raise MXNetError("prefetch depth must be >= 1")
    stager = _Stager((ctx or current_context()).torch_device(), depth)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def flatten(item, leaves):
        """Append ``item``'s leaves; return a function of the staged
        leaves' iterator that rebuilds ``item``'s structure."""
        if isinstance(item, dict):
            parts = {k: flatten(v, leaves) for k, v in item.items()}
            return lambda it: {k: f(it) for k, f in parts.items()}
        if isinstance(item, (list, tuple)):
            parts = [flatten(v, leaves) for v in item]
            return lambda it: type(item)(f(it) for f in parts)
        leaves.append(item)
        return lambda it: NDArray(next(it))

    def producer():
        try:
            for item in source:
                leaves = []
                rebuild = flatten(item, leaves)
                staged, _, event = stager.stage(leaves, [])
                if not _put_or_stop(q, (staged, rebuild, event), stop):
                    return
        except Exception as e:          # raised at the consumer
            _put_or_stop(q, e, stop)
            return
        _put_or_stop(q, _STOP, stop)

    thread = threading.Thread(target=producer, daemon=True,
                              name="mxtorch-device-feed")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, Exception):
                raise item
            staged, rebuild, event = item
            stager.deliver(staged, event)
            yield rebuild(iter(staged))
    finally:
        _join_producer(thread, q, stop, "prefetch_to_device")


class DeviceFeedIter(DataIter):
    """A ``DataIter`` whose batches come out on the card, staged ``depth``
    batches ahead (the module docstring says how)::

        feed = DeviceFeedIter(ImageRecordIter(..., ctx=mx.cpu()),
                              wire_dtype="uint8", scale=1 / 255.)

    ``feed_stats`` counts the batches delivered, the seconds ``next()``
    waited for the producer, and the bytes copied to the card."""

    def __init__(self, base: DataIter, sharding=None, depth: int = 2,
                 wire_dtype: Optional[str] = None, scale: float = 1.0,
                 shift: float = 0.0, ctx=None):
        _no_sharding(sharding)
        if depth < 1:
            raise MXNetError("prefetch depth must be >= 1")
        super().__init__(getattr(base, "batch_size", 0))
        self._base = base
        self._depth = depth
        # the producer reads the base iterator under the caller's context
        # (its own Context: entering one records the thread's previous
        # context on it)
        ctx = ctx or current_context()
        self._ctx = type(ctx)(ctx.device_type, ctx.device_id)
        self._stager = _Stager(self._ctx.torch_device(), depth, wire_dtype,
                               scale, shift)
        self._track_state = has_state(base)
        self._last_state = base.state() if self._track_state else None
        self._closed = False
        self._terminal = None     # StopIteration or the producer's error
        self.feed_stats = {"batches": 0, "wait_s": 0.0, "copied_bytes": 0}
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def _producer(self, q, stop):
        # q and stop are arguments: a thread from before a reset() never
        # touches the new queue
        with self._ctx:
            self._produce(q, stop)

    def _produce(self, q, stop):
        try:
            while not stop.is_set():
                try:
                    b = self._base.next()
                except StopIteration:
                    _put_or_stop(q, _STOP, stop)
                    return
                state = self._base.state() if self._track_state else None
                data, label, event = self._stager.stage(b.data, b.label)
                staged = DataBatch(
                    data=[NDArray(t) for t in data],
                    label=[NDArray(t) for t in label], pad=b.pad,
                    index=b.index, bucket_key=getattr(b, "bucket_key", None))
                if not _put_or_stop(q, (staged, data + label, event, state),
                                    stop):
                    return
        except Exception as e:          # raised at the consumer
            _put_or_stop(q, e, stop)

    def _start(self):
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue, self._stop),
            daemon=True, name="mxtorch-device-feed-iter")
        self._thread.start()

    def _stop_producer(self):
        _join_producer(self._thread, self._queue, self._stop,
                       "DeviceFeedIter")
        self._thread = None
        self._terminal = None
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)

    def reset(self):
        """Stop the producer, rewind the base iterator, stage again."""
        if self._closed:
            raise MXNetError("DeviceFeedIter is closed")
        self._stop_producer()
        self._base.reset()
        if self._track_state:
            self._last_state = self._base.state()
        self._start()

    def state(self) -> dict:
        """The base iterator's state after the last batch delivered."""
        if not self._track_state:
            raise MXNetError(f"DeviceFeedIter.state: base iterator "
                             f"{type(self._base).__name__} has no state "
                             f"protocol")
        return {"iter": "DeviceFeedIter", "base": dict(self._last_state)}

    def set_state(self, state: dict) -> None:
        """Rewind the base iterator to ``state`` and stage from there;
        batches staged before are dropped (they were not delivered)."""
        if self._closed:
            raise MXNetError("DeviceFeedIter is closed")
        if not self._track_state:
            raise MXNetError("DeviceFeedIter.set_state: base iterator has "
                             "no state protocol")
        self._stop_producer()
        self._base.set_state(state["base"])
        self._last_state = dict(state["base"])
        self._start()

    def close(self):
        """Stop the producer, drop the staged batches and close the base
        iterator."""
        if self._closed:
            return
        self._closed = True
        self._stop_producer()
        self._base.close()

    def next(self) -> DataBatch:
        if self._closed:
            raise MXNetError("DeviceFeedIter is closed")
        if self._terminal is not None:
            raise self._terminal
        tic = time.perf_counter()
        item = self._queue.get()
        self.feed_stats["wait_s"] += time.perf_counter() - tic
        if item is _STOP:
            self._terminal = StopIteration
            raise StopIteration
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        staged, tensors, event, state = item
        self._stager.deliver(tensors, event)
        if state is not None:
            self._last_state = state
        self.feed_stats["batches"] += 1
        self.feed_stats["copied_bytes"] = self._stager.copied_bytes
        return staged

    def iter_next(self):
        raise MXNetError("use next() on DeviceFeedIter")

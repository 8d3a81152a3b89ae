"""KVStore — the store that ``Module`` pushes gradients to and pulls
weights from, for one process and one card.

Counterpart of ``create``, ``KVStore`` and ``KVStoreLocal`` in
``mxnet_tpu/kvstore.py`` (reference ``include/mxnet/kvstore.h`` and
``src/kvstore/``: the ``local``, ``device`` and ``nccl`` types). A push is
queued and returns at once; the next flush point (a pull, ``barrier``,
``set_updater``/``set_optimizer`` or the states files) sums every queued
push of a key and hands it to the updater, or stores it, highest priority
first. Pushes of one key keep their issue order, and the keys go in
buckets of ``MXNET_UPDATE_AGGREGATION_SIZE`` (4), as in the JAX package.
Under ``set_optimizer`` the optimizer runs inside the store, once a key a
flush, in that order (``Nadam``'s shared ``m_schedule`` sees it).

The store keeps its own copy of every value: ``init`` copies, the update
runs on the copy, and ``pull`` copies it into the caller's array (one
device copy an array, counted in ``comm_stats["pull_copies"]``). So a
weight written after ``init`` (``Module.set_params`` after
``init_optimizer``) is overwritten by the next pull, as in the JAX
package. ``row_sparse_pull`` writes the requested rows of a value into a
dense out array and zeroes the others, as the JAX package does; a sparse
array is refused as a value. Stores across processes (``dist_*``, their
``row_sparse_pull`` among them) and gradient compression wait for ROADMAP
A8.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "create"]


def create(name: str = "local") -> "KVStore":
    """A store by its type name (``local``, ``device``, ``nccl``)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if "dist" in name:
        raise NotImplementedError(
            f"kvstore {name!r}: stores across processes wait for ROADMAP A8")
    return KVStoreLocal(name)


def _key_value(keys, values):
    single = not isinstance(keys, (list, tuple))
    if single:
        return [keys], [values]
    keys = list(keys)
    return keys, list(values) if values is not None else [None] * len(keys)


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _tensor(v) -> torch.Tensor:
    from .ndarray.sparse import BaseSparseNDArray
    if isinstance(v, BaseSparseNDArray):
        raise MXNetError(f"kvstore: a {v.stype} value is refused; the store "
                         f"holds dense arrays (pull rows with "
                         f"row_sparse_pull)")
    return v._data if isinstance(v, NDArray) else v


class KVStore:
    """The store's interface (reference ``python/mxnet/kvstore.py``)."""

    def __init__(self, name: str):
        self.type = name
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._raw_updater = None
        self._store: Dict[Any, NDArray] = {}
        # (priority, seq, key, [tensors]) waiting for the next flush
        self._pending: List[tuple] = []
        # pushes queued, buckets flushed, elements summed, and the pull's
        # copies into callers' arrays with their bytes
        self.comm_stats: Dict[str, int] = {
            "pushes": 0, "bucket_reduces": 0, "dense_reduce_elems": 0,
            "pull_copies": 0, "pull_bytes": 0}

    # ------------------------------------------------------------- data plane
    def init(self, key, value) -> None:
        """A copy of each value under its key; a key already there keeps
        its value."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            src = _tensor(_as_list(v)[0])
            self._store[k] = NDArray(src.detach().clone())

    def push(self, key, value, priority: int = 0) -> None:
        """Queue a push (one array, or a list of arrays to sum)."""
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k} was not init'd")
            self._pending.append((priority, len(self._pending), k,
                                  [_tensor(v) for v in _as_list(vlist)]))
            self.comm_stats["pushes"] += 1

    def _flush(self) -> None:
        """Apply the queued pushes: keys by their first push's priority,
        highest first, each key's pushes in issue order, in buckets."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        key_prio: Dict[Any, int] = {}
        for prio, _, k, _ in pending:
            key_prio.setdefault(k, prio)
        pending.sort(key=lambda t: (-key_prio[t[2]], t[1]))
        agg = max(1, int(os.environ.get("MXNET_UPDATE_AGGREGATION_SIZE",
                                        4)))
        for start in range(0, len(pending), agg):
            bucket = pending[start:start + agg]
            for _, _, k, group in bucket:
                dst = self._store[k]
                merged = group[0]
                if merged.device != dst._data.device:
                    merged = merged.to(dst._data.device)
                for other in group[1:]:
                    merged = merged + other.to(merged.device)
                self.comm_stats["dense_reduce_elems"] += merged.numel()
                if self._updater is not None:
                    self._updater(k, NDArray(merged), dst)
                else:
                    with torch.no_grad():
                        dst._data.copy_(merged)
            self.comm_stats["bucket_reduces"] += 1

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True) -> None:
        """Copy each key's value into its out array (or arrays)."""
        self._flush()
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} was not init'd")
            src = self._store[k]._data
            for o in _as_list(olist):
                with torch.no_grad():
                    o._data.copy_(src)
                self.comm_stats["pull_copies"] += 1
                self.comm_stats["pull_bytes"] += src.numel() \
                    * src.element_size()

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Write the rows ``row_ids`` of each key's value into its out
        array (a dense array of the value's shape, or a list of them with
        a list of ``row_ids``), every other row zero (reference
        ``kvstore.h`` PullRowSparse). Queued pushes are applied first."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        self._flush()
        keys, outs = _key_value(key, out)
        rid_list = row_ids if isinstance(row_ids, list) else [row_ids]
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} was not init'd")
            src = self._store[k]._data
            for o, rid in zip(_as_list(olist), rid_list):
                idx = (rid._data if isinstance(rid, NDArray)
                       else torch.as_tensor(np.asarray(rid))).to(
                           src.device, torch.int64).reshape(-1)
                with torch.no_grad():
                    full = torch.zeros_like(src).index_copy_(
                        0, idx, src.index_select(0, idx))
                    _tensor(o).copy_(full)

    # ------------------------------------------------------------- control
    def set_updater(self, updater: Callable) -> None:
        self._flush()        # earlier pushes keep their earlier semantics
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        """Run ``optimizer`` inside the store, through its own updater,
        indexed by key."""
        from . import optimizer as opt_mod
        self._flush()
        self._optimizer = optimizer
        updater = opt_mod.get_updater(optimizer)
        self._raw_updater = updater

        def _apply(k, grad, weight):
            updater(k if isinstance(k, int) else hash(k) % (1 << 30), grad,
                    weight)

        self._updater = _apply

    def set_gradient_compression(self, compression_params) -> None:
        raise NotImplementedError("set_gradient_compression: gradient "
                                  "compression waits for ROADMAP A8")

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self) -> None:
        self._flush()

    def save_optimizer_states(self, fname: str,
                              dump_optimizer: bool = False) -> None:
        """The store's updater states (and its optimizer, if asked) in
        ``fname``: a pickle, as ``Updater.get_states`` writes it."""
        self._flush()
        if self._raw_updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            self._raw_updater.dump_states(f, dump_optimizer)

    def load_optimizer_states(self, fname: str) -> None:
        """Load what :meth:`save_optimizer_states` wrote (files this
        program wrote: they are pickles)."""
        self._flush()          # queued gradients use the states they met
        if self._raw_updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._raw_updater.set_states(f)
        self._optimizer = self._raw_updater.optimizer


class KVStoreLocal(KVStore):
    """``local``, ``device`` and ``nccl``: one process, one card."""

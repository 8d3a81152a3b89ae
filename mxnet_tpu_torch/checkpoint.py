"""Asynchronous, atomically committed checkpoints.

Counterpart of ``mxnet_tpu/checkpoint.py``: the same directory of steps,
the same commit protocol and the same manifest, over a payload of its own.

- **Directory and commit.** Every save lands in a hidden
  ``.pending_step_N.<pid>.<nonce>`` directory and is published as
  ``step_N`` by one ``rename``, after a manifest (relative path, size and
  crc32 of every file, plus the caller's ``manifest`` dict) and then the
  commit marker are written and fsynced. ``steps()``/``latest_step()``
  list committed steps only; ``verify`` re-checks every file's size and
  crc32, and ``restore`` refuses a step that fails it.
- **Payload.** orbax and tensorstore are not part of the port's
  installation, so each array is one raw little-endian file
  (``data/NNNNN.raw``; bfloat16 as its 16-bit pattern) and ``arrays.json``
  indexes them by name, dtype and shape. A port checkpoint is therefore not
  readable by the JAX package, nor the other way round; the reference's
  ``.params`` files (:mod:`~mxnet_tpu_torch.interop`) are the format both
  packages share.
- **Asynchronous save.** ``save(..., async_save=True)`` copies the card's
  tensors into page-locked host buffers on a side stream and makes the
  caller's stream wait for that copy's event, so a kernel enqueued after
  ``save`` returns (the next step's in-place update) cannot change a value
  before it is copied. It returns without waiting for the card. A writer
  thread writes the files (several at once, computing each crc32 as it
  writes); the step is
  committed at the next ``save``, ``restore``, ``steps()``,
  ``wait_until_finished`` or ``close``, so at most one save is ever in the
  uncommitted window. A failed write raises there.
- **Restore.** ``restore(step, like=...)`` lands each array on its ``like``
  array's device and in its dtype (a shape that differs raises); without
  ``like`` arrays land on the current context. The port runs one card per
  process: ``shardings=`` and a manifest recording a topology of other
  than one device raise (multi-card meshes and elastic adoption are
  ROADMAP A1d and A9).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, logger

__all__ = ["ShardedCheckpointer", "save_sharded", "load_sharded"]

COMMIT_MARKER = "_MXTPU_COMMITTED"
MANIFEST_NAME = "_MXTPU_MANIFEST.json"
INDEX_NAME = "arrays.json"
PAYLOAD_FORMAT = "mxnet_tpu_torch.raw-1"

_CHUNK = 64 << 20
_ALIGN = 64


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_tree(params) -> Dict[str, Any]:
    """A ``ParameterDict``, a dict of ``Parameter``/``NDArray``/tensors/
    numpy arrays, or a ``Module``'s params dict, as ``{name: tensor}``."""
    from .ndarray.ndarray import NDArray
    items = params.items() if hasattr(params, "items") \
        else ((p.name, p) for p in params.values())
    out = {}
    for k, v in items:
        if hasattr(v, "data") and callable(v.data) and not isinstance(
                v, (NDArray, np.ndarray, torch.Tensor)):   # gluon Parameter
            v = v.data()
        if isinstance(v, NDArray):
            v = v._data
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        elif not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        out[k] = v.detach()
    return out


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass


class _Snapshot:
    """Host copies of a tree's arrays, taken when a save is called: the
    card's tensors into one page-locked buffer on a side stream (ready
    when ``event`` completes), the host's copied at once."""

    def __init__(self, tree: Dict[str, torch.Tensor], pinned_pool,
                 side_stream):
        self.names = list(tree)
        self.host: Dict[str, torch.Tensor] = {}
        self.events: List[torch.cuda.Event] = []
        on_card = [n for n in self.names if tree[n].device.type == "cuda"]
        offsets, total = {}, 0
        for n in on_card:
            t = tree[n]
            offsets[n] = total
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        if on_card:
            flat = pinned_pool(total)
            for dev in sorted({tree[n].device for n in on_card}, key=str):
                names = [n for n in on_card if tree[n].device == dev]
                caller = torch.cuda.current_stream(dev)
                side = side_stream(dev)
                side.wait_stream(caller)
                with torch.cuda.stream(side):
                    for n in names:
                        t = tree[n]
                        nbytes = t.numel() * t.element_size()
                        buf = flat[offsets[n]:offsets[n] + nbytes].view(
                            t.dtype).view(t.shape)
                        buf.copy_(t, non_blocking=True)
                        t.record_stream(side)
                        self.host[n] = buf
                event = torch.cuda.Event()
                event.record(side)
                # the caller's later kernels (an in-place update) wait for
                # the copy: nothing written after save reaches the file
                caller.wait_event(event)
                self.events.append(event)
        for n in self.names:
            if n not in self.host:
                self.host[n] = tree[n].to("cpu", copy=True)

    def ready(self) -> None:
        for event in self.events:
            event.synchronize()


def _write_raw(path: str, t: torch.Tensor) -> tuple:
    """``t``'s bytes to ``path``, fsynced; (size, crc32)."""
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    crc = 0
    with open(path, "wb") as f:
        for off in range(0, raw.nbytes, _CHUNK):
            chunk = raw[off:off + _CHUNK]
            crc = zlib.crc32(chunk, crc)
            f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    return raw.nbytes, crc & 0xFFFFFFFF


def _io_pool() -> ThreadPoolExecutor:
    """Threads for one pass over a step's files: writing, crc32 and
    reading release the interpreter lock, so files go in parallel."""
    return ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                              thread_name_prefix="mxnet-ckpt-io")


def _write_payload(tmp: str, snap: _Snapshot) -> Dict[str, tuple]:
    """The arrays' raw files and their index under ``tmp``; returns
    {relative path: (size, crc32)} of what it wrote."""
    if sys.byteorder != "little":  # pragma: no cover
        raise MXNetError("the checkpoint payload is little-endian")
    snap.ready()
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    rels = [f"data/{i:05d}.raw" for i in range(len(snap.names))]
    with _io_pool() as pool:
        sums = list(pool.map(
            lambda i: _write_raw(os.path.join(tmp, rels[i]),
                                 snap.host[snap.names[i]]),
            range(len(rels))))
    written: Dict[str, tuple] = dict(zip(rels, sums))
    index = [{"name": name, "file": rel,
              "dtype": _dtype_name(snap.host[name].dtype),
              "shape": list(snap.host[name].shape)}
             for name, rel in zip(snap.names, rels)]
    body = json.dumps({"format": PAYLOAD_FORMAT, "arrays": index},
                      indent=1).encode()
    with open(os.path.join(tmp, INDEX_NAME), "wb") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    written[INDEX_NAME] = (len(body), zlib.crc32(body) & 0xFFFFFFFF)
    return written


class ShardedCheckpointer:
    """Directory-of-steps checkpointer (one ``step_N`` per step)::

        ckpt = ShardedCheckpointer("/path/run1")
        ckpt.save(step, params, aux=state, async_save=True)  # returns at once
        params = ckpt.restore(step, like=params)

    Commit protocol (the JAX package's):

    1. the payload is written into ``<dir>/.pending_step_N.<pid>.<nonce>/``;
    2. a manifest (relative path, size, crc32 of every file, plus the
       caller's resume metadata) is written inside it;
    3. the commit marker is written inside it and fsynced;
    4. one ``rename(temp, step_N)`` publishes the checkpoint.
    """

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # step -> (temp dir, user manifest, the write's future); guarded by
        # _lock
        self._pending: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pinned: Optional[torch.Tensor] = None
        self._streams: Dict[str, Any] = {}
        self._closed = False

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def _tmp_dir(self, step: int) -> str:
        return os.path.join(self.directory, ".pending_step_%d.%d.%s" % (
            int(step), os.getpid(), uuid.uuid4().hex[:8]))

    def _pinned_pool(self, nbytes: int) -> torch.Tensor:
        """One page-locked byte buffer of at least ``nbytes``, kept for
        the next save (no save is in flight when it is handed out)."""
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = None
            self._pinned = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
        return self._pinned

    def _side_stream(self, dev):
        """The stream this checkpointer copies ``dev``'s tensors on."""
        key = str(dev)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(dev)
        return self._streams[key]

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, aux: Optional[Dict] = None,
             async_save: bool = False, overwrite: bool = True,
             manifest: Optional[Dict] = None) -> None:
        """Save ``params`` (and ``aux``, stored under ``__aux__`` names) as
        step ``step``, with ``manifest`` (a JSON-serializable dict) in the
        step's manifest. The step is listed and restorable only once
        written and committed; with ``async_save`` that happens at the next
        save (of any step), restore, ``steps()`` or close."""
        step = int(step)
        tree = _to_tree(params)
        if aux:
            tree = dict(tree, **{f"__aux__{k}": v
                                 for k, v in _to_tree(aux).items()})
        with self._lock:
            have_pending = bool(self._pending)
        if have_pending:
            # commit what is in flight first: a re-save of one step must
            # not race the old write, and an async save must not wait
            # uncommitted for the end of the run
            self.wait_until_finished()
        if self._is_committed(self._step_dir(step)) and not overwrite:
            raise MXNetError(f"checkpoint step {step} already exists at "
                             f"{self._step_dir(step)} (overwrite=False)")
        tmp = self._tmp_dir(step)
        user_manifest = dict(manifest) if manifest else {}
        snap = _Snapshot(tree, self._pinned_pool, self._side_stream)
        if async_save:
            if self._writer is None:
                self._writer = ThreadPoolExecutor(
                    1, thread_name_prefix="mxnet-ckpt-writer")
            future = self._writer.submit(_write_payload, tmp, snap)
            with self._lock:
                self._pending[step] = (tmp, user_manifest, future)
        else:
            self._commit(step, tmp, user_manifest, _write_payload(tmp, snap))

    def _commit(self, step: int, tmp: str, user_manifest: Dict,
                written: Dict[str, tuple]) -> None:
        """Manifest + marker inside the temp dir, then one atomic rename.
        Each file's crc32 is the one computed as it was written; a file
        whose size changed since raises."""
        files: List[Dict[str, Any]] = []
        for rel, (size, crc) in sorted(written.items()):
            if os.path.getsize(os.path.join(tmp, rel)) != size:
                raise MXNetError(f"checkpoint step {step}: {rel} changed "
                                 f"on disk before its commit")
            files.append({"path": rel, "size": size, "crc32": crc})
        man = {"format": 1, "step": step, "files": files,
               "user": user_manifest}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            f.write("ok\n")
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.isdir(final):
            # overwrite: retire the old step out of the namespace first
            retired = os.path.join(
                self.directory,
                ".retired_step_%d.%s" % (step, uuid.uuid4().hex[:8]))
            os.rename(final, retired)
            try:
                os.rename(tmp, final)
            except BaseException:
                os.rename(retired, final)   # roll the old checkpoint back
                raise
            shutil.rmtree(retired, ignore_errors=True)
        else:
            os.rename(tmp, final)
        _fsync_dir(self.directory)

    def wait_until_finished(self) -> None:
        """Join the in-flight async save and commit it; a failed write
        raises ``MXNetError``."""
        with self._lock:
            pending, self._pending = self._pending, {}
        for step in sorted(pending):
            tmp, user_manifest, future = pending[step]
            try:
                written = future.result()
            except Exception as e:
                raise MXNetError(f"async save of step {step} failed: "
                                 f"{e!r}") from e
            self._commit(step, tmp, user_manifest, written)

    # --------------------------------------------------------------- inspect
    def _is_committed(self, path: str) -> bool:
        return os.path.isfile(os.path.join(path, COMMIT_MARKER))

    def verify(self, step: int) -> bool:
        """True iff step ``step`` is committed and every file its manifest
        lists still has its recorded size and crc32."""
        path = self._step_dir(step)
        if not self._is_committed(path):
            return False
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as f:
                man = json.load(f)
        except (OSError, ValueError):
            return False
        files = man.get("files", [])
        try:
            if any(os.path.getsize(os.path.join(path, e["path"]))
                   != e["size"] for e in files):
                return False
            with _io_pool() as pool:
                crcs = list(pool.map(
                    lambda e: _crc_file(os.path.join(path, e["path"])),
                    files))
        except OSError:
            return False
        return all(c == e["crc32"] for c, e in zip(crcs, files))

    def adopt(self, step: int) -> None:
        """Commit an existing, uncommitted ``step_N`` directory in place
        (a manifest over its current files, then the marker); no-op if it
        is committed."""
        path = self._step_dir(step)
        if not os.path.isdir(path):
            raise MXNetError(f"no checkpoint directory at {path} to adopt")
        if self._is_committed(path):
            return
        files: List[Dict[str, Any]] = []
        for root, _, names in os.walk(path):
            for name in sorted(names):
                if name in (COMMIT_MARKER, MANIFEST_NAME):
                    continue
                full = os.path.join(root, name)
                files.append({"path": os.path.relpath(full, path),
                              "size": os.path.getsize(full),
                              "crc32": _crc_file(full)})
        man = {"format": 1, "step": int(step), "files": files,
               "user": {"adopted": True}}
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(path, COMMIT_MARKER), "w") as f:
            f.write("ok (adopted)\n")
            f.flush()
            os.fsync(f.fileno())

    def read_manifest(self, step: int) -> Dict[str, Any]:
        """The manifest committed with step ``step`` (``user`` holds the
        caller's metadata)."""
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        try:
            with open(path) as f:
                return json.load(f)
        except OSError:
            raise MXNetError(f"no committed checkpoint manifest at {path}") \
                from None

    def _committed_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    step = int(name[5:])
                except ValueError:
                    continue
                if self._is_committed(os.path.join(self.directory, name)):
                    out.append(step)
        return sorted(out)

    def steps(self):
        """The committed steps, sorted, after committing what is in
        flight."""
        self.wait_until_finished()
        return self._committed_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def prune_newer(self, step: int) -> int:
        """Remove the committed steps after ``step`` (a rewind abandons
        them), after committing what is in flight; returns how many."""
        self.wait_until_finished()
        dropped = 0
        for s in self._committed_steps():
            if s > step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                dropped += 1
        return dropped

    # --------------------------------------------------------------- restore
    def restore(self, step: int, like=None, shardings=None,
                allow_reshard: bool = False) -> Dict[str, torch.Tensor]:
        """Step ``step`` as ``{name: tensor}``: each array on its ``like``
        array's device and in its dtype, the rest on the current context.
        Refuses an uncommitted or torn step. A ``like`` name the step lacks
        raises, unless ``allow_reshard`` (it is then left out, with a
        warning)."""
        from .context import current_context
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...): a mesh of more than one card waits "
                "for ROADMAP A1d; pass like= arrays")
        path = self._step_dir(step)
        self.wait_until_finished()
        if not os.path.isdir(path) or not self._is_committed(path):
            raise MXNetError(f"no checkpoint at {path}"
                             + (" (directory exists but was never committed"
                                " — a save died mid-write)"
                                if os.path.isdir(path) else ""))
        if not self.verify(step):
            raise MXNetError(
                f"checkpoint at {path} is torn: a file fails its manifest "
                f"size/crc32 check — refusing to restore partial state")
        topology = self.read_manifest(step).get("user", {}).get("topology")
        if topology and int(topology.get("n_devices") or 1) != 1 \
                and not allow_reshard:
            raise MXNetError(
                f"checkpoint step {step} records a "
                f"{topology['n_devices']}-device topology; the port runs "
                f"one card per process (elastic adoption waits for ROADMAP "
                f"A9, multi-card meshes for A1d)")
        with open(os.path.join(path, INDEX_NAME)) as f:
            index = json.load(f)
        if index.get("format") != PAYLOAD_FORMAT:
            raise MXNetError(f"checkpoint at {path} is not in the port's "
                             f"payload format ({index.get('format')!r})")
        entries = {e["name"]: e for e in index["arrays"]}
        target = _to_tree(like) if like is not None else {}
        missing = sorted(k for k in target if k not in entries)
        if missing:
            if not allow_reshard:
                raise MXNetError(f"checkpoint step {step} lacks {missing} "
                                 f"that like= carries")
            logger.warning("checkpoint step %d lacks %d key(s) the restore "
                           "target carries (%s); they keep their live "
                           "values", step, len(missing), missing)
        for name, e in entries.items():
            ref = target.get(name)
            if ref is not None and tuple(ref.shape) != tuple(e["shape"]):
                raise MXNetError(f"checkpoint step {step}: {name} has shape "
                                 f"{tuple(e['shape'])}, like= "
                                 f"{tuple(ref.shape)}")
        default = None
        if any(name not in target for name in entries):
            default = current_context().torch_device()

        def load(e):
            raw = np.fromfile(os.path.join(path, e["file"]), dtype=np.uint8)
            t = torch.from_numpy(raw).view(getattr(torch, e["dtype"]))
            t = t.reshape(e["shape"])
            ref = target.get(e["name"])
            if ref is None:
                return t.to(default)
            return t.to(device=ref.device, dtype=ref.dtype)

        with _io_pool() as pool:
            return dict(zip(entries, pool.map(load, entries.values())))

    # ------------------------------------------------------------------- gc
    def gc(self, keep: Optional[int] = None) -> None:
        """Remove stale temp/retired directories (never this process's
        in-flight save) and, with ``keep``, all but the newest ``keep``
        committed steps."""
        with self._lock:
            live = {tmp for tmp, _, _ in self._pending.values()}
        for name in os.listdir(self.directory):
            if name.startswith((".pending_step_", ".retired_step_")):
                full = os.path.join(self.directory, name)
                if full in live:
                    continue
                shutil.rmtree(full, ignore_errors=True)
        if keep is not None and keep > 0:
            steps = self._committed_steps()
            for step in steps[:-keep]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def close(self) -> None:
        """Join and commit the in-flight save, stop the writer thread,
        release the page-locked buffer. Idempotent."""
        if self._closed:
            return
        self.wait_until_finished()
        if self._writer is not None:
            self._writer.shutdown()
            self._writer = None
        self._pinned = None
        self._closed = True


# ------------------------------------------------------------- functional API
def save_sharded(directory: str, step: int, params, aux=None,
                 async_save: bool = False) -> ShardedCheckpointer:
    """One-shot save; returns the checkpointer (keep it and call
    ``wait_until_finished`` after an ``async_save``)."""
    ckpt = ShardedCheckpointer(directory)
    ckpt.save(step, params, aux=aux, async_save=async_save)
    return ckpt


def load_sharded(directory: str, step: int, like=None
                 ) -> Dict[str, torch.Tensor]:
    ckpt = ShardedCheckpointer(directory)
    try:
        return ckpt.restore(step, like=like)
    finally:
        ckpt.close()

"""Calibration: run the float model over a calibration iterator and
record per-tensor activation ranges in a serializable :class:`CalibTable`.

Counterpart of ``mxnet_tpu/quant/calib.py``. The statistics are the
estimators of :mod:`mxnet_tpu_torch.contrib.quantization` —
``calib_minmax`` (naive min/max) and ``calib_entropy`` (the KL threshold
search of the reference's ``_get_optimal_threshold``) — so a pass-route
quantization bakes in the numbers ``contrib.quantization`` would. A table is a
JSON file, the same document the JAX package writes, so a table written
by either package loads in the other. The calibration batches' counter
(``mxtpu_quant_calib_batches_total``) waits for the telemetry layer
(ROADMAP A9).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["CalibTable", "collect"]


class CalibTable:
    """Per-tensor activation ranges, keyed by the *consumer* node name
    (the Convolution/FullyConnected whose input the range describes —
    the same key ``contrib.quantization.quantize_graph`` expects in its
    ``calib_ranges``).

    A plain data object: ``ranges[name] -> (min, max)`` plus provenance
    (``mode``, ``num_examples``, ``model``). JSON round-trips bitwise
    through :meth:`save`/:meth:`load`.
    """

    VERSION = 1

    def __init__(self, ranges: Optional[Dict[str, Tuple[float, float]]] = None,
                 *, mode: str = "entropy", num_examples: int = 0,
                 model: Optional[str] = None):
        self.ranges: Dict[str, Tuple[float, float]] = {
            str(k): (float(v[0]), float(v[1]))
            for k, v in (ranges or {}).items()}
        self.mode = str(mode)
        self.num_examples = int(num_examples)
        self.model = model

    # ------------------------------------------------------------- mapping
    def get(self, name: str) -> Optional[Tuple[float, float]]:
        return self.ranges.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.ranges

    def __len__(self) -> int:
        return len(self.ranges)

    def __repr__(self) -> str:
        return (f"<CalibTable {len(self)} range(s), mode={self.mode!r}, "
                f"num_examples={self.num_examples}>")

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.VERSION, "mode": self.mode,
                "num_examples": self.num_examples, "model": self.model,
                "ranges": {k: [v[0], v[1]]
                           for k, v in sorted(self.ranges.items())}}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "CalibTable":
        if not isinstance(doc, dict) or "ranges" not in doc:
            raise MXNetError("not a CalibTable document (no 'ranges' key)")
        return cls({k: (float(v[0]), float(v[1]))
                    for k, v in doc["ranges"].items()},
                   mode=doc.get("mode", "entropy"),
                   num_examples=int(doc.get("num_examples", 0)),
                   model=doc.get("model"))

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class _CountingIter:
    """Wrap a calibration iterable, counting the batches and examples it
    delivers (the collector below streams it once)."""

    def __init__(self, it: Iterable, mode: str):
        self._it = it
        self._mode = mode
        self.batches = 0
        self.examples = 0

    def __iter__(self):
        for batch in self._it:
            self.batches += 1
            try:
                first = batch.data[0] if hasattr(batch, "data") else batch
                self.examples += int(first.shape[0])
            except Exception:
                pass
            yield batch


def collect(sym, arg_params, aux_params=None, calib_data=None,
            data_names: Sequence[str] = ("data",), mode: str = "entropy",
            num_calib_examples: Optional[int] = None,
            min_percentile: Optional[float] = 99.0,
            model: Optional[str] = None, ctx=None) -> CalibTable:
    """Run the fp32 ``sym`` over ``calib_data`` and return a
    :class:`CalibTable` of per-tensor input ranges for every quantizable
    (Convolution/FullyConnected) node.

    ``mode``: ``"naive"`` (running min/max) or ``"entropy"`` (KL threshold
    over a bounded activation subsample). The walk itself is
    ``contrib.quantization._collect_calib_ranges``: one executor bind on
    ``ctx`` (the current context, the card by default), streaming
    statistics, never the full activation history.
    """
    if calib_data is None:
        raise MXNetError("collect() needs a calibration iterator")
    if mode not in ("naive", "entropy"):
        raise MXNetError(f"unknown calibration mode {mode!r} "
                         "(want 'naive' or 'entropy')")
    from ..contrib.quantization import _collect_calib_ranges
    counting = _CountingIter(calib_data, mode)
    ranges = _collect_calib_ranges(
        sym, arg_params, dict(aux_params or {}), tuple(data_names),
        counting, num_calib_examples, mode, min_percentile=min_percentile,
        ctx=ctx)
    return CalibTable(ranges, mode=mode, num_examples=counting.examples,
                      model=model)

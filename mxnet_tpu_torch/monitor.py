"""Monitor — per-layer output statistics.

Counterpart of ``mxnet_tpu/monitor.py`` (reference
``python/mxnet/monitor.py`` over ``GraphExecutor::SetMonitorCallback``):
``install`` taps an executor's outputs after each forward, ``tic`` opens a
batch every ``interval`` batches, ``toc`` returns ``(step, name, value)``
for each tapped output, and ``install_trainer`` adds a fused trainer's
grad-anomaly counters (``anomaly_stats()``) to the same list. The JAX
package mirrors each value into its telemetry registry, which the port's
operational layers will bring (ROADMAP A9).
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        if stat_func is None:
            def stat_func(x):
                return abs(x).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.trainers = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))

        self.stat_helper = stat_helper

    def install(self, exe, monitor_all: bool = False) -> None:
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def install_trainer(self, trainer) -> None:
        """Tap a trainer with ``anomaly_stats()`` (``DataParallelTrainer``
        with ``grad_guard``): each ``toc`` adds its counters (skipped
        steps, the norm's EMA, the last norm) to the layer taps."""
        self.trainers.append(trainer)

    def tic(self) -> None:
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List:
        """``[(step, name, value string)]`` of the batch ``tic`` opened;
        an array statistic reads as ``"%.5f"`` (one copy to the host
        each), sorted by (name, step) under ``sort=True``."""
        if not self.activated:
            return []
        self.activated = False
        for trainer in self.trainers:
            stats = getattr(trainer, "anomaly_stats", None)
            if stats is None:
                continue
            for name, value in sorted(stats().items()):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, value))
        queue = sorted(self.queue, key=lambda x: (x[1], x[0])) \
            if self.sort else self.queue
        res = []
        for n, k, v_list in queue:
            items = v_list if isinstance(v_list, list) else [v_list]
            v = ", ".join(f"{float(x.asnumpy().reshape(-1)[0]):.5f}"
                          if isinstance(x, NDArray) else str(x)
                          for x in items)
            res.append((n, k, v))
        self.queue = []
        return res

    def toc_print(self) -> None:
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)

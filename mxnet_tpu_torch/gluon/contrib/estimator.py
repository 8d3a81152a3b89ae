"""Gluon Estimator with event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``; reference
``python/mxnet/gluon/contrib/estimator``: estimator.py and
event_handler.py).

A training loop over a net, a loss and a trainer: the handlers receive the
train_begin, epoch_begin, batch_begin, batch_end, epoch_end and train_end
events and read or write the estimator's state (its metrics, its stop
flag). ``LoggingHandler``, ``CheckpointHandler``, ``EarlyStoppingHandler``
and ``ValidationHandler`` are the reference's set.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import List, Optional, Sequence

from ... import autograd
from ...base import MXNetError

__all__ = ["Estimator", "EventHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "ValidationHandler"]


class EventHandler:
    """Base handler: every event does nothing."""

    def train_begin(self, est):
        pass

    def train_end(self, est):
        pass

    def epoch_begin(self, est):
        pass

    def epoch_end(self, est):
        pass

    def batch_begin(self, est):
        pass

    def batch_end(self, est):
        pass


class LoggingHandler(EventHandler):
    """Logs the metrics at each epoch's end, and every ``log_interval``
    batches if given."""

    def __init__(self, log_interval: Optional[int] = None, logger=None):
        self.log_interval = log_interval
        self.logger = logger or logging.getLogger("estimator")

    def epoch_begin(self, est):
        self._tic = time.time()

    def batch_end(self, est):
        if self.log_interval and est.batch_idx % self.log_interval == 0:
            msg = ", ".join(f"{m.get()[0]}={m.get()[1]:.4f}"
                            for m in est.train_metrics)
            self.logger.info("epoch %d batch %d: %s", est.epoch,
                             est.batch_idx, msg)

    def epoch_end(self, est):
        msg = ", ".join(f"{m.get()[0]}={m.get()[1]:.4f}"
                        for m in est.train_metrics + est.val_metrics)
        self.logger.info("epoch %d done in %.1fs: %s", est.epoch,
                         time.time() - self._tic, msg)


class CheckpointHandler(EventHandler):
    """Saves the net's parameters at each epoch's end as
    ``<model_dir>/<prefix>-<epoch:04d>.params``; with ``save_best``, also
    ``<prefix>-best.params`` whenever ``monitor`` improves."""

    def __init__(self, model_dir: str, model_prefix: str = "model",
                 monitor=None, save_best: bool = False, mode: str = "min"):
        os.makedirs(model_dir, exist_ok=True)
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.mode = mode
        self.best = float("inf") if mode == "min" else -float("inf")

    def epoch_end(self, est):
        est.net.save_parameters(os.path.join(
            self.model_dir, f"{self.model_prefix}-{est.epoch:04d}.params"))
        if self.save_best and self.monitor is not None:
            val = self.monitor.get()[1]
            better = val < self.best if self.mode == "min" else val > self.best
            if better:
                self.best = val
                est.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(EventHandler):
    """Stops training once ``monitor`` has not improved by ``min_delta``
    for ``patience`` epochs."""

    def __init__(self, monitor, patience: int = 2, mode: str = "min",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = float("inf") if mode == "min" else -float("inf")
        self.waited = 0

    def epoch_end(self, est):
        val = self.monitor.get()[1]
        improved = (val < self.best - self.min_delta if self.mode == "min"
                    else val > self.best + self.min_delta)
        if improved:
            self.best = val
            self.waited = 0
        else:
            self.waited += 1
            if self.waited >= self.patience:
                est.stop_training = True


class ValidationHandler(EventHandler):
    """Runs ``eval_fn(val_data)`` at each epoch's end."""

    def __init__(self, val_data, eval_fn):
        self.val_data = val_data
        self.eval_fn = eval_fn

    def epoch_end(self, est):
        self.eval_fn(self.val_data)


class Estimator:
    """Trains and evaluates a gluon net with a handler pipeline."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = list(train_metrics or [])
        self.val_metrics: List = []
        self.trainer = trainer
        self.context = context
        self.epoch = 0
        self.batch_idx = 0
        self.stop_training = False

    def evaluate(self, val_data, metrics: Optional[Sequence] = None):
        """The metrics (by default the validation metrics, else the
        training ones), reset and updated over ``val_data``: a list of
        their ``get()``."""
        metrics = list(metrics if metrics is not None else self.val_metrics
                       or self.train_metrics)
        for m in metrics:
            m.reset()
        if hasattr(val_data, "reset"):
            val_data.reset()
        for batch in val_data:
            data, label = _split(batch)
            out = self.net(data)
            for m in metrics:
                m.update(label, out)
        return [m.get() for m in metrics]

    def fit(self, train_data, val_data=None, epochs: int = 1,
            event_handlers: Optional[List[EventHandler]] = None,
            batches: Optional[int] = None):
        """Train for ``epochs`` (at most ``batches`` batches each): a
        forward under ``autograd.record()``, the loss's backward and
        ``trainer.step(batch size)`` a batch. With ``val_data``, a
        ``ValidationHandler`` over copies of the training metrics (named
        ``val_*``) runs first at each epoch's end; a ``LoggingHandler`` is
        added unless one is given."""
        if self.trainer is None:
            raise MXNetError("Estimator needs a trainer")
        handlers = list(event_handlers or [])
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())
        if val_data is not None:
            if not self.val_metrics:
                self.val_metrics = [copy.deepcopy(m)
                                    for m in self.train_metrics]
                for m in self.val_metrics:
                    m.name = f"val_{m.name}"
                    m.reset()
            if not any(isinstance(h, ValidationHandler) for h in handlers):
                handlers.append(ValidationHandler(
                    val_data,
                    lambda vd: self.evaluate(vd, self.val_metrics)))
        # validation first at epoch_end, so that the other handlers see
        # this epoch's validation numbers
        handlers.sort(key=lambda h: 0 if isinstance(h, ValidationHandler)
                      else 1)
        self.stop_training = False
        for h in handlers:
            h.train_begin(self)
        for epoch in range(epochs):
            self.epoch = epoch
            for m in self.train_metrics:
                m.reset()
            for h in handlers:
                h.epoch_begin(self)
            if hasattr(train_data, "reset"):
                train_data.reset()
            for i, batch in enumerate(train_data):
                if batches is not None and i >= batches:
                    break
                self.batch_idx = i
                for h in handlers:
                    h.batch_begin(self)
                data, label = _split(batch)
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                for m in self.train_metrics:
                    m.update(label, out)
                for h in handlers:
                    h.batch_end(self)
            for h in handlers:
                h.epoch_end(self)
            if self.stop_training:
                break
        for h in handlers:
            h.train_end(self)
        return self


def _split(batch):
    """(data, label) of a (data, label) pair or a ``DataBatch``."""
    if hasattr(batch, "data"):
        return batch.data[0], batch.label[0]
    return batch[0], batch[1]

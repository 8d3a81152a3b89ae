"""Evaluation metrics.

Counterpart of ``EvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``CrossEntropy``, ``Perplexity``, ``Loss``, ``MSE``,
``CompositeEvalMetric``, ``CustomMetric`` and ``create`` in
``mxnet_tpu/metric.py`` (reference ``python/mxnet/metric.py``). Metrics
read their inputs on the host, in numpy, as the reference's do; the other
metrics of the registry wait for a later slice.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "MSE", "CrossEntropy",
           "Perplexity", "Loss", "CompositeEvalMetric", "CustomMetric",
           "create"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from an instance, a registered name or alias, a callable
    (``CustomMetric``) or a list of these (``CompositeEvalMetric``)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key not in _METRIC_REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}")
    return _METRIC_REGISTRY[key](*args, **kwargs)


def _to_np(x) -> np.ndarray:
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, labels: Dict, preds: Dict):
        preds = [preds[n] for n in self.output_names] \
            if self.output_names is not None else list(preds.values())
        labels = [labels[n] for n in self.label_names] \
            if self.label_names is not None else list(labels.values())
        self.update(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_as_list(name), _as_list(value)))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _to_np(pred), _to_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label).astype("int32").reshape(-1)
            top = np.argsort(pred, axis=1)[:, -self.top_k:]
            self.sum_metric += float((top == label[:, None]).any(axis=1).sum())
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype("int32")
            prob = _to_np(pred)[np.arange(label.shape[0]), label]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype("int32")
            pred = _to_np(pred)
            probs = pred.reshape(-1, pred.shape[-1])[
                np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(np.log(np.maximum(probs, 1e-10)).sum())
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class Loss(EvalMetric):
    """Mean of a loss output (reference ``metric.py:Loss``)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.extend(_as_list(name))
            values.extend(_as_list(value))
        return names, values


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(name or getattr(feval, "__name__", "custom"),
                         output_names, label_names)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            reval = self._feval(_to_np(label), _to_np(pred))
            if isinstance(reval, tuple):
                self.sum_metric += reval[0]
                self.num_inst += reval[1]
            else:
                self.sum_metric += reval
                self.num_inst += 1


for _alias, _klass in (("acc", Accuracy), ("ce", CrossEntropy),
                       ("top_k_accuracy", TopKAccuracy),
                       ("top_k_acc", TopKAccuracy)):
    _METRIC_REGISTRY[_alias] = _klass

"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference
``python/mxnet/gluon/loss.py``): every loss, in plain ops.
``SoftmaxCrossEntropyLoss`` is ``log_softmax`` and ``pick``, as in the JAX
package: it does not reach the fused kernel; the ``softmax_cross_entropy``
op does. The JAX package's quirks are kept: ``SigmoidBinaryCrossEntropyLoss``
accepts ``pos_weight`` and ignores it; ``KLDivLoss`` adds 1e-12 inside its
log and ``CosineEmbeddingLoss`` 1e-12 to its norms' product; ``CTCLoss``
applies no weighting (neither ``weight`` nor ``sample_weight``) and returns
float64 (the recursion's type, :mod:`..ops.ctc`). ``CosineEmbeddingLoss``
compares its label through the ``_equal_scalar`` op, so that it builds a
graph too (in the JAX package a hybridized one raises: ``label == 1`` on a
Symbol is Python's identity test).
"""
from __future__ import annotations

import torch

from .. import autograd
from ..ndarray import NDArray
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            # max(x, 0) − x·z + log(1 + exp(−|x|)), stable for any x
            loss = F.relu(pred) - pred * label + F.Activation(
                -F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = F.reshape_like(label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification, the blank the last class
    (reference ``blank_label='last'``), labels 0-based and padded with −1
    (or cut by ``label_lengths``), frames cut by ``pred_lengths``.

    Eagerly (NDArray inputs) it runs :func:`..ops.ctc.ctc_nll` on the
    (N, T, C) logits, with negative labels taken as 0; in a graph
    (Symbols) it is the ``CTCLoss`` op on the logits transposed to TNC,
    with zero placeholders for the lengths it is not given."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if isinstance(pred, NDArray):
            return self._eager(pred, label, pred_lengths, label_lengths)
        p = pred if self._layout == "TNC" else F.transpose(pred,
                                                           axes=(1, 0, 2))
        lab = label if self._label_layout == "NT" else F.transpose(
            label, axes=(1, 0))
        from ..symbol import zeros
        pl = pred_lengths if pred_lengths is not None else zeros((1,))
        ll = label_lengths if label_lengths is not None else zeros((1,))
        return F.CTCLoss(p, lab, pl, ll, blank_label="last",
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None)

    def _eager(self, pred, label, pred_lengths, label_lengths):
        from ..ops.ctc import ctc_nll
        with torch.set_grad_enabled(autograd.is_recording()):
            logits = pred._data
            labels = label._data.to(torch.int64)
            if self._layout == "TNC":
                logits = logits.transpose(0, 1)
            if self._label_layout == "TN":
                labels = labels.t()
            b, t, c = logits.shape
            dev = logits.device
            if pred_lengths is None:
                logit_pad = torch.zeros(b, t, device=dev)
            else:
                logit_pad = (torch.arange(t, device=dev).unsqueeze(0)
                             >= pred_lengths._data.reshape(b, 1)).float()
            if label_lengths is None:
                label_pad = (labels < 0).float()
            else:
                label_pad = (torch.arange(labels.shape[1], device=dev)
                             .unsqueeze(0)
                             >= label_lengths._data.reshape(b, 1)).float()
            return NDArray(ctc_nll(logits, logit_pad, labels.clamp_min(0),
                                   label_pad, c - 1))


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + F.Activation(
            -F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = F.reshape_like(input1, input2)
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = F.reshape_like(label, cos)
        # ``label == 1`` is identity, not a node, on a Symbol
        loss = F.where(F._equal_scalar(label, scalar=1.0), 1 - cos,
                       F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)

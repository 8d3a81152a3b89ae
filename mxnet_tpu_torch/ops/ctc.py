"""Connectionist temporal classification loss.

Counterpart of ``mxnet_tpu/ops/ctc.py`` (reference
``src/operator/nn/ctc_loss.cc``): input (T, N, C), optional
``data_lengths``/``label_lengths`` inputs, ``blank_label`` ``first`` (blank
0, labels 1..C−1, padded with 0 — any label ``<= 0`` is padding) or
``last`` (blank C−1, labels 0..C−2, padded with −1). The output is each
sequence's negative log likelihood, (N,).

The JAX package computes it with ``optax.ctc_loss``; :func:`ctc_nll` is
the same log-domain recursion over the frames, batched over the rows and
the label positions, with its ``log_epsilon = −1e5`` standing for log 0.
So an alignment that cannot exist (more frames needed than given) costs
a finite ≈1e5, where ``F.ctc_loss`` gives ``inf``. The recursion runs in
float64, as optax's does under the JAX package's 64-bit mode (its
constants are float64), and so the loss is float64; the log-softmax stays
in the logits' type. The gradient is autograd's of the recursion, as
the JAX package's is ``jax.vjp`` of it.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

LOG_EPSILON = -1e5


def _logaddexp_tail(phi, added):
    """``phi`` with ``logaddexp(phi[:, 1:], added)`` in place of its tail."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)


def ctc_nll(logits, logit_pad, labels, label_pad, blank):
    """optax's ``ctc_loss``: logits (B, T, K), ``logit_pad`` (B, T) and
    ``label_pad`` (B, L) 1 where padded, int ``labels`` (B, L) right-padded;
    returns (B,) float64."""
    b, t, k = logits.shape
    lmax = labels.shape[1]
    acc = torch.promote_types(logits.dtype, torch.float64)
    logprobs = torch.log_softmax(logits, dim=-1).to(acc)
    label_pad = label_pad.to(acc)
    logit_pad = logit_pad.to(acc)
    labellens = lmax - label_pad.sum(dim=1).to(torch.int64)
    repeat = torch.zeros(b, lmax, dtype=acc, device=logits.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(acc)
    # jax.nn.one_hot of a label outside [0, K) is a zero row
    inside = (labels >= 0) & (labels < k)
    emit = torch.gather(logprobs, 2, labels.clamp(0, k - 1).unsqueeze(1)
                        .expand(b, t, lmax))
    emit = torch.where(inside.unsqueeze(1), emit, torch.zeros_like(emit))
    emit = emit.transpose(0, 1)                               # (T, B, L)
    phi_lp = logprobs[:, :, blank:blank + 1].transpose(0, 1)  # (T, B, 1)
    pads = logit_pad.transpose(0, 1).unsqueeze(-1)            # (T, B, 1)
    skip_emit = LOG_EPSILON * repeat
    skip_phi = LOG_EPSILON * (1.0 - repeat)

    phi = torch.full((b, lmax + 1), LOG_EPSILON, dtype=acc,
                     device=logits.device)
    phi[:, 0] = 0.0
    prev_emit = torch.full((b, lmax), LOG_EPSILON, dtype=acc,
                           device=logits.device)
    for step in range(t):
        orig_phi = phi
        # emit-to-phi epsilon transition, except before a repeated label
        phi = _logaddexp_tail(phi, prev_emit + skip_emit)
        e, p, pad = emit[step], phi_lp[step], pads[step]
        next_emit = torch.logaddexp(phi[:, :-1] + e, prev_emit + e)
        # self-loop, and emit-to-phi through a blank before a repetition
        next_phi = _logaddexp_tail(phi + p, prev_emit + p + skip_phi)
        prev_emit = pad * prev_emit + (1.0 - pad) * next_emit
        phi = pad * orig_phi + (1.0 - pad) * next_phi
    last = _logaddexp_tail(phi, prev_emit)
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)


def _positions_from(lengths, n, size, device):
    """1.0 at positions at or after each row's length."""
    pos = torch.arange(size, device=device).unsqueeze(0)
    return (pos >= lengths.reshape(n, 1)).to(torch.float32)


@register("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"],
          arg_names=("data", "label", "data_lengths", "label_lengths"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    t, n, c = data.shape
    logits = data.transpose(0, 1)
    labels = label.to(torch.int64)
    if labels.ndim != 2 or labels.shape[0] != n:
        raise MXNetError(f"CTC label shape {tuple(labels.shape)} != "
                         f"(batch, max_len)")
    if use_data_lengths and data_lengths is not None:
        logit_pad = _positions_from(data_lengths, n, t, data.device)
    else:
        logit_pad = torch.zeros(n, t, device=data.device)
    blank_first = blank_label == "first"
    if use_label_lengths and label_lengths is not None:
        pad_mask = _positions_from(label_lengths, n, labels.shape[1],
                                   data.device) > 0
    else:
        pad_mask = (labels <= 0) if blank_first else (labels < 0)
    labels = labels.masked_fill(pad_mask, 0)
    return ctc_nll(logits, logit_pad, labels, pad_mask,
                   0 if blank_first else c - 1)

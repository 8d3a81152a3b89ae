"""The fused multi-layer ``RNN`` op: LSTM, GRU and vanilla (relu, tanh).

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference ``src/operator/rnn.cc``
/ ``rnn-inl.h``), in the same form: one matrix product projects every time
step's input at once, then each step does one ``(B, H)·(H, G·H)`` product
and the gate arithmetic, in a Python loop that torch autograd records (XLA
lowered the JAX package's ``lax.scan``; cuBLAS runs these products). The
same code runs on the CPU and on the card.

The packed parameter vector is the reference's: every i2h and h2h weight,
layer-major and direction-minor, then every bias in the same order. Gate
order ``[i, f, g, o]`` for the LSTM and ``[r, z, n]`` for the GRU, with
``r`` multiplying ``W_hn·h + b_hn``. ``RNN`` slices the vector into views
(no copy); the gluon layers hand :func:`rnn_forward` their per-layer
parameters directly, so that nothing is packed.

As in the JAX package: a ``(1, H)`` initial state is broadcast to the
batch; dropout falls between layers, not after the last, drawn from the
op's ``torch.Generator``; ``lstm_state_clip_min``/``max`` clip only the
final cell state; ``projection_size`` and ``use_sequence_length`` are
accepted and ignored.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["rnn_forward", "rnn_packed_param_size", "unpack_params"]

_GATES = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}


def rnn_packed_param_size(mode, num_layers, bidirectional, input_size, H):
    """The length of the packed parameter vector."""
    G = _GATES[mode]
    dirs = 2 if bidirectional else 1
    n = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * dirs
        n += dirs * (G * H * in_sz + G * H * H)
    return n + num_layers * dirs * 2 * G * H


def unpack_params(params, mode, num_layers, dirs, input_size, H):
    """Views of the packed vector: ``[(wih, whh, bih, bhh)]`` for each
    layer and direction, in that order."""
    G = _GATES[mode]
    ws, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * dirs
        for _ in range(dirs):
            wih = params[off:off + G * H * in_sz].view(G * H, in_sz)
            off += G * H * in_sz
            whh = params[off:off + G * H * H].view(G * H, H)
            off += G * H * H
            ws.append((wih, whh))
    out = []
    for wih, whh in ws:
        bih = params[off:off + G * H]
        bhh = params[off + G * H:off + 2 * G * H]
        off += 2 * G * H
        out.append((wih, whh, bih, bhh))
    if off != params.shape[0]:
        raise MXNetError(f"RNN: {params.shape[0]} parameters, the layout "
                         f"needs {off}")
    return out


def _lstm_step(xt, h, c, whh_t):
    gates = torch.addmm(xt, h, whh_t)
    i, f, g, o = gates.chunk(4, 1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_step(xt, h, whh_t, bhh):
    hh = torch.addmm(bhh, h, whh_t)
    H = h.shape[1]
    r, z = torch.sigmoid(xt[:, :2 * H] + hh[:, :2 * H]).chunk(2, 1)
    n = torch.tanh(xt[:, 2 * H:] + r * hh[:, 2 * H:])
    return (1 - z) * n + z * h


def _run_layer(x, mode, wih, whh, bih, bhh, h, c, reverse):
    """One direction of one layer over ``x`` (T, B, I): the outputs (T, B,
    H) and the final ``h`` and ``c``. The reverse direction walks the steps
    backwards and writes each output at its own step."""
    T, B = x.shape[0], x.shape[1]
    if h.shape[0] == 1 and B != 1:
        h = h.expand(B, h.shape[1])
    if c is not None and c.shape[0] == 1 and B != 1:
        c = c.expand(B, c.shape[1])
    # the GRU's h2h bias stays apart: r multiplies W_hn·h + b_hn
    bias = bih if mode == "gru" else bih + bhh
    xp = torch.addmm(bias, x.reshape(T * B, -1), wih.t()).view(T, B, -1)
    whh_t = whh.t()
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "lstm":
            h, c = _lstm_step(xp[t], h, c, whh_t)
        elif mode == "gru":
            h = _gru_step(xp[t], h, whh_t, bhh)
        else:
            h = act(torch.addmm(xp[t], h, whh_t))
        outs[t] = h
    return torch.stack(outs), h, c


def rnn_forward(data, weights, state, state_cell=None, mode="lstm",
                bidirectional=False, p=0.0, rng=None, is_train=True,
                state_outputs=False, lstm_state_clip_min=None,
                lstm_state_clip_max=None):
    """The recurrence over ``data`` (T, B, I) with ``weights`` a list of
    ``(wih, whh, bih, bhh)`` for each layer and direction and ``state``
    (and the LSTM's ``state_cell``) of shape (layers·dirs, B or 1, H).
    Returns the output (T, B, dirs·H), with ``state_outputs`` also ``hn``
    (and the LSTM's ``cn``)."""
    if mode not in _GATES:
        raise MXNetError(f"bad RNN mode {mode}")
    dirs = 2 if bidirectional else 1
    L = len(weights) // dirs
    x = data
    hn, cn = [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            c0 = state_cell[idx] if mode == "lstm" else None
            out, h, c = _run_layer(x, mode, *weights[idx], state[idx], c0,
                                   reverse=d == 1)
            outs.append(out)
            hn.append(h)
            cn.append(c)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and is_train and rng is not None and layer < L - 1:
            keep = 1.0 - p
            mask = torch.empty_like(x).bernoulli_(keep, generator=rng)
            x = x * (mask / keep)
    if not state_outputs:
        return x
    hn = torch.stack(hn)
    if mode != "lstm":
        return x, hn
    cn = torch.stack(cn)
    if lstm_state_clip_min is not None:
        cn = torch.clamp(cn, lstm_state_clip_min, lstm_state_clip_max)
    return x, hn, cn


def _rnn_nout(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_nout,
          arg_names=("data", "parameters", "state", "state_cell"),
          needs_rng=True)
def _rnn(data, parameters, state, state_cell=None, state_size=0,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None, use_sequence_length=False,
         sequence_length=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False, rng=None,
         is_train=True):
    """``data`` (T, B, I), ``state`` (layers·dirs, B, H), the packed
    ``parameters`` in the reference's layout."""
    if mode not in _GATES:
        raise MXNetError(f"bad RNN mode {mode}")
    dirs = 2 if bidirectional else 1
    weights = unpack_params(parameters, mode, int(num_layers), dirs,
                            data.shape[2], int(state_size))
    return rnn_forward(data, weights, state, state_cell, mode=mode,
                       bidirectional=bidirectional, p=float(p), rng=rng,
                       is_train=is_train, state_outputs=state_outputs,
                       lstm_state_clip_min=lstm_state_clip_min,
                       lstm_state_clip_max=lstm_state_clip_max)

"""Speech recognition with CTC on ``mxnet_tpu_torch``, the PyTorch port:
the twin of ``speech_ctc.py`` beside it, with the same ``make_data``,
``AcousticModel`` (a conv front end over spectrogram-like frames feeding a
bidirectional GRU), ``greedy_decode``, ``phone_error_rate`` and ``train``
(``gluon.loss.CTCLoss`` over unaligned label sequences). It runs on the
card (``gpu(0)``) unless ``--cpu`` is given or ``train`` is passed
``ctx=mx.cpu()``.

Run: python example/speech_recognition/speech_ctc_torch.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn

PHONES = 5            # phoneme alphabet (blank = PHONES, gluon 'last')
FRAMES_PER = 6        # frames per phoneme occurrence
N_MEL = 12            # feature bins per frame
MAX_PHONES = 4
T = MAX_PHONES * FRAMES_PER


def _phone_frames(p, rng):
    """Each phoneme = a characteristic spectral envelope + noise."""
    freqs = np.linspace(0, np.pi, N_MEL)
    env = np.cos(freqs * (p + 1)) + 0.5 * np.sin(freqs * (p + 2))
    return env[None, :] + 0.15 * rng.randn(FRAMES_PER, N_MEL)


def make_data(rng, n=256):
    xs = np.zeros((n, T, N_MEL), "float32")
    ys = np.full((n, MAX_PHONES), -1.0, "float32")      # -1 = pad
    for i in range(n):
        k = rng.randint(2, MAX_PHONES + 1)
        seq = rng.randint(0, PHONES, k)
        ys[i, :k] = seq
        t = 0
        for p in seq:
            xs[i, t:t + FRAMES_PER] = _phone_frames(int(p), rng)
            t += FRAMES_PER
        # silence tail
        xs[i, t:] = 0.05 * rng.randn(T - t, N_MEL)
    return xs, ys


class AcousticModel(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.conv = nn.Conv2D(8, kernel_size=(3, 3), padding=(1, 1),
                              activation="relu")
        self.rnn = gluon.rnn.GRU(32, layout="NTC", bidirectional=True)
        self.head = nn.Dense(PHONES + 1, flatten=False)   # + blank

    def forward(self, x):                   # (B, T, M)
        h = self.conv(mx.nd.expand_dims(x, axis=1))       # (B, 8, T, M)
        h = mx.nd.transpose(h, axes=(0, 2, 1, 3))         # (B, T, 8, M)
        h = h.reshape((h.shape[0], h.shape[1], -1))       # (B, T, 8M)
        return self.head(self.rnn(h))                     # (B, T, P+1)


def greedy_decode(logits):
    """argmax -> collapse repeats -> drop blanks (id PHONES)."""
    ids = logits.argmax(-1)
    out = []
    for row in ids:
        seq, prev = [], -1
        for t in row:
            if t != prev and t != PHONES:
                seq.append(int(t))
            prev = t
        out.append(seq)
    return out


def phone_error_rate(model, x, y, ctx=None):
    logits = model(mx.nd.array(x, ctx=ctx)).asnumpy()
    total = errs = 0
    for pred, truth in zip(greedy_decode(logits), y):
        t = [int(v) for v in truth if v >= 0]
        # edit distance
        d = np.zeros((len(pred) + 1, len(t) + 1), int)
        d[:, 0] = np.arange(len(pred) + 1)
        d[0, :] = np.arange(len(t) + 1)
        for a in range(1, len(pred) + 1):
            for b in range(1, len(t) + 1):
                d[a, b] = min(d[a - 1, b] + 1, d[a, b - 1] + 1,
                              d[a - 1, b - 1] + (pred[a - 1] != t[b - 1]))
        errs += d[-1, -1]
        total += len(t)
    return errs / max(total, 1)


def train(epochs=16, batch_size=32, lr=0.01, seed=0, verbose=True, ctx=None,
          losses=None):
    """Returns (first_per, last_per): phone error rate (1.0 = everything
    wrong, 0 = perfect transcripts); ``losses``, a list, receives every
    step's loss. ``ctx`` defaults to the card."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x, y = make_data(rng)
    model = AcousticModel()
    model.initialize(mx.init.Xavier(), ctx=ctx)
    ctc = gluon.loss.CTCLoss()
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": lr})
    first = phone_error_rate(model, x, y, ctx)
    for _ in range(epochs):
        for i in range(0, len(x), batch_size):
            xb = mx.nd.array(x[i:i + batch_size], ctx=ctx)
            yb = mx.nd.array(y[i:i + batch_size], ctx=ctx)
            with autograd.record():
                loss = mx.nd.mean(ctc(model(xb), yb))
            loss.backward()
            trainer.step(1)
            if losses is not None:
                losses.append(float(loss.asnumpy()))
    last = phone_error_rate(model, x, y, ctx)
    if verbose:
        print(f"phone error rate: {first:.3f} -> {last:.3f}")
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(ctx=mx.cpu() if args.cpu else mx.gpu(0))

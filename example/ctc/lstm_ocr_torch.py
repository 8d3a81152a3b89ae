"""LSTM + CTC sequence recognition on ``mxnet_tpu_torch``, the PyTorch
port: the twin of ``lstm_ocr.py`` beside it, with the same
``synth_batch``, ``OCRNet``, ``greedy_decode`` and ``train`` (read a
digit string off a synthetic 'image' whose columns encode the digits,
trained with ``gluon.loss.CTCLoss``). It runs on the card (``gpu(0)``)
unless ``--cpu`` is given or ``train`` is passed ``ctx=mx.cpu()``.

Run: python example/ctc/lstm_ocr_torch.py [--epochs 4] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn, rnn

N_CLASSES = 10          # digits; CTC blank is index N_CLASSES
SEQ_LEN = 12            # image columns
LABEL_LEN = 4           # digits per image
FEAT = 16               # rows per column


def synth_batch(rng, batch):
    """Each digit paints a distinctive column pattern; the net must learn
    the column->digit mapping and CTC collapses repeats."""
    basis = np.eye(10, FEAT, dtype="float32")  # digit d -> one-hot-ish row
    basis += 0.1 * np.random.RandomState(0).randn(10, FEAT).astype("float32")
    xs = np.zeros((batch, SEQ_LEN, FEAT), "float32")
    ys = np.zeros((batch, LABEL_LEN), "float32")
    for b in range(batch):
        digits = rng.randint(0, 10, LABEL_LEN)
        ys[b] = digits
        # each digit occupies 3 columns
        for i, d in enumerate(digits):
            xs[b, 3 * i:3 * i + 3] = basis[d]
    xs += 0.05 * rng.randn(*xs.shape).astype("float32")
    return xs, ys


class OCRNet(gluon.Block):
    def __init__(self, hidden=48, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.lstm = rnn.LSTM(hidden, layout="NTC")
            self.proj = nn.Dense(N_CLASSES + 1, flatten=False)

    def forward(self, x):
        return self.proj(self.lstm(x))      # (B, T, classes+1)


def greedy_decode(logits):
    """Collapse repeats, drop blanks (best-path CTC decoding)."""
    ids = logits.argmax(-1)
    out = []
    for row in ids:
        prev = -1
        s = []
        for t in row:
            if t != prev and t != N_CLASSES:
                s.append(int(t))
            prev = t
        out.append(s)
    return out


def train(epochs=4, batch=64, steps_per_epoch=20, verbose=True, ctx=None,
          losses=None):
    """Returns (first epoch's mean loss, last epoch's, exact-match
    accuracy); ``losses``, a list, receives every step's mean loss.
    ``ctx`` defaults to the card."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(7)
    mx.random.seed(0)   # reproducible runs (and stable CI gates)
    net = OCRNet()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    ctc = gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 5e-3})
    first = last = None
    for epoch in range(epochs):
        total = 0.0
        for _ in range(steps_per_epoch):
            xs, ys = synth_batch(rng, batch)
            x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
            with autograd.record():
                loss = ctc(net(x), y)
            loss.backward()
            trainer.step(batch)
            step_loss = float(loss.mean().asnumpy())
            if losses is not None:
                losses.append(step_loss)
            total += step_loss
        total /= steps_per_epoch
        if first is None:
            first = total
        last = total
        if verbose:
            print(f"epoch {epoch}: ctc loss {total:.3f}")
    # exact-match accuracy on a fresh batch
    xs, ys = synth_batch(rng, 64)
    decoded = greedy_decode(net(mx.nd.array(xs, ctx=ctx)).asnumpy())
    acc = np.mean([d == list(map(int, y)) for d, y in zip(decoded, ys)])
    if verbose:
        print(f"sequence exact-match accuracy: {acc:.2f}")
    return first, last, acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

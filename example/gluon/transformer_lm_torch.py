"""Character-level transformer language model on ``mxnet_tpu_torch``, the
PyTorch port: the twin of ``transformer_lm.py`` beside it, with the same
``synth_batch`` and ``train`` over ``gluon.contrib.transformer`` (the
flash-attention kernels on the card). It runs on the card (``gpu(0)``)
unless ``--cpu`` is given or ``train`` is passed ``ctx=mx.cpu()``.

Data: a synthetic grammar (digits cycling with fixed period) the model must
memorize — loss collapsing toward 0 proves the causal stack learns position-
dependent structure.

Run: python example/gluon/transformer_lm_torch.py [--epochs 3] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.contrib import transformer as tfm

VOCAB = 16
SEQ = 32


def synth_batch(rng, batch):
    """Deterministic periodic sequences with a random phase: next token is
    (prev + step) % VOCAB where step depends on the phase parity."""
    xs = np.zeros((batch, SEQ + 1), "int64")
    for b in range(batch):
        phase = rng.randint(0, VOCAB)
        step = 1 + (phase % 3)
        xs[b] = (phase + step * np.arange(SEQ + 1)) % VOCAB
    return xs[:, :-1].astype("float32"), xs[:, 1:].astype("float32")


def train(epochs=3, batch=32, steps_per_epoch=30, verbose=True, ctx=None,
          losses=None):
    """Returns (first epoch's mean loss, last epoch's, next-token
    accuracy); ``losses``, a list, receives every step's loss. ``ctx``
    defaults to the card."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(3)
    mx.random.seed(0)   # reproducible runs (and stable CI gates)
    net = tfm.TransformerLM(vocab_size=VOCAB, units=64, num_layers=2,
                            num_heads=4, max_len=SEQ)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    first = last = None
    for epoch in range(epochs):
        total = 0.0
        for _ in range(steps_per_epoch):
            x, y = synth_batch(rng, batch)
            xd, yd = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
            with autograd.record():
                logits = net(xd)                      # (B, T, V)
                loss = loss_fn(logits.reshape((-1, VOCAB)),
                               yd.reshape((-1,)))
            loss.backward()
            trainer.step(batch * SEQ)
            step_loss = float(loss.mean().asnumpy())
            if losses is not None:
                losses.append(step_loss)
            total += step_loss
        total /= steps_per_epoch
        first = first if first is not None else total
        last = total
        if verbose:
            print(f"epoch {epoch}: ce {total:.3f} (ppl {np.exp(total):.1f})")
    # next-token accuracy on fresh data
    x, y = synth_batch(rng, 64)
    pred = net(mx.nd.array(x, ctx=ctx)).asnumpy().argmax(-1)
    acc = (pred[:, 4:] == y[:, 4:]).mean()   # skip the ambiguous warmup
    if verbose:
        print(f"next-token accuracy (t>=4): {acc:.2f}")
    return first, last, acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

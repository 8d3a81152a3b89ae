"""Capsule network with dynamic routing on ``mxnet_tpu_torch``, the PyTorch
port: the twin of ``capsnet.py`` beside it, with the same ``squash``,
``CapsNet``, ``route``, ``margin_loss``, ``make_data`` and ``train``
(Sabour et al. 2017 shrunk to a synthetic quadrant task: three routing
iterations unrolled, the squash nonlinearity, the margin loss, trained
through gluon autograd and Adam).

``CapsNet`` takes the widths as keyword arguments whose defaults are the
recipe's; ``chip_smoke.build_capsnet`` builds the paper's widths from
it. A primary capsule is ``pdim`` consecutive channels of one of
``primary`` capsule types at one place of the primary convolution's
output (one place at the recipe's widths). ``train`` runs on the current
context (the card, ``gpu(0)``, unless the caller asks for the CPU:
``ctx=mx.cpu()`` or ``--cpu``); cuDNN runs its convolutions, cuBLAS its
``batch_dot``, and no hand-written kernel is on its path.

Run: python example/capsnet/capsnet_torch.py [--epochs 10] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn

SIDE = 12
CLASSES = 4
PRIMARY = 16     # number of primary capsule types
PDIM = 4         # primary capsule dim
DDIM = 8         # class capsule dim


def squash(s, axis=-1):
    n2 = mx.nd.sum(mx.nd.square(s), axis=axis, keepdims=True)
    return (n2 / (1.0 + n2)) * s / mx.nd.sqrt(n2 + 1e-9)


class CapsNet(gluon.HybridBlock):
    """conv -> PrimaryCaps -> prediction vectors u_hat (the routing input).

    The per-(capsule, class) transform W is a raw gluon Parameter
    (capsules, pdim, classes * ddim); u_hat is one ``batch_dot``."""

    def __init__(self, channels=16, kernel=5, stride=2, primary=PRIMARY,
                 pdim=PDIM, primary_kernel=3, primary_stride=2,
                 capsules=PRIMARY, classes=CLASSES, ddim=DDIM, **kw):
        super().__init__(**kw)
        self._caps = (primary, pdim, capsules, classes, ddim)
        with self.name_scope():
            self.conv = nn.Conv2D(channels, kernel, strides=stride,
                                  activation="relu")
            self.primary = nn.Conv2D(primary * pdim, primary_kernel,
                                     strides=primary_stride)
            self.uhat_weight = self.params.get(
                "uhat_weight", shape=(capsules, pdim, classes * ddim),
                init=mx.init.Xavier())

    def hybrid_forward(self, F, x, uhat_weight):
        primary, pdim, capsules, classes, ddim = self._caps
        h = self.conv(x)
        p = self.primary(h)                          # (B, P*PD, H, W)
        # (B, P, PD, H*W) -> (B, P, H*W, PD) -> (B, capsules, PD)
        u = F.reshape(p, shape=(0, -4, primary, pdim, -3))
        u = F.reshape(F.transpose(u, axes=(0, 1, 3, 2)),
                      shape=(-1, capsules, pdim))
        n2 = F.sum(F.square(u), axis=2, keepdims=True)
        u = (n2 / (1.0 + n2)) * u / F.sqrt(n2 + 1e-9)  # squash
        ut = F.transpose(u, axes=(1, 0, 2))          # (caps, B, PD)
        u_hat = F.batch_dot(ut, uhat_weight)         # (caps, B, C*D)
        u_hat = F.transpose(u_hat, axes=(1, 0, 2))   # (B, caps, C*D)
        return F.reshape(u_hat, shape=(-1, capsules, classes, ddim))


def route(u_hat, iters=3):
    """Dynamic routing: coupling logits b start at 0; three agreement
    updates (static unroll)."""
    b_ij = mx.nd.zeros(u_hat.shape[:3], ctx=u_hat.context,
                       dtype=u_hat.dtype)             # (B, caps, C)
    for _ in range(iters):
        c = mx.nd.softmax(b_ij, axis=2)               # couplings
        s = mx.nd.sum(mx.nd.expand_dims(c, axis=3) * u_hat, axis=1)
        v = squash(s)                                 # (B, C, D)
        agree = mx.nd.sum(u_hat * mx.nd.expand_dims(v, axis=1), axis=3)
        b_ij = b_ij + agree
    return v


def margin_loss(v, label):
    """L = T max(0, .9-|v|)^2 + .5 (1-T) max(0, |v|-.1)^2, over the
    ``v.shape[1]`` classes."""
    lengths = mx.nd.sqrt(mx.nd.sum(mx.nd.square(v), axis=2) + 1e-9)
    t = mx.nd.one_hot(label, v.shape[1])
    pos = mx.nd.square(mx.nd.maximum(0.9 - lengths, 0.0))
    neg = mx.nd.square(mx.nd.maximum(lengths - 0.1, 0.0))
    return mx.nd.mean(mx.nd.sum(t * pos + 0.5 * (1 - t) * neg, axis=1))


def make_data(rng, n=256):
    """One bright quadrant per class (same family as the adversary task)."""
    x = rng.uniform(0, 0.3, (n, 1, SIDE, SIDE)).astype("float32")
    y = rng.randint(0, CLASSES, (n,))
    h = SIDE // 2
    for i, c in enumerate(y):
        r, col = divmod(int(c), 2)
        x[i, 0, r * h:(r + 1) * h, col * h:(col + 1) * h] += 0.6
    return x, y.astype("float32")


def train(epochs=10, batch_size=32, lr=0.003, seed=0, verbose=True,
          ctx=None):
    """Returns (first_acc, last_acc): capsule-length classification."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x, y = make_data(rng)
    net = CapsNet()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def accuracy():
        v = route(net(mx.nd.array(x, ctx=ctx)))
        lengths = mx.nd.sqrt(mx.nd.sum(mx.nd.square(v), axis=2))
        return (lengths.asnumpy().argmax(axis=1) == y).mean()

    first = accuracy()
    for _ in range(epochs):
        for i in range(0, len(x), batch_size):
            xb = mx.nd.array(x[i:i + batch_size], ctx=ctx)
            yb = mx.nd.array(y[i:i + batch_size], ctx=ctx)
            with autograd.record():
                v = route(net(xb))
                loss = margin_loss(v, yb)
            loss.backward()
            trainer.step(len(xb))
    last = accuracy()
    if verbose:
        print(f"capsnet accuracy: {first:.3f} -> {last:.3f}")
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

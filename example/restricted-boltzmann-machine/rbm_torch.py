"""Binary restricted Boltzmann machine trained with CD-1 on
``mxnet_tpu_torch``, the PyTorch port: the twin of ``rbm.py`` beside it,
with the same ``make_patterns``, ``BinaryRBM`` and ``train`` (contrastive
divergence without autograd: Gibbs samples from
``mx.nd.random_uniform``, drawn from the generator of the current
context's device, and raw NDArray arithmetic). ``train`` runs on the
current context (the card, ``gpu(0)``, unless the caller asks for the
CPU: ``ctx=mx.cpu()`` or ``--cpu``); no hand-written kernel is on its
path.

Run: python example/restricted-boltzmann-machine/rbm_torch.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx


def make_patterns(rng, n=512, dim=24, n_proto=4, flip=0.05):
    """Noisy copies of a few binary prototype vectors."""
    protos = (rng.rand(n_proto, dim) > 0.5).astype("float32")
    idx = rng.randint(0, n_proto, n)
    x = protos[idx].copy()
    noise = rng.rand(n, dim) < flip
    x[noise] = 1.0 - x[noise]
    return x.astype("float32")


class BinaryRBM:
    def __init__(self, n_visible, n_hidden, seed=0, ctx=None):
        rng = np.random.RandomState(seed)
        self.w = mx.nd.array(0.1 * rng.randn(n_visible, n_hidden), ctx=ctx)
        self.bv = mx.nd.zeros((n_visible,), ctx=ctx)
        self.bh = mx.nd.zeros((n_hidden,), ctx=ctx)

    def prop_up(self, v):
        return mx.nd.sigmoid(mx.nd.dot(v, self.w) + self.bh)

    def prop_down(self, h):
        return mx.nd.sigmoid(mx.nd.dot(h, self.w.T) + self.bv)

    def sample(self, p):
        return (mx.nd.random_uniform(shape=p.shape, ctx=p.context) < p
                ).astype("float32")

    def cd1_update(self, v0, lr):
        """One CD-1 step: <v h>_data - <v h>_model."""
        ph0 = self.prop_up(v0)
        h0 = self.sample(ph0)
        pv1 = self.prop_down(h0)
        v1 = self.sample(pv1)
        ph1 = self.prop_up(v1)
        n = v0.shape[0]
        self.w += (lr / n) * (mx.nd.dot(v0.T, ph0) - mx.nd.dot(v1.T, ph1))
        self.bv += lr * mx.nd.mean(v0 - v1, axis=0)
        self.bh += lr * mx.nd.mean(ph0 - ph1, axis=0)

    def recon_error(self, v):
        return float(mx.nd.mean(
            mx.nd.square(v - self.prop_down(self.prop_up(v)))).asnumpy())


def train(epochs=30, batch_size=64, n_hidden=16, lr=0.1, seed=0,
          verbose=True, ctx=None):
    """Returns (first_err, last_err): mean squared reconstruction error."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x = make_patterns(rng)
    rbm = BinaryRBM(x.shape[1], n_hidden, seed=seed, ctx=ctx)
    xa = mx.nd.array(x, ctx=ctx)
    first = rbm.recon_error(xa)
    for _ in range(epochs):
        for i in range(0, len(x), batch_size):
            rbm.cd1_update(mx.nd.array(x[i:i + batch_size], ctx=ctx), lr)
    last = rbm.recon_error(xa)
    if verbose:
        print(f"reconstruction error: {first:.4f} -> {last:.4f}")
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

"""Variational autoencoder on ``mxnet_tpu_torch``, the PyTorch port: the
twin of ``vae.py`` beside it, with the same ``VAE``, ``elbo_loss``,
``make_data`` and ``train`` (the reparameterization trick inside
``autograd.record``: ``mx.nd.random_normal`` draws from the generator of
the current context's device, and the gradient flows through
``mu + eps * sigma``; a reconstruction plus analytic Gaussian KL loss).
``train`` runs on the current context (the card, ``gpu(0)``, unless the
caller asks for the CPU: ``ctx=mx.cpu()`` or ``--cpu``); no hand-written
kernel is on its path.

Run: python example/vae/vae_torch.py [--epochs 30] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn


class VAE(gluon.HybridBlock):
    def __init__(self, n_latent=4, n_hidden=64, n_out=32, **kw):
        super().__init__(**kw)
        self.encoder = nn.HybridSequential()
        self.encoder.add(nn.Dense(n_hidden, activation="relu"),
                         nn.Dense(2 * n_latent))    # [mu | logvar]
        self.decoder = nn.HybridSequential()
        self.decoder.add(nn.Dense(n_hidden, activation="relu"),
                         nn.Dense(n_out))
        self.n_latent = n_latent

    def forward(self, x):
        h = self.encoder(x)
        mu = mx.nd.slice_axis(h, axis=1, begin=0, end=self.n_latent)
        logvar = mx.nd.slice_axis(h, axis=1, begin=self.n_latent,
                                  end=2 * self.n_latent)
        eps = mx.nd.random_normal(shape=mu.shape, ctx=mu.context)
        z = mu + eps * mx.nd.exp(0.5 * logvar)       # reparameterization
        return self.decoder(z), mu, logvar


def elbo_loss(recon, x, mu, logvar):
    """-ELBO: squared-error reconstruction + analytic N(mu,sigma)||N(0,1) KL."""
    rec = mx.nd.sum(mx.nd.square(recon - x), axis=1)
    kl = -0.5 * mx.nd.sum(1 + logvar - mx.nd.square(mu) - mx.nd.exp(logvar),
                          axis=1)
    return mx.nd.mean(rec + kl)


def make_data(rng, n=512, dim=32, n_modes=3):
    """A low-dimensional manifold: random 2D latents through a fixed map."""
    z = rng.randn(n, 2)
    w = rng.randn(2, dim)
    x = np.tanh(z @ w) + 0.05 * rng.randn(n, dim)
    return x.astype("float32")


def train(epochs=30, batch_size=64, lr=0.003, seed=0, verbose=True,
          ctx=None):
    """Returns (first_loss, last_loss): -ELBO over the data."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x = make_data(rng)
    net = VAE()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def total_loss():
        xa = mx.nd.array(x, ctx=ctx)
        recon, mu, logvar = net(xa)
        return float(elbo_loss(recon, xa, mu, logvar).asnumpy())

    first = total_loss()
    for _ in range(epochs):
        for i in range(0, len(x), batch_size):
            xb = mx.nd.array(x[i:i + batch_size], ctx=ctx)
            with autograd.record():
                recon, mu, logvar = net(xb)
                loss = elbo_loss(recon, xb, mu, logvar)
            loss.backward()
            trainer.step(1)
    last = total_loss()
    if verbose:
        print(f"-ELBO: {first:.2f} -> {last:.2f}")
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

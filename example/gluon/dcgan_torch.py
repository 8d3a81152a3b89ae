"""DCGAN on ``mxnet_tpu_torch``, the PyTorch port: the twin of ``dcgan.py``
beside it, with the same ``build_generator``, ``build_discriminator``,
``real_batch`` and ``train`` (transposed-conv generator against a
strided-conv discriminator on synthetic two-blob images, Adam with β1 0.5,
``SigmoidBinaryCrossEntropyLoss``). It runs on the card (``gpu(0)``) unless
``--cpu`` is given or ``train`` is passed ``ctx=mx.cpu()``; cuDNN runs its
convolutions, and no hand-written kernel is on its path.

Run: python example/gluon/dcgan_torch.py [--epochs 2] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn


def build_generator(ngf=16, nc=1):
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        # latent (B, nz, 1, 1) -> (B, nc, 16, 16)
        net.add(nn.Conv2DTranspose(ngf * 2, 4, 1, 0, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(ngf, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False))
        net.add(nn.Activation("tanh"))
    return net


def build_discriminator(ndf=16):
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(ndf * 2, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return net


def real_batch(rng, batch, size=16):
    """Two gaussian blobs — enough structure for D to learn quickly."""
    y, x = np.mgrid[0:size, 0:size].astype("float32") / size
    imgs = []
    for _ in range(batch):
        cx, cy = rng.uniform(0.25, 0.75, 2)
        blob = np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / 0.02))
        imgs.append(blob * 2 - 1)
    return np.stack(imgs)[:, None].astype("float32")


def train(epochs=2, batch=32, nz=16, steps_per_epoch=12, verbose=True,
          ctx=None):
    """Returns (netG, netD, [(errD, errG) a step]); ``ctx`` defaults to
    the card."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(0)
    mx.random.seed(0)   # reproducible runs (and stable CI gates)
    netG, netD = build_generator(), build_discriminator()
    netG.initialize(mx.init.Normal(0.02), ctx=ctx)
    netD.initialize(mx.init.Normal(0.02), ctx=ctx)
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trG = gluon.Trainer(netG.collect_params(), "adam",
                        {"learning_rate": 2e-3, "beta1": 0.5})
    trD = gluon.Trainer(netD.collect_params(), "adam",
                        {"learning_rate": 2e-3, "beta1": 0.5})
    real_label = mx.nd.ones((batch,), ctx=ctx)
    fake_label = mx.nd.zeros((batch,), ctx=ctx)
    hist = []
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            data = mx.nd.array(real_batch(rng, batch), ctx=ctx)
            noise = mx.nd.array(rng.randn(batch, nz, 1, 1).astype("float32"),
                                ctx=ctx)
            # --- D step: maximize log D(x) + log(1 - D(G(z)))
            with autograd.record():
                out_real = netD(data).reshape((-1,))
                err_real = loss_fn(out_real, real_label)
                fake = netG(noise)
                out_fake = netD(fake.detach()).reshape((-1,))
                err_fake = loss_fn(out_fake, fake_label)
                errD = err_real + err_fake
            errD.backward()
            trD.step(batch)
            # --- G step: maximize log D(G(z))
            with autograd.record():
                out = netD(netG(noise)).reshape((-1,))
                errG = loss_fn(out, real_label)
            errG.backward()
            trG.step(batch)
            hist.append((float(errD.mean().asnumpy()),
                         float(errG.mean().asnumpy())))
        if verbose:
            d, g = hist[-1]
            print(f"epoch {epoch}: errD {d:.3f} errG {g:.3f}")
    return netG, netD, hist


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

"""Bayes by Backprop (Blundell et al. 2015) on ``mxnet_tpu_torch``, the
PyTorch port: the twin of ``bbb.py`` beside it, with the same
``BayesDense``, ``BBBNet``, ``make_data``, ``predict_mc`` and ``train``
(variational weight posteriors as raw gluon Parameters, the
reparameterized draw ``F.random_normal`` inside autograd, from the
generator of the weights' device, and a KL term against N(0, 1)).
``train`` runs on the current context (the card, ``gpu(0)``, unless the
caller asks for the CPU: ``ctx=mx.cpu()`` or ``--cpu``); no hand-written
kernel is on its path.

Run: python example/bayesian-methods/bbb_torch.py [--epochs 150] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon


class BayesDense(gluon.HybridBlock):
    """Dense layer whose weights are distributions: w ~ N(mu, softplus(rho))."""

    def __init__(self, in_units, units, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.w_mu = self.params.get("w_mu", shape=(units, in_units),
                                        init=mx.init.Xavier())
            self.w_rho = self.params.get("w_rho", shape=(units, in_units),
                                         init=mx.init.Constant(-3.0))
            self.b_mu = self.params.get("b_mu", shape=(units,),
                                        init=mx.init.Zero())
            self.b_rho = self.params.get("b_rho", shape=(units,),
                                        init=mx.init.Constant(-3.0))

    def hybrid_forward(self, F, x, w_mu, w_rho, b_mu, b_rho):
        w_sig = F.log(1.0 + F.exp(w_rho))            # softplus
        b_sig = F.log(1.0 + F.exp(b_rho))
        w = w_mu + w_sig * F.random_normal(shape=w_mu.shape,
                                           ctx=w_mu.context)
        b = b_mu + b_sig * F.random_normal(shape=b_mu.shape,
                                           ctx=b_mu.context)
        out = F.FullyConnected(x, w, b, num_hidden=w_mu.shape[0])
        # KL(N(mu, sig) || N(0, 1)), summed over weights
        kl = 0.5 * (F.sum(F.square(w_sig) + F.square(w_mu)
                          - 1.0 - 2.0 * F.log(w_sig + 1e-12))
                    + F.sum(F.square(b_sig) + F.square(b_mu)
                            - 1.0 - 2.0 * F.log(b_sig + 1e-12)))
        return out, kl


class BBBNet(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.l1 = BayesDense(1, 32)
        self.l2 = BayesDense(32, 1)

    def forward(self, x):
        h, kl1 = self.l1(x)
        h = mx.nd.relu(h)
        out, kl2 = self.l2(h)
        return out, kl1 + kl2


def make_data(rng, n=200):
    """y = sin(3x) + noise on two disjoint x clusters — the gap between
    them is where epistemic uncertainty should blow up."""
    x1 = rng.uniform(-1.0, -0.3, n // 2)
    x2 = rng.uniform(0.3, 1.0, n - n // 2)
    x = np.concatenate([x1, x2]).astype("float32").reshape(-1, 1)
    y = (np.sin(3 * x) + 0.05 * rng.randn(*x.shape)).astype("float32")
    return x, y


def predict_mc(net, x, n_samples=20, ctx=None):
    """Monte-Carlo predictive mean/std over weight draws."""
    outs = np.stack([net(mx.nd.array(x, ctx=ctx))[0].asnumpy()
                     for _ in range(n_samples)])
    return outs.mean(0), outs.std(0)


def train(epochs=150, lr=0.01, kl_weight=1e-3, seed=0, verbose=True,
          ctx=None):
    """Returns (first_mse, last_mse, mean_sigma): the model must fit the
    data while the variational posterior stays NON-degenerate — the mean
    posterior sigma must land strictly between collapse (~0: BBB
    degenerated to a point estimate) and the N(0,1) prior width (1.0:
    no data signal reached the posterior)."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x, y = make_data(rng)
    net = BBBNet()
    net.initialize(ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def mse():
        mean, _ = predict_mc(net, x, ctx=ctx)
        return float(((mean - y) ** 2).mean())

    first = mse()
    xa, ya = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    for _ in range(epochs):
        with autograd.record():
            out, kl = net(xa)
            loss = mx.nd.mean(mx.nd.square(out - ya)) + kl_weight * kl
        loss.backward()
        trainer.step(1)
    last = mse()
    # posterior health: absolute mean sigma (prior width is 1.0)
    sigmas = []
    for p in net.collect_params().values():
        if p.name.endswith("rho"):
            sigmas.append(np.log1p(np.exp(p.data().asnumpy())).mean())
    mean_sigma = float(np.mean(sigmas))
    # epistemic illustration (not asserted): predictive std on the data
    _, std_data = predict_mc(net, x, ctx=ctx)
    if verbose:
        print(f"mse {first:.4f} -> {last:.4f}; mean sigma {mean_sigma:.3f}; "
              f"mean predictive std {std_data.mean():.3f}")
    return first, last, mean_sigma


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else mx.gpu(0))

"""Post-training int8 quantization on ``mxnet_tpu_torch``, the PyTorch port:
the twin of ``quantize_mlp.py`` beside it, with the same ``make_data``,
``train_float`` and ``run`` (a small classifier trained in float, traced
to a symbol, calibrated by entropy (KL) over real batches and rewritten to
int8 by ``contrib.quantization.quantize_model``, its accuracy against the
float model's). It runs on the card (``gpu(0)``) unless ``--cpu`` is given
or ``run`` is passed ``ctx=mx.cpu()``; the int8 products run in
cuBLASLt's int8 kernels there, and no hand-written kernel is on its path.

Run: python example/quantization/quantize_mlp_torch.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.contrib import quantization
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.io import NDArrayIter


def make_data(rng, n=512, dim=16, classes=5):
    centers = rng.randn(classes, dim) * 2.0
    y = rng.randint(0, classes, (n,))
    x = centers[y] + 0.7 * rng.randn(n, dim)
    return x.astype("float32"), y.astype("float32")


def train_float(x, y, epochs=10, ctx=None):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(5))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    for _ in range(epochs):
        for i in range(0, len(x), 64):
            xb = mx.nd.array(x[i:i + 64], ctx=ctx)
            yb = mx.nd.array(y[i:i + 64], ctx=ctx)
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(len(xb))
    return net


def quantize(net, x, y, ctx):
    """The float net traced to (symbol, params) and quantized with entropy
    calibration over its first 128 examples, on ``ctx``."""
    fsym, arg_params, aux_params = quantization._trace_gluon(net)
    calib = NDArrayIter(x[:128], y[:128], 64)
    qsym, qarg, qaux = quantization.quantize_model(
        fsym, arg_params, aux_params, data_names=("data",),
        calib_mode="entropy", calib_data=calib, num_calib_examples=128,
        ctx=ctx)
    return (fsym, arg_params, aux_params), (qsym, qarg, qaux)


def accuracy(s, args, aux, x, y, ctx):
    feed = {k: v.as_in_context(ctx) for k, v in args.items()}
    feed["data"] = mx.nd.array(x, ctx=ctx)
    exe = s.bind(ctx, feed, grad_req="null", aux_states=aux or None)
    out = exe.forward()[0].asnumpy()
    return (out.argmax(axis=1) == y).mean()


def run(seed=0, verbose=True, ctx=None):
    """Returns (float_acc, int8_acc)."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x, y = make_data(rng)
    net = train_float(x, y, ctx=ctx)
    (fsym, farg, faux), (qsym, qarg, qaux) = quantize(net, x, y, ctx)
    facc = accuracy(fsym, farg, faux, x, y, ctx)
    qacc = accuracy(qsym, qarg, qaux, x, y, ctx)
    if verbose:
        print(f"float accuracy {facc:.3f}; int8 accuracy {qacc:.3f}")
    return facc, qacc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args()
    run(ctx=mx.cpu() if args.cpu else mx.gpu(0))

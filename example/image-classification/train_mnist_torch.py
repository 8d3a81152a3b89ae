#!/usr/bin/env python
"""Train on MNIST over the PyTorch port (the twin of ``train_mnist.py``;
reference: example/image-classification/train_mnist.py). Config #1:
``train_mnist_torch.py --network lenet`` (on the card; ``--gpus ''`` for
the CPU).

Looks for MNIST idx files under --data-dir; falls back to deterministic
synthetic data so the pipeline is always runnable end to end.
"""
import argparse
import importlib
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import mxnet_tpu_torch as mx
from common import fit_torch as fit


def read_data(args):
    mnist_dir = os.path.expanduser(args.data_dir)
    img = os.path.join(mnist_dir, "train-images-idx3-ubyte")
    if os.path.exists(img) or os.path.exists(img + ".gz"):
        from mxnet_tpu_torch.io import MNISTIter
        flat = args.network == "mlp"
        train = MNISTIter(image=os.path.join(mnist_dir, "train-images-idx3-ubyte"),
                          label=os.path.join(mnist_dir, "train-labels-idx1-ubyte"),
                          batch_size=args.batch_size, flat=flat)
        val = MNISTIter(image=os.path.join(mnist_dir, "t10k-images-idx3-ubyte"),
                        label=os.path.join(mnist_dir, "t10k-labels-idx1-ubyte"),
                        batch_size=args.batch_size, flat=flat)
        return train, val
    logging.warning("MNIST files not found under %s; using synthetic data",
                    mnist_dir)
    rs = np.random.RandomState(99)
    n = 2048
    x = rs.rand(n, 1, 28, 28).astype("float32")
    y = rs.randint(0, 10, n).astype("float32")
    if args.network == "mlp":
        x = x.reshape(n, -1)
    from mxnet_tpu_torch.io import NDArrayIter
    train = NDArrayIter(x[:1536], y[:1536], args.batch_size, shuffle=True)
    val = NDArrayIter(x[1536:], y[1536:], args.batch_size)
    return train, val


def get_iterators(args, kv):
    return read_data(args)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="train mnist",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--data-dir", type=str, default="~/.mxnet/datasets/mnist")
    fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", num_epochs=2, lr=0.05, batch_size=64,
                        kv_store="local")
    args = parser.parse_args()

    net_mod = importlib.import_module("symbols." + args.network + "_torch")
    sym = net_mod.get_symbol(num_classes=args.num_classes)
    fit.fit(args, sym, get_iterators)

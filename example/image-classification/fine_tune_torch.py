#!/usr/bin/env python
"""Fine-tune a checkpointed model on a new task over the PyTorch port
(the twin of ``fine_tune.py``; the modules run on the current context,
the card unless the caller is under ``mx.cpu()``) — the reference's
``example/image-classification/fine-tune.py``: load epoch N, replace the
classifier head, warm-start the trunk, train on the new task (freezing, when
wanted, is grad_req='null' / lr_mult=0 — see docs/faq/finetune.md).

    python fine_tune_torch.py --pretrained-model model --load-epoch 8 \
        --num-classes 10 [--freeze-trunk]

Runs self-contained with --demo 1: trains a small trunk on synthetic
task A, checkpoints it, then fine-tunes onto task B and prints both
accuracies (the flow tests/test_examples.py asserts on).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.module import Module


def build_sym(classes, feature_dim=48):
    data = sym.Variable("data")
    h = sym.Activation(sym.FullyConnected(data, num_hidden=64, name="fc1"),
                       act_type="relu")
    feat = sym.Activation(sym.FullyConnected(h, num_hidden=feature_dim,
                                             name="fc2"),
                          act_type="relu")
    out = sym.FullyConnected(feat, num_hidden=classes, name="fc_new")
    return sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                             name="softmax")


def make_task(rng, n=512, dim=20, classes=5, rotate=0.0,
              noise=0.8):
    """Blobs; task B = task A's centers rotated in feature space, so the
    trunk transfers but the head must re-learn."""
    centers = rng.randn(classes, dim) * 2.0
    if rotate:
        perm = np.roll(np.arange(dim), 3)
        centers = centers[:, perm] * (1 - rotate) + rng.randn(classes, dim)
    y = rng.randint(0, classes, (n,))
    x = centers[y] + noise * rng.randn(n, dim)
    return x.astype("float32"), y.astype("float32")


def fit_module(symbol, it, epochs, lr, arg_params=None):
    mod = Module(symbol, data_names=("data",),
                 label_names=("softmax_label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier(), arg_params=arg_params,
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": lr,
                                         "momentum": 0.9})
    for _ in range(epochs):
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
    return mod


def accuracy(mod, it):
    good = total = 0
    it.reset()
    for batch in it:
        mod.forward(batch, is_train=False)
        pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
        lab = batch.label[0].asnumpy()
        good += (pred == lab).sum()
        total += lab.size
    return good / total


def demo(seed=0, verbose=True):
    """Returns (trunk_warm_started, finetuned_acc): proves the checkpoint's
    trunk weights actually seeded the new module (bit-compare fc1 before
    training) and that one adaptation epoch on the re-labeled task reaches
    high held-out accuracy."""
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    centers = rng.randn(5, 20) * 2.0

    def draw(n, label_perm=None):
        y = rng.randint(0, 5, (n,))
        x = (centers[y] + 0.8 * rng.randn(n, 20)).astype("float32")
        if label_perm is not None:
            y = label_perm[y]
        return x, y.astype("float32")

    xa, ya = draw(512)
    it_a = NDArrayIter(xa, ya, 64, shuffle=True, label_name="softmax_label")

    # task B: SAME inputs, permuted class ids — features transfer fully,
    # the head must re-learn
    perm = np.array([2, 0, 4, 1, 3])
    xb, yb = draw(128, perm)                     # tiny adaptation set
    xe, ye = draw(512, perm)                     # held-out eval
    it_b = NDArrayIter(xb, yb, 64, shuffle=True, label_name="softmax_label")
    it_e = NDArrayIter(xe, ye, 64, label_name="softmax_label")

    mod_a = fit_module(build_sym(5), it_a, epochs=8, lr=0.1)
    prefix = os.path.join(tempfile.mkdtemp(prefix="mxtpu_ft_"), "base")
    mod_a.save_checkpoint(prefix, 8)

    _, arg_params, _ = mx.model.load_checkpoint(prefix, 8)
    trunk = {k: v for k, v in arg_params.items()
             if not k.startswith("fc_new")}
    mod_ft = Module(build_sym(5), data_names=("data",),
                    label_names=("softmax_label",))
    mod_ft.bind(data_shapes=it_b.provide_data,
                label_shapes=it_b.provide_label)
    mod_ft.init_params(initializer=mx.init.Xavier(), arg_params=trunk,
                       allow_missing=True)
    got, _ = mod_ft.get_params()
    warm = bool(np.allclose(got["fc1_weight"].asnumpy(),
                            trunk["fc1_weight"].asnumpy()))
    mod_ft.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9})
    for _ in range(3):
        it_b.reset()
        for batch in it_b:
            mod_ft.forward(batch, is_train=True)
            mod_ft.backward()
            mod_ft.update()
    ft_acc = accuracy(mod_ft, it_e)
    if verbose:
        print(f"trunk warm-started: {warm}; task-B held-out acc "
              f"after 3 epochs on 128 samples: {ft_acc:.3f}")
    return warm, ft_acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", type=int, default=1)
    args = ap.parse_args()
    demo()

"""Sparse logistic regression on ``mxnet_tpu_torch``, the PyTorch port:
the twin of ``linear_classification.py`` beside it (the reference's
``example/sparse/linear_classification``), with the same ``make_data``,
``to_csr`` and ``train`` on a synthetic high-dimensional, mostly-empty
feature matrix.

It runs ``CSRNDArray`` batches and the sparse·dense ``dot`` forward, a
row_sparse gradient (only the features present in the batch give weight
rows) and the lazy row_sparse SGD update, which writes only those rows.
``train`` runs on the current context (the card, ``gpu(0)``, unless the
caller asks for the CPU: ``ctx=mx.cpu()`` or ``--cpu``); no hand-written
kernel is on its path (the CSR product is ``torch.sparse``'s, cuSPARSE on
the card).

Run: python example/sparse/linear_classification_torch.py [--epochs 15]
[--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch.ndarray import sparse as sp


def make_data(rng, n=512, dim=1000, nnz=12):
    """Each sample touches ``nnz`` random features; the label depends on a
    hidden weight over a small informative subset."""
    true_w = np.zeros(dim, "float32")
    informative = rng.choice(dim, 50, replace=False)
    true_w[informative] = rng.randn(50) * 2.0
    rows = []
    for _ in range(n):
        idx = rng.choice(dim, nnz, replace=False)
        val = rng.rand(nnz).astype("float32")
        row = np.zeros(dim, "float32")
        row[idx] = val
        rows.append(row)
    x = np.stack(rows)
    y = ((x @ true_w) > 0).astype("float32")
    return x, y


def to_csr(dense, ctx=None):
    """The ``CSRNDArray`` of a dense batch (host-side featurization)."""
    indptr = [0]
    indices = []
    data = []
    for row in dense:
        nz = np.nonzero(row)[0]
        indices.extend(nz.tolist())
        data.extend(row[nz].tolist())
        indptr.append(len(indices))
    return sp.csr_matrix((np.array(data, "float32"),
                          np.array(indices, "int64"),
                          np.array(indptr, "int64")), shape=dense.shape,
                         ctx=ctx)


def train(epochs=15, batch_size=64, lr=8.0, seed=0, verbose=True,
          ctx=None):
    """Returns (first_acc, last_acc)."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    x, y = make_data(rng)
    dim = x.shape[1]
    w = mx.nd.zeros((dim, 1), ctx=ctx)
    b = mx.nd.zeros((1,), ctx=ctx)
    updater = opt_mod.get_updater(
        opt_mod.SGD(learning_rate=lr, rescale_grad=1.0, wd=0.0))

    def forward(xb_csr):
        return mx.nd.sigmoid(sp.dot(xb_csr, w) + b)

    def accuracy():
        p = forward(to_csr(x, ctx)).asnumpy().ravel()
        return ((p > 0.5) == y).mean()

    first = accuracy()
    for _ in range(epochs):
        order = rng.permutation(len(x))
        for i in range(0, len(x), batch_size):
            sel = order[i:i + batch_size]
            xb = x[sel]
            yb = y[sel]
            p = forward(to_csr(xb, ctx)).asnumpy().ravel()
            err = mx.nd.array((p - yb).reshape(-1, 1) / len(sel), ctx=ctx)
            # row_sparse gradient: only rows for features present in the
            # batch, X^T (p - y) restricted to the touched feature ids
            touched = np.unique(np.nonzero(xb)[1])
            gw_rows = mx.nd.array(xb[:, touched], ctx=ctx).T @ err
            grad = sp.row_sparse_array(
                (gw_rows.asnumpy(), touched.astype("int64")), shape=(dim, 1),
                ctx=ctx)
            updater(0, grad, w)                  # lazy: touched rows only
            updater(1, mx.nd.array([float(err.asnumpy().sum())], ctx=ctx),
                    b)
    last = accuracy()
    if verbose:
        print(f"sparse-linear accuracy: {first:.3f} -> {last:.3f}")
    return first, last


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    args = ap.parse_args()
    train(epochs=args.epochs, ctx=mx.cpu() if args.cpu else None)

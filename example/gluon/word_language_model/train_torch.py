#!/usr/bin/env python
"""LSTM word language model on ``mxnet_tpu_torch``, the PyTorch port.

The twin of ``train.py`` beside it (reference
``example/gluon/word_language_model``): the same ``RNNModel``,
``batchify``, ``get_batch`` and ``detach``, the same arguments and
defaults, with ``import mxnet_tpu_torch as mx``. It runs on the card
(``gpu(0)``) unless ``--cpu`` is given. :func:`train` returns the
per-batch losses, for tests and ``chip_smoke.py``. Loads a text file if
given, else generates a synthetic corpus.

    python example/gluon/word_language_model/train_torch.py [--cpu]
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import gluon, autograd  # noqa: E402
from mxnet_tpu_torch.gluon import nn, rnn  # noqa: E402


class RNNModel(gluon.Block):
    """Embedding → LSTM → Dense decoder (reference model.py:RNNModel).
    ``tie_weights`` is accepted and ignored, as in ``train.py``."""

    def __init__(self, mode, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.5, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed,
                                        weight_initializer=mx.init.Uniform(0.1))
            if mode == "lstm":
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
            elif mode == "gru":
                self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            else:
                self.rnn = rnn.RNN(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            self.decoder = nn.Dense(vocab_size, in_units=num_hidden)
            self.num_hidden = num_hidden

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output.reshape((-1, self.num_hidden)))
        return decoded, hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


def batchify(data, batch_size, ctx=None):
    nbatch = len(data) // batch_size
    data = data[:nbatch * batch_size]
    return mx.nd.array(data.reshape(batch_size, nbatch).T, ctx=ctx)


def get_batch(source, i, bptt):
    seq_len = min(bptt, source.shape[0] - 1 - i)
    data = source[i:i + seq_len]
    target = source[i + 1:i + 1 + seq_len]
    return data, target.reshape((-1,))


def detach(hidden):
    if isinstance(hidden, (list, tuple)):
        return [detach(h) for h in hidden]
    return hidden.detach()


def train_step(model, trainer, loss_fn, data, target, hidden, clip, bptt,
               batch_size):
    """One step of the recipe's loop: the forward and backward under
    ``autograd.record()``, the gradients clipped to a global norm of
    ``clip · bptt · batch_size`` in their buffers, and the update. Returns
    the per-token losses and the hidden state, still in the graph (the
    loop detaches it before the next step)."""
    with autograd.record():
        output, hidden = model(data, hidden)
        L = loss_fn(output, target)
    L.backward()
    grads = [p.grad for p in model.collect_params().values()
             if p.grad_req != "null"]
    gluon.utils.clip_global_norm(grads, clip * bptt * batch_size)
    trainer.step(bptt * batch_size)
    return L, hidden


def synthetic_corpus(ntokens=1000, length=40000, seed=1):
    rs = np.random.RandomState(seed)
    return rs.randint(0, ntokens, length).astype("float32")


def build(ntokens, model="lstm", emsize=200, nhid=200, nlayers=2, lr=1.0,
          dropout=0.2, ctx=None, weights=None):
    """The model (Xavier, or ``weights``: numpy arrays under the
    structural names ``save_parameters`` writes) and its SGD trainer."""
    net = RNNModel(model, ntokens, emsize, nhid, nlayers, dropout)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if weights is not None:
        params = net._collect_params_with_prefix()
        if sorted(params) != sorted(weights):
            raise mx.MXNetError(f"weights {sorted(weights)} are not the "
                                f"model's {sorted(params)}")
        for k, p in params.items():
            p.set_data(weights[k])
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0, "wd": 0},
                            kvstore=None)
    return net, trainer


def train(corpus=None, ntokens=1000, model="lstm", emsize=200, nhid=200,
          nlayers=2, lr=1.0, clip=0.2, epochs=1, batch_size=32, bptt=35,
          dropout=0.2, log_interval=20, max_batches=None, ctx=None,
          weights=None, verbose=True):
    """The recipe's training loop; returns ``(losses, model)``, the mean
    loss of every batch. ``ctx`` defaults to the card."""
    ctx = ctx or mx.gpu(0)
    if corpus is None:
        corpus = synthetic_corpus(ntokens)
    train_data = batchify(corpus, batch_size, ctx=ctx)
    net, trainer = build(ntokens, model, emsize, nhid, nlayers, lr, dropout,
                         ctx, weights)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for epoch in range(epochs):
        total_L = 0.0
        hidden = net.begin_state(batch_size=batch_size, ctx=ctx)
        tic = time.time()
        nbatches = 0
        for ibatch, i in enumerate(range(0, train_data.shape[0] - 1, bptt)):
            data, target = get_batch(train_data, i, bptt)
            hidden = detach(hidden)
            L, hidden = train_step(net, trainer, loss_fn, data, target,
                                   hidden, clip, bptt, batch_size)
            losses.append(float(L.mean().asscalar()))
            total_L += losses[-1]
            nbatches += 1
            if verbose and ibatch % log_interval == 0 and ibatch > 0:
                cur_L = total_L / nbatches
                wps = nbatches * bptt * batch_size / (time.time() - tic)
                print(f"[epoch {epoch} batch {ibatch}] loss {cur_L:.2f}, "
                      f"ppl {math.exp(min(cur_L, 20)):.2f}, {wps:.0f} wps")
            if max_batches and ibatch >= max_batches:
                break
        if verbose:
            print(f"epoch {epoch} done: avg loss "
                  f"{total_L / max(nbatches, 1):.3f}")
    return losses, net


def main():
    parser = argparse.ArgumentParser(description="word language model")
    parser.add_argument("--data", type=str, default=None,
                        help="path to a tokenized text file")
    parser.add_argument("--model", type=str, default="lstm")
    parser.add_argument("--emsize", type=int, default=200)
    parser.add_argument("--nhid", type=int, default=200)
    parser.add_argument("--nlayers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--clip", type=float, default=0.2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--bptt", type=int, default=35)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--log-interval", type=int, default=20)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card)")
    args = parser.parse_args()

    if args.data and os.path.exists(args.data):
        with open(args.data) as f:
            words = f.read().split()
        vocab = {w: i for i, w in enumerate(sorted(set(words)))}
        corpus = np.array([vocab[w] for w in words], dtype="float32")
        ntokens = len(vocab)
    else:
        print("no --data given; using synthetic corpus")
        ntokens = 1000
        corpus = synthetic_corpus(ntokens)
    train(corpus, ntokens, args.model, args.emsize, args.nhid, args.nlayers,
          args.lr, args.clip, args.epochs, args.batch_size, args.bptt,
          args.dropout, args.log_interval, args.max_batches,
          ctx=mx.cpu() if args.cpu else mx.gpu(0))


if __name__ == "__main__":
    main()

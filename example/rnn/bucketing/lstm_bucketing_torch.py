"""PTB-style bucketing LSTM language model on ``mxnet_tpu_torch``, the
PyTorch port: the twin of ``lstm_bucketing.py`` beside it (reference
``example/rnn/bucketing/lstm_bucketing.py``), with the same ``make_corpus``,
``sym_gen_factory`` and ``train`` over ``mx.rnn`` cells,
``BucketSentenceIter``, ``BucketingModule`` and ``metric.Perplexity``. It
runs on the card (``gpu(0)``) unless ``--cpu`` is given or ``train`` is
passed ``ctx=mx.cpu()``; ``sym_gen_factory`` also takes the vocabulary.

Variable-length sentences bucket by padded length; ``sym_gen(seq_len)``
unrolls a stacked-LSTM LM per bucket and ``BucketingModule`` compiles ONE
program per bucket, all buckets sharing parameters through the
largest-bucket executor (T distinct lengths cost len(buckets) bound
executors, not T). Training reports Perplexity.

The reference trains on the PTB text files; this environment has no
dataset egress, so ``make_corpus`` generates Markov-chain "sentences"
with strong bigram structure — a model that learns the transitions drives
perplexity far below the uniform-vocabulary baseline, which is what the
convergence test asserts.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import rnn  # noqa: E402

VOCAB = 24          # ids 1..23 used by the corpus; 0 is the pad label
BUCKETS = [6, 10, 16, 24]


def make_corpus(n_sentences=400, seed=3):
    """Markov sentences: from state w the next word is (2*w) % 21 + 2 with
    prob 0.85, else uniform — bigram-learnable, entropy ~1.5 bits."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(n_sentences):
        ln = int(rng.choice([5, 6, 8, 9, 12, 14, 15, 20, 22]))
        w = int(rng.randint(2, VOCAB))
        sent = [w]
        for _ in range(ln - 1):
            if rng.rand() < 0.85:
                w = (2 * w) % 21 + 2
            else:
                w = int(rng.randint(2, VOCAB))
            sent.append(w)
        sents.append(sent)
    return sents


def sym_gen_factory(num_hidden=64, num_embed=32, num_layers=2, vocab=VOCAB):
    """Reference lstm_bucketing.py sym_gen: embed -> stacked LSTM unroll
    -> per-step FC -> SoftmaxOutput, one symbol per bucket length."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab,
                                 output_dim=num_embed, name="embed")
        stack = rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(rnn.LSTMCell(num_hidden=num_hidden,
                                   prefix=f"lstm_l{i}_"))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                                  layout="NTC")
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def train(epochs=8, batch_size=16, lr=0.02, num_hidden=64, num_embed=32,
          num_layers=2, verbose=True, ctx=None):
    """Returns (first_epoch_ppl, last_epoch_ppl, module); ``ctx`` defaults
    to the card."""
    sents = make_corpus()
    it = rnn.BucketSentenceIter(sents, batch_size, buckets=BUCKETS,
                                invalid_label=0)
    mod = mx.mod.BucketingModule(
        sym_gen_factory(num_hidden, num_embed, num_layers),
        default_bucket_key=it.default_bucket_key, context=ctx or mx.gpu(0))

    ppls = []
    metric = mx.metric.Perplexity(ignore_label=0)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(kvstore=None, optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    for epoch in range(epochs):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.update_metric(metric, batch.label)
            mod.backward()
            mod.update()
        ppls.append(metric.get()[1])
        if verbose:
            print(f"epoch {epoch}: train ppl {ppls[-1]:.2f}")
    return ppls[0], ppls[-1], mod


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="bucketing LSTM LM")
    parser.add_argument("--num-epochs", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--num-hidden", type=int, default=64)
    parser.add_argument("--num-embed", type=int, default=32)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card)")
    args = parser.parse_args()
    first, last, _ = train(args.num_epochs, args.batch_size, args.lr,
                           args.num_hidden, args.num_embed, args.num_layers,
                           ctx=mx.cpu() if args.cpu else mx.gpu(0))
    print(f"perplexity {first:.2f} -> {last:.2f}")

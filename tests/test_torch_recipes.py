"""PyTorch port, the recipe twins against the JAX recipes they copy:
``example/gluon/word_language_model/train_torch.py`` (the LSTM word
language model through gluon), ``example/rnn/bucketing/
lstm_bucketing_torch.py`` (``mx.rnn`` cells under ``BucketingModule``)
and ``example/gluon/transformer_lm_torch.py``.

Both sides start from the same weights: the word LM's are carried by
structural name, and the two other recipes draw theirs from an
initializer that both packages' ``Xavier`` is replaced with for the test,
which fills each parameter from its name. The JAX recipes' modules are
loaded by path and left as they are; where the JAX side would compile
op by op, its blocks are hybridized (the same arithmetic, one program).
Tolerance: losses within 1e-5 relative, weights within 1e-5 of the
tensor's largest entry, unless a test says why it needs more.
"""
import importlib.util
import os
import random
import re
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TOL = 1e-5


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _seeded(name, shape):
    """Values from the name less its outer block's counted prefix
    (``transformerlm0_``), which a subclass or an earlier net renames."""
    key = re.sub(r"^[a-z]+\d+_", "", name)
    rs = np.random.RandomState(zlib.crc32(key.encode()))
    return rs.uniform(-0.2, 0.2, shape).astype("float32")


def _seeded_xavier(monkeypatch):
    """Both packages' ``init.Xavier()`` fill each parameter from its name
    (weights and biases alike)."""

    class JaxSeeded(jmx.init.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = _seeded(name, arr.shape)

        _init_bias = _init_weight

    class PortSeeded(mx.init.Initializer):
        def _init_weight(self, name, arr):
            arr.copy_(torch.from_numpy(_seeded(name, tuple(arr.shape))))

        _init_bias = _init_weight

    monkeypatch.setattr(jmx.init, "Xavier", lambda *a, **k: JaxSeeded())
    monkeypatch.setattr(mx.init, "Xavier", lambda *a, **k: PortSeeded())


# ------------------------------------------------------------ the word LM
V, EMB, BPTT, BATCH, STEPS, LR = 50, 8, 5, 4, 3, 1.0
CLIP = 0.02     # x bptt x batch = 0.4: below the gradients' norm, so the
                # recipe's clip_global_norm scales every step


def test_word_lm_twin_steps_match_the_jax_recipe():
    """The twin's ``train()`` (vocab 50, emsize = nhid = 8, 2 layers,
    bptt 5, batch 4, dropout 0) against the JAX recipe's own
    ``RNNModel``, ``batchify``, ``get_batch`` and ``detach`` in its loop,
    on the same weights: the three losses and every weight after step 3
    (the hidden state carried and detached between the steps, the
    gradients clipped in place)."""
    jr = _load("example/gluon/word_language_model/train.py", "jax_word_lm")
    pr = _load("example/gluon/word_language_model/train_torch.py",
               "port_word_lm")
    corpus = pr.synthetic_corpus(V, BATCH * (STEPS * BPTT + 1), seed=2)

    model = jr.RNNModel("lstm", V, EMB, EMB, 2, dropout=0.0)
    model.initialize(jmx.init.Xavier())
    for block in (model.drop, model.encoder, model.rnn, model.decoder):
        block.hybridize()   # the LSTM in TNC: a program forward, one back
    weights = {k: p.data().asnumpy()
               for k, p in model._collect_params_with_prefix().items()}
    trainer = jmx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": 0,
                                 "wd": 0}, kvstore=None)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    train_data = jr.batchify(corpus, BATCH)
    hidden = model.begin_state(batch_size=BATCH)
    want, norms = [], []
    for i in range(0, STEPS * BPTT, BPTT):
        data, target = jr.get_batch(train_data, i, BPTT)
        hidden = jr.detach(hidden)
        with jmx.autograd.record():
            output, hidden = model(data, hidden)
            L = loss_fn(output, target)
        L.backward()
        grads = [p.grad for p in model.collect_params().values()
                 if p.grad_req != "null"]
        norms.append(jmx.gluon.utils.clip_global_norm(grads,
                                                      CLIP * BPTT * BATCH))
        trainer.step(BPTT * BATCH)
        want.append(float(L.mean().asscalar()))
    assert min(norms) > CLIP * BPTT * BATCH

    losses, net = pr.train(corpus, V, "lstm", EMB, EMB, 2, LR, CLIP,
                           epochs=1, batch_size=BATCH, bptt=BPTT,
                           dropout=0.0, max_batches=STEPS - 1,
                           ctx=mx.cpu(), weights=weights, verbose=False)
    np.testing.assert_allclose(losses, want, rtol=TOL)
    assert losses[-1] < losses[0]
    got = {k: p.data().asnumpy()
           for k, p in net._collect_params_with_prefix().items()}
    for k, p in model._collect_params_with_prefix().items():
        assert not np.array_equal(weights[k], p.data().asnumpy()), k
        _close(got[k], p.data().asnumpy(), what=k)


def test_word_lm_tie_weights_is_accepted_and_ignored_like_jax():
    """``RNNModel(tie_weights=True)`` keeps an untied decoder in both
    recipes (``train.py:24`` accepts the flag and ties nothing: a standing
    fault of the JAX recipe, ROADMAP C, which the twin follows)."""
    jr = _load("example/gluon/word_language_model/train.py", "jax_word_lm")
    pr = _load("example/gluon/word_language_model/train_torch.py",
               "port_word_lm")

    def shapes(model):
        model.initialize()
        return {k: p.data().shape
                for k, p in model._collect_params_with_prefix().items()}

    want = shapes(jr.RNNModel("lstm", V, EMB, EMB, 1, tie_weights=True))
    with mx.cpu():
        got = shapes(pr.RNNModel("lstm", V, EMB, EMB, 1, tie_weights=True))
    assert got == want
    assert {"encoder.weight", "decoder.weight"} <= set(got)


# ------------------------------------------------------------- bucketing
def _recording_perplexity(metric_mod):
    """``metric.Perplexity`` that also keeps each batch's own perplexity."""
    base = metric_mod.Perplexity

    class Recording(base):
        batches = []

        def update(self, labels, preds):
            one = base(ignore_label=self.ignore_label)
            one.update(labels, preds)
            Recording.batches.append(one.get()[1])
            super().update(labels, preds)

    return Recording


def test_bucketing_twin_pass_matches_the_jax_example(monkeypatch):
    """One pass of ``train(epochs=1)`` (one ``LSTMCell`` of 16, Adam) in
    both packages from the same weights and the same shuffles: every
    batch's perplexity, and the epoch's. The corpus is the example's
    generator at 200 sentences, in batches of 4, and the buckets are 5
    and 6 steps (each bucket is a program the JAX executor compiles; the
    card runs the example's two cells at its full widths). Adam's steps
    carry float32 rounding from batch to batch, so the later batches are
    held to 2e-5 (the first to 1e-5)."""
    jb = _load("example/rnn/bucketing/lstm_bucketing.py", "jax_bucketing")
    pb = _load("example/rnn/bucketing/lstm_bucketing_torch.py",
               "port_bucketing")
    _seeded_xavier(monkeypatch)
    runs = []
    for m, module, kw in ((jmx, jb, {}), (mx, pb, {"ctx": mx.cpu()})):
        make = module.make_corpus
        monkeypatch.setattr(module, "make_corpus",
                            lambda make=make: make(n_sentences=200))
        monkeypatch.setattr(module, "BUCKETS", [5, 6])
        rec = _recording_perplexity(m.metric)
        monkeypatch.setattr(m.metric, "Perplexity", rec)
        random.seed(0)
        np.random.seed(0)
        first, last, _ = module.train(epochs=1, batch_size=4,
                                      num_hidden=16, num_embed=8,
                                      num_layers=1, verbose=False, **kw)
        runs.append((first, rec.batches))
    (jfirst, want), (first, got) = runs
    assert len(got) == len(want) > 5
    np.testing.assert_allclose(np.log(got[:1]), np.log(want[:1]), rtol=TOL)
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=2e-5)
    np.testing.assert_allclose(first, jfirst, rtol=2e-5)


# ----------------------------------------------------------- transformer
def test_transformer_lm_twin_matches_the_jax_recipe(monkeypatch):
    """``train(epochs=2, steps_per_epoch=1)`` of both recipes from the same
    weights: the two steps' losses (each epoch's mean is its one step)
    and the next-token accuracy on the recipe's fresh batch. The JAX
    side's flash attention runs interpreted, as ``tests/test_pallas.py``
    runs it, its net hybridized. Both recipes' net is cut to one of its
    two layers here (the card trains the twin at its own size)."""
    from mxnet_tpu.gluon.contrib import transformer as jtfm
    from mxnet_tpu_torch.gluon.contrib import transformer as ptfm
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jt = _load("example/gluon/transformer_lm.py", "jax_transformer_lm")
    pt = _load("example/gluon/transformer_lm_torch.py",
               "port_transformer_lm")
    _seeded_xavier(monkeypatch)

    class Hybridized(jtfm.TransformerLM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **dict(kwargs, num_layers=1))

        def initialize(self, *args, **kwargs):
            super().initialize(*args, **kwargs)
            self.hybridize()

    class OneLayer(ptfm.TransformerLM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **dict(kwargs, num_layers=1))

    monkeypatch.setattr(jt.tfm, "TransformerLM", Hybridized)
    monkeypatch.setattr(pt.tfm, "TransformerLM", OneLayer)
    want = jt.train(epochs=2, batch=4, steps_per_epoch=1, verbose=False)
    losses = []
    got = pt.train(epochs=2, batch=4, steps_per_epoch=1, verbose=False,
                   ctx=mx.cpu(), losses=losses)
    np.testing.assert_allclose(losses, [got[0], got[1]], rtol=0)
    np.testing.assert_allclose(got[:2], want[:2], rtol=TOL)
    assert got[2] == pytest.approx(want[2], abs=1.0 / (64 * 28))

"""PyTorch port, the training slice: ``TransformerLM`` trained through
gluon (``autograd.record``, the ``softmax_cross_entropy`` op, ``Trainer``)
against the JAX package's own gluon training of the same weights.

The LM is cut to the CPU: units 256, 2 heads of dim 128 (so the JAX
package runs its Pallas flash-attention kernel in interpret mode), 2
layers, FFN 512, vocab 128 (its Pallas cross-entropy kernel in interpret
mode), batch 2 × 16 tokens. Adam at lr 1e-3, three steps. Tolerances,
both sides float32 in another summation order: each step's loss 1e-5
relative; every gradient after step 1 within 1e-4 of its largest entry;
weights after step 3 within 1e-5 absolute (three Adam steps move a weight
by about 3e-3; where a gradient entry is near zero, a 1e-7 difference
between the two packages moves its Adam step by a few 1e-7).

The rules the port must keep, each against the JAX package: MXNet's SGD
momentum rule (``m ← μm − lr·g; w ← w + m``, not torch's) across a
learning-rate change, the ``1/batch_size`` rescale of ``Trainer.step``,
and ``SoftmaxCrossEntropyLoss`` (plain ops) giving the gradients of the
fused op up to the B·T scale.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd, gluon, interop

V, UNITS, LAYERS, HEADS, FFN, B, T = 128, 256, 2, 2, 512, 2, 16


def _train_jax(net, x, y, steps, make_trainer):
    """The JAX package's gluon loop; returns (weights before the first
    update, per-step losses, per-step gradients). The hybridized net's
    first call runs under ``record()``, so it compiles one program."""
    trainer = make_trainer(jgluon, net)
    losses, grads = [], []
    for step in range(steps):
        with jag.record():
            loss = jmx.nd.softmax_cross_entropy(
                net(jmx.nd.array(x)).reshape((-1, V)),
                jmx.nd.array(y).reshape((-1,)))
        if step == 0:      # deferred shapes are known after the forward
            weights = {k: p.data().asnumpy()
                       for k, p in net.collect_params().items()}
        loss.backward()
        grads.append({k: p.grad.asnumpy()
                      for k, p in net.collect_params().items()
                      if p.grad_req != "null"})
        trainer.step(x.size)
        losses.append(float(loss.asscalar()))
    return weights, losses, grads


def _train_port(net, x, y, steps, make_trainer):
    trainer = make_trainer(gluon, net)
    losses, grads = [], []
    with mx.cpu():
        for step in range(steps):
            with autograd.record():
                loss = mx.nd.softmax_cross_entropy(
                    net(mx.nd.array(x)).reshape((-1, V)),
                    mx.nd.array(y).reshape((-1,)))
            loss.backward()
            grads.append({k: p.grad.asnumpy()
                          for k, p in net.collect_params().items()
                          if p.grad_req != "null"})
            trainer.step(x.size)
            losses.append(float(loss.asscalar()))
    return losses, grads


def _lm(g):
    return g.contrib.transformer.TransformerLM(vocab_size=V, units=UNITS, num_layers=LAYERS,
                             num_heads=HEADS, hidden_size=FFN, max_len=24,
                             prefix="lm_")


def test_transformer_lm_three_adam_steps_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, T)).astype("float32")
    y = rng.randint(0, V, (B, T)).astype("float32")

    def adam(g, n):
        return g.Trainer(n.collect_params(), "adam", {"learning_rate": 1e-3})

    jnet = _lm(jgluon)
    jmx.random.seed(3)
    jnet.initialize(jmx.init.Normal(0.02))
    jnet.hybridize()
    weights, jlosses, jgrads = _train_jax(jnet, x, y, 3, adam)
    with mx.cpu():
        net = _lm(gluon)
        net.initialize(mx.init.Normal(0.02))
        interop.load_block_params(net, weights)
    assert list(net.collect_params().keys()) == list(weights)
    losses, grads = _train_port(net, x, y, 3, adam)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] < losses[0]
    assert grads[0].keys() == jgrads[0].keys()
    for k, jg in jgrads[0].items():
        np.testing.assert_allclose(grads[0][k], jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max(), err_msg=k)
    jw = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    w = interop.block_params_to_numpy(net)
    for k in jw:
        np.testing.assert_allclose(w[k], jw[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def _mlp(g):
    net = g.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(g.nn.Embedding(V, 16, prefix="emb_"))
        net.add(g.nn.Dense(32, activation="tanh", flatten=False,
                           prefix="fc1_"))
        net.add(g.nn.Dense(V, flatten=False, prefix="fc2_"))
    return net


def test_sgd_momentum_rule_with_lr_change_matches_jax():
    """MXNet's momentum rule keeps lr inside the momentum buffer, so a
    learning-rate change at step 2 separates it from torch's; weight decay
    and the 1/batch rescale ride along. Loss sum(c·w²), three steps."""
    w0 = np.linspace(-1, 1, 12, dtype="float32").reshape(3, 4)
    c = np.linspace(0.5, 2, 12, dtype="float32").reshape(3, 4)
    out = []
    for pkg, ag, g in ((jmx, jag, jgluon), (mx, autograd, gluon)):
        ctx = None if pkg is jmx else mx.cpu()
        p = g.Parameter("w", shape=(3, 4))
        p.initialize(pkg.init.Zero(), ctx=ctx)
        p.set_data(pkg.nd.array(w0, ctx=ctx))
        cc = pkg.nd.array(c, ctx=ctx)
        trainer = g.Trainer([p], "sgd", {"learning_rate": 0.5,
                                         "momentum": 0.9, "wd": 1e-2})
        for step in range(3):
            if step == 2:
                trainer.set_learning_rate(0.05)
            with ag.record():
                loss = (p.data() * p.data() * cc).sum()
            loss.backward()
            trainer.step(4)
        out.append(p.data().asnumpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-7)
    # torch's rule (lr applied after the momentum) lands elsewhere
    w, m = w0.astype("float64"), np.zeros_like(w0, "float64")
    for lr in (0.5, 0.5, 0.05):
        grad = 2 * c * w / 4 + 1e-2 * w
        m = 0.9 * m + grad
        w = w - lr * m
    assert np.abs(out[1] - w).max() > 1e-2


def test_softmax_ce_loss_matches_the_fused_op_up_to_scale():
    rng = np.random.RandomState(2)
    x = rng.randint(0, V, (B, T)).astype("float32")
    y = rng.randint(0, V, (B, T)).astype("float32")
    grads = []
    with mx.cpu():
        net = _mlp(gluon)
        mx.random.seed(4)
        net.initialize(mx.init.Xavier())
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for use_op in (True, False):
            with autograd.record():
                logits = net(mx.nd.array(x)).reshape((-1, V))
                label = mx.nd.array(y).reshape((-1,))
                if use_op:     # the sum over rows, shape (1,)
                    loss = mx.nd.softmax_cross_entropy(logits, label)
                else:          # per row, shape (B·T,); its mean
                    per_row = loss_fn(logits, label)
                    loss = per_row.mean()
            loss.backward()
            grads.append({k: p.grad.asnumpy() * (1.0 if use_op else x.size)
                          for k, p in net.collect_params().items()})
    assert per_row.shape == (x.size,)
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("kvstore", ["dist_sync", "nccl"])
def test_trainer_refuses_multi_card_stores(kvstore):
    with mx.cpu():
        p = gluon.Parameter("w", shape=(2,))
        p.initialize()
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        gluon.Trainer([p], "sgd", kvstore=kvstore)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_parameter_grad_req_across_steps(req):
    """``write`` gives the last backward's gradient where torch would
    accumulate, ``add`` the sum, ``null`` no gradient and no update; the
    weight tensor stays the same autograd leaf across updates."""
    with mx.cpu():
        p = gluon.Parameter("w", shape=(3,), grad_req=req)
        p.initialize(mx.init.One())
        leaf = p.data()._data
        trainer = gluon.Trainer([p], "sgd", {"learning_rate": 0.1})
        for scale in (1.0, 2.0):
            with autograd.record():
                loss = (p.data() * scale).sum()
            if req == "null":
                assert not loss._data.requires_grad
                continue
            loss.backward()
            trainer.step(1)
    assert p.data()._data is leaf
    if req == "null":
        with pytest.raises(mx.MXNetError, match="grad_req='null'"):
            p.grad
        np.testing.assert_array_equal(p.data().asnumpy(), 1.0)
        return
    want_grad = {"write": 2.0, "add": 3.0}[req]
    np.testing.assert_allclose(p.grad.asnumpy(), want_grad)
    # write: w = 1 − 0.1·1 − 0.1·2; add: the second step sees 1 + 2
    want_w = {"write": 0.7, "add": 0.6}[req]
    np.testing.assert_allclose(p.data().asnumpy(), want_w, rtol=1e-6)

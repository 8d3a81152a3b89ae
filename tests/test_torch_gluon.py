"""PyTorch port, ``mxnet_tpu_torch.gluon``: names, initializers, layers,
export.

Each layer test builds the JAX package's block and the port's with the
same prefix, carries the JAX block's weights across with
``interop.load_block_params``, runs both on the same numpy input under
``autograd.record()`` and compares the output and every parameter's
gradient of ``sum(out * w)``: 1e-5 relative to the largest value (float32
on both sides, another summation order). Attention, the FFN and the cells
are held to the JAX package inside the whole LM by
``tests/test_torch_train.py``.

The export test trains the port's LM two steps, hybridizes and exports
it, and serves the files through the port's ``ModelServer`` and the JAX
package's: both answer with the trained net's logits (1e-4 relative), and
neither needs the re-prefixing that ``tests/test_torch_serving.py`` applies
to files the JAX package exports (ROADMAP §C).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.contrib import transformer as jtfm
from mxnet_tpu.serving import ModelConfig as JaxModelConfig
from mxnet_tpu.serving import ModelServer as JaxModelServer
from mxnet_tpu_torch import autograd, gluon, interop
from mxnet_tpu_torch.gluon.contrib import transformer as tfm
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.serving.load import model_config_from_files
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _lm(mod, **kw):
    return mod.TransformerLM(vocab_size=128, units=256, num_layers=2,
                             num_heads=2, hidden_size=512, max_len=24, **kw)


@pytest.mark.parametrize("prefix", ["lm_", None])
def test_collect_params_names_match_jax(prefix):
    jnames = list(_lm(jtfm, prefix=prefix).collect_params().keys())
    names = list(_lm(tfm, prefix=prefix).collect_params().keys())
    if prefix is None:   # process-wide counters name the outer block
        jnames = [n.split("_", 1)[1] for n in jnames]
        names = [n.split("_", 1)[1] for n in names]
    assert names == jnames
    assert any(n.endswith("_pos_table") for n in names)


@pytest.mark.parametrize("init,sigma", [
    ("normal", 0.02),
    ("xavier_uniform", np.sqrt(3.0 / 384) / np.sqrt(3.0)),
    ("xavier_gaussian", np.sqrt(3.0 / 384)),
])
def test_initializer_statistics(init, sigma):
    """The port draws from torch's generator, so only the statistics can
    match the JAX package's draws; both against the rule's sigma."""
    make = {"normal": lambda m: m.init.Normal(0.02),
            "xavier_uniform": lambda m: m.init.Xavier(),
            "xavier_gaussian": lambda m: m.init.Xavier(rnd_type="gaussian")}
    mx.random.seed(5)
    t = torch.empty(256, 512)
    make[init](mx)("w_weight", t)
    a = np.zeros((256, 512), "float32")
    make[init](jmx)("w_weight", a)
    for v in (t.numpy(), a):
        assert abs(v.mean()) < 3 * sigma / np.sqrt(v.size) + 1e-7
        assert abs(v.std() / sigma - 1) < 0.02
    if init == "xavier_uniform":
        bound = np.sqrt(3.0 / 384)
        assert t.abs().max().item() <= bound
    b, g = torch.ones(4), torch.zeros(4)
    make[init](mx)("w_bias", b)
    make[init](mx)("w_gamma", g)
    assert b.sum().item() == 0 and g.sum().item() == 4


LAYERS = {
    "dense_relu": (lambda m: m.nn.Dense(24, activation="relu",
                                        prefix="d_"), (4, 5, 16), None),
    "layernorm": (lambda m: m.nn.LayerNorm(prefix="ln_"), (4, 5, 16), None),
    # ids -3 and 70 clip to rows 0 and 31; their gradient lands there
    "embedding": (lambda m: m.nn.Embedding(32, 8, prefix="emb_"), (2, 4),
                  np.array([[0, -3, 5, 31], [70, 2, 2, 0]], "float32")),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_output_and_grads_match_jax(name):
    make, shape, data = LAYERS[name]
    rng = np.random.RandomState(3)
    x = data if data is not None else rng.randn(*shape).astype("float32")
    jblk = make(jmx.gluon)
    jmx.random.seed(2)
    jblk.initialize(jmx.init.Normal(0.1))
    jblk.hybridize()                        # one XLA program per block
    jblk(jmx.nd.array(x))                    # finishes deferred shapes
    weights = {k: p.data().asnumpy() + 0.1 * (k.endswith("gamma"))
               for k, p in jblk.collect_params().items()}
    for k, p in jblk.collect_params().items():
        p.set_data(jmx.nd.array(weights[k]))
    with mx.cpu():
        blk = make(gluon)
        blk.initialize()
        interop.load_block_params(blk, weights)   # deferred shapes too
    outs, grads = [], []
    for pkg, ag, b in ((jmx, jag, jblk), (mx, autograd, blk)):
        xa = pkg.nd.array(x) if pkg is jmx else pkg.nd.array(x, ctx=mx.cpu())
        with ag.record():
            out = b(xa)
            w = np.linspace(-1, 1, out.size, dtype="float32").reshape(
                out.shape)
            loss = (out * (pkg.nd.array(w) if pkg is jmx
                           else pkg.nd.array(w, ctx=mx.cpu()))).sum()
        loss.backward()
        outs.append(out.asnumpy())
        grads.append({k: p.grad.asnumpy()
                      for k, p in b.collect_params().items()})
    np.testing.assert_allclose(outs[1], outs[0], rtol=0,
                               atol=TOL * np.abs(outs[0]).max())
    assert grads[1].keys() == grads[0].keys()
    for k, jg in grads[0].items():
        np.testing.assert_allclose(grads[1][k], jg, rtol=0,
                                   atol=TOL * max(np.abs(jg).max(), 1e-30),
                                   err_msg=k)
    if name == "embedding":
        g = grads[1]["emb_weight"]
        assert g[0].any() and g[31].any() and not g[30].any()


def test_constant_takes_no_gradient_or_update():
    with mx.cpu():
        net = tfm.TransformerLM(vocab_size=16, units=32, num_layers=1,
                                num_heads=1, max_len=8, prefix="c_")
        net.initialize(mx.init.Normal(0.1))
        table = net.pos.table
        before = table.data().asnumpy().copy()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1.0})
        x = mx.nd.array(np.arange(8, dtype="float32")[None] % 16)
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(1)
    assert table.grad_req == "null"
    with pytest.raises(mx.MXNetError, match="grad_req='null'"):
        table.grad
    np.testing.assert_array_equal(table.data().asnumpy(), before)
    assert net.head.weight.grad.asnumpy().any()


def _export_lm(mod):
    """The served LM as a HybridSequential, as tests/test_torch_serving.py
    builds it (TransformerLM itself is a Block, which has no export)."""
    net = mod.nn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(mod.nn.Embedding(37, 64, prefix="embed_"))
        net.add(mod.contrib.transformer.SinusoidalPositionalEmbedding(8, 64))
        net.add(mod.contrib.transformer.TransformerEncoder(
            1, 64, 128, 2, 0.0, pre_norm=True, causal=True, prefix="body_"))
        net.add(mod.nn.Dense(37, flatten=False, use_bias=False,
                             prefix="head_"))
    return net


def test_export_serves_trained_net_in_both_packages(tmp_path):
    rng = np.random.RandomState(4)
    x = rng.randint(0, 37, (2, 8)).astype("float32")
    y = rng.randint(0, 37, (2, 8)).astype("float32")
    with mx.cpu():
        net = _export_lm(gluon)
        mx.random.seed(8)
        net.initialize(mx.init.Normal(0.05))
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
        for _ in range(2):
            with autograd.record():
                loss = mx.nd.softmax_cross_entropy(
                    net(mx.nd.array(x)).reshape((-1, 37)),
                    mx.nd.array(y).reshape((-1,)))
            loss.backward()
            trainer.step(16)
        net.hybridize()
        want = net(mx.nd.array(x)).asnumpy()
    sym_file, par_file = net.export(str(tmp_path / "lm"))
    params = mx.nd.load(par_file, ctx=mx.cpu())
    assert params["arg:lm_sinusoidalpositionalembedding0_pos_table"].shape \
        == (8, 64)
    assert all(k.startswith("arg:") for k in params)
    with open(sym_file) as f:
        sym_json = f.read()
    assert json.loads(sym_json)["mxnet_tpu_version"] == 1
    with open(par_file, "rb") as f:
        pbytes = f.read()

    cfg = model_config_from_files(
        sym_file, params=par_file, feature_shape="8", name="lm",
        buckets="2", dev_type=1, deadline_ms=60000.0, max_wait_ms=50.0)
    jcfg = JaxModelConfig("lm", sym_json, pbytes, feature_shape=(8,),
                          buckets=(2,), deadline_ms=60000.0, max_wait_ms=50.0)
    for server in (ModelServer([cfg]),
                   JaxModelServer([jcfg], drain_on_preemption=False)):
        srv = server.start()
        try:
            outs = [f.result(120.0) for f in
                    [srv.submit("lm", r) for r in x]]
        finally:
            srv.close(timeout=10.0)
        np.testing.assert_allclose(np.stack(outs), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())

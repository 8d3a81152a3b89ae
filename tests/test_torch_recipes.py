"""PyTorch port, the recipe twins against the JAX recipes they copy:
``example/gluon/word_language_model/train_torch.py`` (the LSTM word
language model through gluon), ``example/rnn/bucketing/
lstm_bucketing_torch.py`` (``mx.rnn`` cells under ``BucketingModule``),
``example/gluon/transformer_lm_torch.py`` and ``example/ssd/
train_torch.py`` (SSD through ``Module.fit`` over ``ImageDetRecordIter``).

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
import sys
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import jax_host_seed

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
    gradients clipped in place). The weights are the JAX ``Xavier``'s
    draws from its host stream seeded with the corpus's seed (2): with
    the stream as earlier tests left it, some draws (seeds 0 and 24 among
    the first 30) give a loss that does not fall over the three steps, in
    the JAX recipe itself."""
    jr = _load("example/gluon/word_language_model/train.py", "jax_word_lm")
    pr = _load("example/gluon/word_language_model/train_torch.py",
               "port_word_lm")
    corpus = pr.synthetic_corpus(V, BATCH * (STEPS * BPTT + 1), seed=2)

    model = jr.RNNModel("lstm", V, EMB, EMB, 2, dropout=0.0)
    with jax_host_seed(2):
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


# ------------------------------------------------------------ SSD
SSD = dict(num_images=32, image_size=32, batch_size=16, lr=0.05)
TOL_SSD = 2e-3      # relative, per epoch loss: see the test


def _ssd_weights(pkg, net, cfg):
    """Name-seeded weights for every argument of the SSD training graph
    (BatchNorm's gamma 1 and beta 0) and its auxiliary states (0 and 1)."""
    s = cfg["image_size"]
    arg_shapes, _, aux_shapes = net.infer_shape(
        data=(cfg["batch_size"], 3, s, s), label=(cfg["batch_size"], 4, 5))
    args, aux = {}, {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "label"):
            continue
        value = _seeded(name, shape) * (0.5 if name.endswith("weight")
                                        else 0.1)
        if name.endswith("gamma"):
            value = np.ones(shape, "float32")
        args[name] = value
    for name, shape in zip(net.list_auxiliary_states(), aux_shapes):
        aux[name] = np.ones(shape, "float32") if name.endswith("var") \
            else np.zeros(shape, "float32")
    return args, aux


def test_ssd_twin_fit_matches_the_jax_recipe(tmp_path):
    """The twin's ``train()`` (``Module.fit`` of ``symbol_ssd_torch``'s
    graph over ``ImageDetRecordIter`` batches of ``dataset_torch``'s
    records, SGD with momentum) against the JAX recipe's own
    ``write_records``, ``build_ssd`` and ``make_metric`` in the same
    ``Module.fit``, two epochs of two batches from the same weights: the
    record files are byte for byte the same, and so is the shuffled order
    (both iterators' shuffle seeds come from their package's host stream,
    seeded alike); the epoch losses (cross-entropy plus smooth-L1 per
    valid anchor) agree within TOL_SSD and fall. Not 1e-5: an object
    centred between two anchors of one size overlaps both exactly alike,
    and which of them its force match claims is decided by float32
    rounding (the JAX op alone and the port both take the first; inside
    the JAX graph XLA's fused arithmetic takes the second in this data),
    so one positive moves to the next anchor (2.7e-4 of the first epoch's
    loss here), and the hard-negative ranking may swap nearly equal
    anchors at its cut."""
    ssd_dir = os.path.join(ROOT, "example", "ssd")
    sys.path.insert(0, ssd_dir)
    try:
        jd = _load("example/ssd/dataset.py", "dataset")
        js = _load("example/ssd/symbol_ssd.py", "jax_symbol_ssd")
        jt = _load("example/ssd/train.py", "jax_ssd_train")
        pt = _load("example/ssd/train_torch.py", "port_ssd_train")
    finally:
        sys.path.remove(ssd_dir)
    cfg = SSD
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    rec = jd.write_records(str(jdir / "train"), num_images=cfg["num_images"],
                           size=cfg["image_size"])
    net = js.build_ssd(jd.NUM_CLASSES, mode="train")
    args, aux = _ssd_weights(jmx, net, cfg)

    s = cfg["image_size"]
    with jax_host_seed(0):
        it = jmx.io.ImageDetRecordIter(rec, data_shape=(3, s, s),
                                       batch_size=cfg["batch_size"],
                                       max_objs=4, shuffle=True,
                                       scale=1.0 / 255)
    mod = jmx.mod.Module(net, context=jmx.cpu(), data_names=["data"],
                         label_names=["label"])
    metric, want = jt.make_metric(jmx), []

    def on_epoch(*_a):
        want.append(sum(metric.get()[1]))
        metric.reset()

    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"], "momentum": 0.9,
                              "wd": 1e-4}, eval_metric=metric, kvstore=None,
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
            epoch_end_callback=on_epoch)

    mx.random.seed(0)
    argv = ["--epochs", "2", "--num-images", str(cfg["num_images"]),
            "--image-size", str(s), "--batch-size", str(cfg["batch_size"]),
            "--lr", str(cfg["lr"]), "--data-dir", str(pdir)]
    got, _, _ = pt.train(
        pt.parse_args(argv), mx.cpu(),
        arg_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()},
        aux_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()},
        verbose=False)
    for ext in (".rec", ".idx"):
        assert (pdir / f"train{ext}").read_bytes() == \
            (jdir / f"train{ext}").read_bytes()
    np.testing.assert_allclose(got, want, rtol=TOL_SSD)
    assert got[1] < got[0]


# ------------------------------------------------ image classification
IC = os.path.join(ROOT, "example", "image-classification")


def _ic_modules():
    """The JAX recipe's and the twin's ``fit``, ``data`` and symbol
    modules, imported from the recipe's directory as its scripts do."""
    import importlib
    sys.path.insert(0, IC)
    try:
        names = ("common.fit", "common.data", "symbols.lenet",
                 "symbols.resnet", "train_mnist")
        jax_side = [importlib.import_module(n) for n in names]
        port_side = [importlib.import_module(n + "_torch") for n in names]
    finally:
        sys.path.remove(IC)
    return jax_side, port_side


def _ic_args(fit, data, extra, port):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--data-dir", type=str, default=None)
    fit.add_fit_args(p)
    data.add_data_args(p)
    argv = list(extra) + (["--gpus", ""] if port else [])
    return p.parse_args(argv)


def _write_mnist(root, n_train=32, n_val=16):
    """idx files of a learnable task: the class is the brightest of ten
    horizontal bands."""
    import struct
    rs = np.random.RandomState(11)
    for prefix, n in (("train", n_train), ("t10k", n_val)):
        y = rs.randint(0, 10, n).astype("uint8")
        x = rs.randint(0, 60, (n, 28, 28)).astype("uint8")
        for i, c in enumerate(y):
            x[i, 2 + 2 * c:4 + 2 * c] = 250
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.tobytes())


def _seeded_xavier_with_norms(monkeypatch):
    """``_seeded_xavier``, BatchNorm's gamma and beta (and its moving
    statistics) name-seeded too: a beta that starts at 0 holds only its
    step, a sum over every pixel whose float32 rounding is a visible share
    of it."""

    def fill(pkg, write):
        class Seeded(pkg.init.Initializer):
            def _init_weight(self, name, arr):
                write(arr, _seeded(name, tuple(arr.shape)))

            # beta and the moving mean, gamma and the moving variance
            _init_bias = _init_zero = _init_weight

            def _init_one(self, name, arr):
                write(arr, 1.0 + _seeded(name, tuple(arr.shape)))

        monkeypatch.setattr(pkg.init, "Xavier", lambda *a, **k: Seeded())

    def jax_write(arr, v):
        arr[:] = v

    fill(jmx, jax_write)
    fill(mx, lambda arr, v: arr.copy_(torch.from_numpy(v)))


def test_image_classification_twins_match_the_jax_recipes(tmp_path,
                                                          monkeypatch):
    """``fit_torch.fit`` against ``fit.fit`` from the same name-seeded
    weights, every weight and auxiliary state compared: LeNet through
    ``train_mnist``'s ``MNISTIter`` on idx files (shuffled from each host
    stream seeded alike; four updates), and ``symbols/resnet`` v1 and v2
    at 28×28 with ``--num-layers 8`` on two batches of synthetic images
    (two updates) — both through the store and the device feed on the
    CPU. Then the recipe's two quirks in both packages: the schedule's
    epoch is sized by the train iterator's ``.idx`` (one batch without
    one, so ``lr_step_epochs`` counts updates), and ``--dtype`` changes
    nothing. Then ``fine_tune_torch``'s demo against ``fine_tune``'s."""
    _seeded_xavier_with_norms(monkeypatch)
    (jfit, jdata, jlenet, jresnet, jmnist), \
        (pfit, pdata, plenet, presnet, pmnist) = _ic_modules()
    _write_mnist(str(tmp_path))
    rs = np.random.RandomState(12)
    images = rs.uniform(-1, 1, (16, 3, 28, 28)).astype("float32")
    labels = rs.randint(0, 10, 16).astype("float32")

    def synthetic(pkg):
        return lambda args, kv: (pkg.io.NDArrayIter(images, labels, 8), None)

    common = ["--num-epochs", "1", "--lr", "0.05", "--batch-size", "8"]
    cases = [
        ("lenet/MNISTIter", jlenet, plenet, {}, common + [
            "--network", "lenet", "--data-dir", str(tmp_path)],
         jmnist.get_iterators, pmnist.get_iterators),
    ] + [
        (f"resnet-v{v}", jresnet, presnet,
         {"num_layers": 8, "image_shape": "3,28,28", "version": v},
         common + ["--network", "resnet"], synthetic(jmx), synthetic(mx))
        for v in (1, 2)]
    for case, jsym, psym, kw, argv, jload, pload in cases:
        out = []
        for pkg, fit, data, symmod, load in (
                (jmx, jfit, jdata, jsym, jload),
                (mx, pfit, pdata, psym, pload)):
            args = _ic_args(fit, data, argv, pkg is mx)
            mx.random.seed(4)
            with jax_host_seed(4):
                model = fit.fit(args, symmod.get_symbol(num_classes=10, **kw),
                                load)
            arg, aux = model.get_params()
            out.append({k: v.asnumpy() for k, v in {**arg, **aux}.items()})
        assert sorted(out[1]) == sorted(out[0]), case
        for k in out[0]:
            _close(out[1][k], out[0][k], what=f"{case}: {k}")

    # the quirks: Module.fit's arguments, from each recipe
    for pkg, fit, data in ((jmx, jfit, jdata), (mx, pfit, pdata)):
        seen = []
        monkeypatch.setattr(pkg.mod.Module, "fit",
                            lambda self, train, **k: seen.append(k))
        for dtype in ("float32", "float16"):
            for load in (lambda a, kv: (pkg.io.MNISTIter(
                    image=str(tmp_path / "train-images-idx3-ubyte"),
                    label=str(tmp_path / "train-labels-idx1-ubyte"),
                    batch_size=8), None), synthetic(pkg)):
                args = _ic_args(fit, data, common + [
                    "--lr-step-epochs", "10,20", "--dtype", dtype], pkg is mx)
                fit.fit(args, plenet.get_symbol() if pkg is mx
                        else jlenet.get_symbol(), load)
        steps = [k["optimizer_params"]["lr_scheduler"].step for k in seen]
        # MNISTIter has no .idx: one batch an epoch; NDArrayIter's 16 / 8
        assert steps == [[10, 20], [20, 40]] * 2, (pkg.__name__, steps)
        assert [sorted(k["optimizer_params"]) for k in seen[:2]] == \
            [sorted(k["optimizer_params"]) for k in seen[2:]]
    monkeypatch.undo()

    _seeded_xavier(monkeypatch)
    sys.path.insert(0, IC)
    try:
        jft = _load("example/image-classification/fine_tune.py", "jax_ft")
        pft = _load("example/image-classification/fine_tune_torch.py",
                    "port_ft")
    finally:
        sys.path.remove(IC)
    want = jft.demo(verbose=False)
    with mx.cpu():
        got = pft.demo(verbose=False)
    assert got == want and got[0], (got, want)


# ------------------------------------------------------- slice 11: the GANs
def _seeded_normal(monkeypatch):
    """Both packages' ``init.Normal(σ)`` fill each parameter from its name
    (``_seeded``'s values scaled by σ / 0.2; BatchNorm's gamma, beta and
    statistics keep their own initializers)."""

    def make(base, copy):
        class Seeded(base.Initializer):
            def __init__(self, sigma=0.01):
                super().__init__()
                self.sigma = sigma

            def _init_weight(self, name, arr):
                copy(arr, _seeded(name, tuple(arr.shape)) * (self.sigma / 0.2))

        return Seeded

    def jcopy(arr, v):
        arr[:] = v

    def pcopy(arr, v):
        arr.copy_(torch.from_numpy(v.astype("float32")))

    monkeypatch.setattr(jmx.init, "Normal", make(jmx.init, jcopy))
    monkeypatch.setattr(mx.init, "Normal", make(mx.init, pcopy))


def _trainable(nets):
    return {re.sub(r"^[a-z]+\d+_", "", k): p.data().asnumpy()
            for net in nets for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def _hybridized(build):
    def make(*args, **kwargs):
        net = build(*args, **kwargs)
        net.hybridize()
        return net
    return make


def _gan_iteration(pkg, nets, data, noise, opt, ctx, dtype="float32",
                   values=None):
    """One D and G iteration (``chip_smoke.dcgan_d_step`` and
    ``dcgan_g_step``) of the initialized ``nets`` (their trainable
    parameters set from ``values`` by name, if given, and cast to
    ``dtype``): (errD, errG, D's logits, {name: gradient}, {name: weight
    after Adam})."""
    cs = _load("chip_smoke.py", "chip_smoke_gan")
    for net in nets:
        for k, p in net.collect_params().items():
            if dtype != "float32":
                p.cast(dtype)
            if values is not None and k in values:
                p.set_data(pkg.nd.array(values[k], ctx=ctx, dtype=dtype))
    tr_g, tr_d = (pkg.gluon.Trainer(n.collect_params(), "adam", dict(opt))
                  for n in nets)
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()

    def arr(a):
        return pkg.nd.array(a, ctx=ctx, dtype=dtype)

    n = data.shape[0]
    real, fake = arr(np.ones(n)), arr(np.zeros(n))
    err_d, logits = cs.dcgan_d_step(pkg, *nets, tr_d, loss_fn, arr(data),
                                    arr(noise), real, fake)
    grads = {k: p.grad.asnumpy() for k, p in nets[1].collect_params().items()
             if p.grad_req != "null"}
    err_g = cs.dcgan_g_step(pkg, *nets, tr_g, loss_fn, arr(noise), real)
    grads.update({k: p.grad.asnumpy() for k, p in
                  nets[0].collect_params().items() if p.grad_req != "null"})
    after = {k: p.data().asnumpy() for net in nets
             for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return err_d.asnumpy(), err_g.asnumpy(), logits.asnumpy(), grads, after


def _adam_allowance(port, port64, opt, batch):
    """Per entry, ``_adam_rounding_allowance`` (``2·|∂w/∂g|·δg``, δg the
    tensor's largest |float32 − float64| gradient of the port's iteration).
    MXNet's Adam adds ε to √v before the bias correction and takes the
    gradient scaled by 1/batch (``trainer.step(batch)``), so its first step
    is optax's on the unscaled gradient with ε·batch / √(1 − β2)."""
    from test_torch_data_parallel import _adam_rounding_allowance
    beta2, eps = 0.999, 1e-8 * batch
    return _adam_rounding_allowance(
        [{k: (torch.from_numpy(port[3][k]).double(),
              torch.from_numpy(port64[3][k])) for k in port64[3]}],
        opt["learning_rate"], opt["beta1"], beta2,
        eps / np.sqrt(1.0 - beta2))


def _check_weights(got, want, allowance):
    from test_torch_data_parallel import _close_within
    strip = {re.sub(r"^[a-z]+\d+_", "", k): k for k in allowance}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        key = strip.get(re.sub(r"^[a-z]+\d+_", "", k), k)
        _close_within(got[k], w, allowance[key], what=k)


def test_dcgan_twin_iteration_matches_the_jax_recipe(monkeypatch):
    """``dcgan_torch.train`` against the JAX recipe's ``train`` (the
    recipe's nets, Adam lr 2e-3, β1 0.5, batch 8; the JAX nets
    hybridized), from the same name-seeded ``Normal(0.02)`` weights: errD
    and errG of one iteration within ``TOL``, and every trainable weight
    after it within ``TOL`` of its largest or Adam's response to the
    float32 rounding of its gradient (the port's iteration repeated in
    float32 and float64)."""
    _seeded_normal(monkeypatch)
    jr = _load("example/gluon/dcgan.py", "jax_dcgan")
    pr = _load("example/gluon/dcgan_torch.py", "port_dcgan")
    monkeypatch.setattr(jr, "build_generator",
                        _hybridized(jr.build_generator))
    monkeypatch.setattr(jr, "build_discriminator",
                        _hybridized(jr.build_discriminator))
    jg, jd, jh = jr.train(epochs=1, batch=8, steps_per_epoch=1,
                          verbose=False)
    pg, pd, ph = pr.train(epochs=1, batch=8, steps_per_epoch=1,
                          verbose=False, ctx=mx.cpu())
    np.testing.assert_allclose(ph, jh, rtol=TOL)
    rng = np.random.RandomState(0)              # train()'s first batch
    data = pr.real_batch(rng, 8)
    noise = rng.randn(8, 16, 1, 1).astype("float32")
    opt = {"learning_rate": 2e-3, "beta1": 0.5}
    runs = []
    with mx.cpu():
        for dtype in ("float32", "float64"):
            nets = pr.build_generator(), pr.build_discriminator()
            for net in nets:
                net.initialize(mx.init.Normal(0.02))
            runs.append(_gan_iteration(mx, nets, data, noise, opt,
                                       mx.cpu(), dtype))
    _close(runs[0][0].mean(), ph[0][0], what="errD")
    _check_weights({k: p.data().asnumpy() for net in (pg, pd)
                    for k, p in net.collect_params().items()
                    if p.grad_req != "null"},
                   {k: p.data().asnumpy() for net in (jg, jd)
                    for k, p in net.collect_params().items()
                    if p.grad_req != "null"},
                   _adam_allowance(runs[0], runs[1], opt, 8))


def test_dcgan64_iteration_matches_jax():
    """``chip_smoke.build_dcgan64`` (route H's nets) at ngf = ndf = 8 built
    from each package's ``gluon.nn`` (the JAX nets hybridized), one
    iteration of ``chip_smoke.dcgan_d_step`` and ``dcgan_g_step`` at batch
    4 on 64x64x3 images from the same weights: the losses and D's logits
    within ``TOL``, and every weight after Adam within ``TOL`` of its
    largest or Adam's response to the float32 rounding of its gradient
    (from the port's iteration in float32 and float64)."""
    cs = _load("chip_smoke.py", "chip_smoke_gan")
    rs = np.random.RandomState(0)
    data = rs.uniform(-1, 1, (4, 3, 64, 64)).astype("float32")
    noise = rs.randn(4, 100, 1, 1).astype("float32")
    opt = {"learning_rate": 2e-4, "beta1": 0.5}

    def nets(pkg, ctx, hybridize=False):
        out = cs.build_dcgan64(pkg.gluon.nn, ngf=8, ndf=8)
        for net in out:
            net.initialize(ctx=ctx)
            if hybridize:
                net.hybridize()
        return out

    jnets = nets(jmx, jmx.cpu(), True)
    with jmx.autograd.pause():
        jnets[1](jnets[0](jmx.nd.array(noise)))
    values = {k: _seeded(k, p.shape) * 0.1 for net in jnets
              for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    want = _gan_iteration(jmx, jnets, data, noise, opt, jmx.cpu(),
                          values=values)
    runs = []
    with mx.cpu():
        for dtype in ("float32", "float64"):
            pnets = nets(mx, mx.cpu())
            with mx.autograd.pause():
                pnets[1](pnets[0](mx.nd.array(noise)))
            runs.append(_gan_iteration(mx, pnets, data, noise, opt,
                                       mx.cpu(), dtype, values))
    for i, what in enumerate(("errD", "errG", "D's logits")):
        _close(runs[0][i], want[i], what=what)
    _check_weights(runs[0][4], want[4], _adam_allowance(*runs, opt, 4))


def _recording_ctc(pkg, seen):
    """A ``CTCLoss`` subclass for ``pkg`` that keeps each call's mean
    loss in ``seen``; the JAX one runs hybridized (its graph path: one
    program, where its eager path traces optax's scan at every call;
    ``tests/test_torch_gluon_losses.py`` holds both paths)."""
    class Recording(pkg.gluon.loss.CTCLoss):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if pkg is jmx:
                self.hybridize()

        def __call__(self, *args):
            out = super().__call__(*args)
            seen.append(float(out.asnumpy().mean()))
            return out

    return Recording


def test_ctc_twins_match_the_jax_recipes(monkeypatch):
    """``lstm_ocr_torch.train`` (two epochs of one step at batch 16) and
    ``speech_ctc_torch.train`` (one epoch of two steps of 128) against the
    JAX recipes from the same name-seeded ``Xavier`` weights: every step's
    CTC loss (recorded through a ``CTCLoss`` subclass patched into both
    packages, hybridized in the JAX one), the recipes' returned first and
    last losses, and the speech recipe's phone error rates."""
    _seeded_xavier(monkeypatch)
    jseen, pseen = [], []
    monkeypatch.setattr(jmx.gluon.loss, "CTCLoss", _recording_ctc(jmx, jseen))
    monkeypatch.setattr(mx.gluon.loss, "CTCLoss", _recording_ctc(mx, pseen))
    jo = _load("example/ctc/lstm_ocr.py", "jax_lstm_ocr")
    po = _load("example/ctc/lstm_ocr_torch.py", "port_lstm_ocr")
    want = jo.train(epochs=2, batch=16, steps_per_epoch=1, verbose=False)
    got = po.train(epochs=2, batch=16, steps_per_epoch=1, verbose=False,
                   ctx=mx.cpu())
    np.testing.assert_allclose(pseen, jseen, rtol=TOL)
    np.testing.assert_allclose(got[:2], want[:2], rtol=TOL)
    assert got[2] == want[2]
    del jseen[:], pseen[:]
    js = _load("example/speech_recognition/speech_ctc.py", "jax_speech")
    ps = _load("example/speech_recognition/speech_ctc_torch.py",
               "port_speech")
    want = js.train(epochs=1, batch_size=128, verbose=False)
    got = ps.train(epochs=1, batch_size=128, verbose=False, ctx=mx.cpu())
    assert len(jseen) == 2
    np.testing.assert_allclose(pseen, jseen, rtol=TOL)
    assert got == want


# ------------------------------------------- slice 12: four small recipes
def _numpy_noise(monkeypatch, pkg, ctx, seed=5):
    """``pkg.nd.random_normal``/``random_uniform`` replaced by draws from
    one numpy stream (seeded ``seed``), the same values in both packages
    when they draw in the same order."""
    rs = np.random.RandomState(seed)

    def draw(kind):
        def fn(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
               low=None, high=None, **kw):
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            if kind == "normal":
                v = rs.normal(loc, scale, shape)
            else:
                v = rs.uniform(0.0 if low is None else low,
                               1.0 if high is None else high, shape)
            return pkg.nd.array(v.astype(dtype), ctx=ctx)
        return fn

    monkeypatch.setattr(pkg.nd, "random_normal", draw("normal"),
                        raising=False)
    monkeypatch.setattr(pkg.nd, "random_uniform", draw("uniform"),
                        raising=False)


SLICE_12_TWINS = (
    # (recipe, parity run's arguments, the JAX test's bar on train()'s
    # defaults)
    ("example/capsnet/capsnet", {"epochs": 1},
     lambda r: r[1] > 0.9),
    ("example/vae/vae", {"epochs": 2},
     lambda r: r[1] < r[0] * 0.5),
    ("example/restricted-boltzmann-machine/rbm", {"epochs": 2},
     lambda r: r[1] < r[0] * 0.6),
    ("example/bayesian-methods/bbb", {"epochs": 10},
     lambda r: r[1] < r[0] * 0.4 and 0.005 < r[2] < 0.5),
    # slice 14: the R-CNN recipe (MultiProposal, ROIPooling, two heads)
    ("example/rcnn/mini_rcnn", {"steps": 3},
     lambda r: r[1] < r[0] * 0.2 and r[2] > 0.5),
)


# the JAX recipes' blocks that run hybridized in the parity run (the same
# arithmetic in one program; the JAX CapsNet op by op compiles each op)
JAX_HYBRIDIZED = {"capsnet": "CapsNet"}


def _hybridize_on_init(cls):
    """``cls`` (a class of a module loaded for one test) hybridizes each
    block it makes."""
    init = cls.__init__

    def hybridized(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.hybridize()

    cls.__init__ = hybridized


def test_slice_12_twins_match_the_jax_recipes(monkeypatch):
    """``capsnet_torch``, ``vae_torch``, ``rbm_torch`` and ``bbb_torch``
    against their JAX recipes at a few epochs, from the same name-seeded
    ``Xavier`` weights (the RBM's are numpy's in both) and the same numpy
    noise in place of ``random_normal``/``random_uniform``: ``train()``'s
    returns and every step's loss where the recipe has one (CapsNet's
    margin loss, the VAE's -ELBO; the JAX CapsNet hybridized,
    ``JAX_HYBRIDIZED``). Then each twin alone, at ``train()``'s
    defaults with the port's own random ops, meets its JAX test's bar
    (``tests/test_examples.py``). And slice 13's sparse twin against its
    JAX recipe (``_sparse_twin_matches_the_jax_recipe``), and slice 14's
    ``mini_rcnn_torch`` against ``mini_rcnn`` at three steps (losses and
    the detection IoU)."""
    _seeded_xavier(monkeypatch)
    failed = []
    for rel, args, bar in SLICE_12_TWINS:
        name = os.path.basename(rel)
        results = []
        for pkg, path in ((jmx, rel + ".py"), (mx, rel + "_torch.py")):
            module = _load(path, f"{name}_{pkg.__name__}")
            if pkg is jmx and name in JAX_HYBRIDIZED:
                _hybridize_on_init(getattr(module, JAX_HYBRIDIZED[name]))
            seen = []
            for loss in ("margin_loss", "elbo_loss"):
                if hasattr(module, loss):
                    fn = getattr(module, loss)

                    def recording(*a, _fn=fn):
                        out = _fn(*a)
                        seen.append(float(out.asnumpy()))
                        return out
                    setattr(module, loss, recording)
            with monkeypatch.context() as m:
                _numpy_noise(m, pkg, None)
                kw = dict(args, verbose=False)
                if pkg is mx:
                    kw["ctx"] = mx.cpu()
                results.append((module.train(**kw), seen))
        (want, jseen), (got, pseen) = results
        try:
            assert len(pseen) == len(jseen) and \
                bool(pseen) == (name in ("capsnet", "vae")), (pseen, jseen)
            np.testing.assert_allclose(pseen, jseen, rtol=TOL)
            np.testing.assert_allclose(got, want, rtol=TOL)
        except AssertionError as e:
            failed.append(f"{name}: {e}")
        twin = _load(rel + "_torch.py", f"{name}_bar")
        result = twin.train(verbose=False, ctx=mx.cpu())
        if not bar(result):
            failed.append(f"{name}: {result} misses the JAX test's bar")
    try:
        _sparse_twin_matches_the_jax_recipe(monkeypatch)
    except AssertionError as e:
        failed.append(f"linear_classification: {e}")
    assert not failed, "\n".join(failed)


def _sparse_twin_matches_the_jax_recipe(monkeypatch):
    """``example/sparse/linear_classification_torch.py`` (slice 13: CSR
    batches, ``sp.dot``, the row_sparse gradient, the lazy updater)
    against the JAX recipe at one epoch (the JAX recipe compiles for each
    batch's count of touched features: its default fifteen take a minute
    here): ``train()``'s accuracies equal, the trained weight and bias
    within 1e-5 of the JAX recipe's. Then the twin alone at its defaults
    meets the JAX test's bar (above 0.9)."""
    runs = []
    for pkg, path in ((jmx, "example/sparse/linear_classification.py"),
                      (mx, "example/sparse/linear_classification_torch.py")):
        module = _load(path, f"linear_classification_{pkg.__name__}")
        trained = {}

        def recording(opt, _real=pkg.optimizer.get_updater, _seen=trained):
            updater = _real(opt)

            def call(index, grad, weight):
                _seen[index] = weight
                updater(index, grad, weight)
            return call

        kw = {"verbose": False, "epochs": 1}
        if pkg is mx:
            kw["ctx"] = mx.cpu()
        with monkeypatch.context() as m:
            m.setattr(module.opt_mod, "get_updater", recording)
            result = module.train(**kw)
        runs.append((result, [trained[i].asnumpy() for i in (0, 1)]))
    (want, jw), (got, pw) = runs
    assert got == want, (got, want)
    for g, w in zip(pw, jw):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    result = module.train(verbose=False, ctx=mx.cpu())
    assert result[1] > 0.9, result

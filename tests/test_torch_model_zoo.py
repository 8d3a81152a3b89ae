"""PyTorch port, ``gluon.model_zoo.vision`` against the JAX package.

* Names: every one of the 34 zoo models builds with the JAX net's
  parameter names and shapes (deferred axes as 0), its outer prefix
  (``resnetv10_``, ``densenet3_``, ...) the same but for the process-wide
  counter's digit.
* Forward: one net of each family at its smallest input, built in both
  packages with one prefix, the JAX net's weights (Xavier, and random
  BatchNorm statistics) carried across by name with
  ``interop.load_block_params``; inference outputs within 1e-5 of the
  largest logit (float32, another summation order). DenseNet's published
  widths take a minute of the JAX side's compile at its smallest input
  (224², fixed by its last 7×7 pool), so its family runs at narrow
  widths through the same ``DenseNet`` class; the others at their
  published widths, with 10 classes.
* The space-to-depth stem equals the plain 7×7 stem under the weight map
  ``W'[o, du, dv, (r, s, c)] = W[o, 2du+r, 2dv+s, c]`` (1e-5), and its
  net has the JAX net's parameter names and shapes.
* NHWC equals NCHW with the conv weights transposed, forward and every
  gradient (1e-5 relative to each tensor's largest entry).
* One fused ``DataParallelTrainer`` step of a narrow ResNet v1 (channels
  4–16) in NHWC at 16² (SGD, momentum 0.9, wd 1e-4, seeded weights),
  against the JAX trainer's: the loss, the weights and the moving
  statistics within 1e-5 relative.

Each JAX result is computed once a process, in the module-scoped
``jax_ref`` cache.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, gluon, interop, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
ZOO = sorted(vision._models)


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


@pytest.fixture(scope="module")
def jax_ref():
    """key -> the JAX result, computed at the first request."""
    cache = {}

    def get(key, compute):
        if key not in cache:
            cache[key] = compute()
        return cache[key]

    return get


def test_zoo_lists_the_jax_models():
    assert ZOO == sorted(jvision._models) and len(ZOO) == 34
    with pytest.raises(MXNetError, match="not in the zoo"):
        vision.get_model("resnet51_v1")
    with pytest.raises(MXNetError, match="pretrained"):
        vision.resnet18_v1(pretrained=True)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_parameter_names_and_shapes_match_jax(name):
    """Built, not initialized: names and (deferred) shapes only."""
    kw = {"classes": 10}
    jnet, net = jvision.get_model(name, **kw), vision.get_model(name, **kw)
    jp, p = jnet.collect_params(), net.collect_params()
    assert jnet.prefix.rstrip("_0123456789") == \
        net.prefix.rstrip("_0123456789")

    def table(params, prefix):
        return [(k[len(prefix):], tuple(v.shape or ())) for k, v in
                params.items()]

    assert table(p, net.prefix) == table(jp, jnet.prefix)


def _bn_values(rng, name, shape):
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape).astype("float32")
    if name.endswith(("running_mean", "beta")):
        return 0.1 * rng.randn(*shape).astype("float32")
    return (1.0 + 0.1 * rng.randn(*shape)).astype("float32")


def _jax_forward(make, x):
    """The JAX net's weights (Xavier; random BatchNorm statistics) and its
    inference output, hybridized (one XLA program)."""
    net = make(jvision)
    # forward only: no gradient buffers (the JAX package compiles a
    # zeros_like for each parameter shape it attaches one to)
    net.collect_params().setattr("grad_req", "null")
    net.initialize(jmx.init.Xavier())
    net.hybridize()
    net(jmx.nd.array(x))                     # finishes deferred shapes
    rng = np.random.RandomState(7)
    weights = {}
    for k, p in net.collect_params().items():
        v = p.data().asnumpy()
        if k.endswith(("gamma", "beta", "running_mean", "running_var")):
            v = _bn_values(rng, k, v.shape)
            p.set_data(jmx.nd.array(v))
        weights[k] = v
    return weights, net(jmx.nd.array(x)).asnumpy()


FAMILIES = {
    "resnet18_v1_nhwc": (lambda v: v.resnet18_v1(
        classes=10, layout="NHWC", prefix="resnet_"), (2, 32, 32, 3)),
    "resnet_v2_bottleneck": (lambda v: v.ResNetV2(
        v.BottleneckV2, [1, 1, 1, 1], [8, 16, 32, 48, 64], classes=10,
        prefix="resnet_"), (2, 3, 32, 32)),
    "alexnet": (lambda v: v.alexnet(classes=10, prefix="alexnet_"),
                (1, 3, 67, 67)),
    "vgg11_bn": (lambda v: v.vgg11_bn(classes=10, prefix="vgg_"),
                 (1, 3, 32, 32)),
    "squeezenet1.0": (lambda v: v.get_model(
        "squeezenet1.0", classes=10, prefix="squeeze_"), (1, 3, 51, 51)),
    "mobilenet0.25": (lambda v: v.get_model(
        "mobilenet0.25", classes=10, prefix="mobile_"), (1, 3, 32, 32)),
    "mobilenetv2_0.25": (lambda v: v.get_model(
        "mobilenetv2_0.25", classes=10, prefix="mobile_"), (1, 3, 32, 32)),
    "densenet_narrow": (lambda v: v.DenseNet(
        16, 8, [2, 2, 2, 2], classes=10, prefix="dense_"), (1, 3, 224, 224)),
    "inceptionv3": (lambda v: v.inception_v3(
        classes=10, prefix="inception_"), (1, 3, 299, 299)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zoo_family_forward_matches_jax(jax_ref, family):
    make, shape = FAMILIES[family]
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype("float32")
    weights, want = jax_ref(family, lambda: _jax_forward(make, x))
    with mx.cpu():
        net = make(vision)
        net.initialize()
        interop.load_block_params(net, weights)
        got = net(mx.nd.array(x)).asnumpy()
    _close(got, want, family)


def _s2d_weight(w):
    """(O, 7, 7, C) -> (O, 4, 4, 4C): the 7×7 stem's taps regrouped so
    a 4×4 conv over the space-to-depth input computes the same map."""
    o, _, _, c = w.shape
    out = np.zeros((o, 4, 4, 2, 2, c), w.dtype)
    for du in range(4):
        for dv in range(4):
            for r in range(2):
                for s in range(2):
                    if 2 * du + r < 7 and 2 * dv + s < 7:
                        out[:, du, dv, r, s] = w[:, 2 * du + r, 2 * dv + s]
    return out.reshape(o, 4, 4, 4 * c)


def test_space_to_depth_stem_equals_the_plain_stem():
    x = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        "float32")
    with mx.cpu():
        plain, s2d = (_narrow_resnet(gluon, "NHWC", stem_s2d=s2d)
                      for s2d in (False, True))
        jnet = _narrow_resnet(jgluon, "NHWC", stem_s2d=True)
        assert [(k, v.shape) for k, v in s2d.collect_params().items()] == \
            [(k, v.shape) for k, v in jnet.collect_params().items()]
        plain.initialize(mx.init.Xavier())
        want = plain(mx.nd.array(x)).asnumpy()
        w = interop.block_params_to_numpy(plain)
        assert w["narrow_conv2d0_weight"].shape == (4, 7, 7, 3)
        w["narrow_conv2d0_weight"] = _s2d_weight(w["narrow_conv2d0_weight"])
        assert list(s2d.collect_params().keys()) == list(w)
        s2d.initialize()
        interop.load_block_params(s2d, w)
        got = s2d(mx.nd.array(x)).asnumpy()
    _close(got, want, "s2d stem")
    with pytest.raises(MXNetError, match="NHWC"):
        vision.resnet18_v1(stem_s2d=True)


def _narrow_resnet(g, layout, **kw):
    return g.model_zoo.vision.ResNetV1(
        g.model_zoo.vision.BasicBlockV1, [1, 1, 1, 1], [4, 4, 8, 12, 16],
        classes=10, layout=layout, prefix="narrow_", **kw)


def _seeded(shapes):
    """Values for the narrow ResNet, drawn from a seed: weights at a
    scale of 1/√fan-in, random BatchNorm parameters and statistics."""
    rng = np.random.RandomState(5)
    out = {}
    for k, shape in shapes.items():
        if k.endswith(("gamma", "beta", "running_mean", "running_var")):
            out[k] = _bn_values(rng, k, shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            out[k] = (rng.randn(*shape) / np.sqrt(fan_in)).astype("float32")
    return out


def _nchw_shapes():
    with mx.cpu():
        net = _narrow_resnet(gluon, "NCHW")
        net.initialize()
        net(mx.nd.zeros((1, 3, 16, 16)))
        return {k: p.shape for k, p in net.collect_params().items()}


def _to_nhwc(v):
    return v.transpose(0, 2, 3, 1) if v.ndim == 4 else v


def test_nhwc_net_equals_nchw_net_with_transposed_weights():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (4, 3, 16, 16)).astype("float32")
    y = rng.randint(0, 10, 4).astype("float32")
    w = _seeded(_nchw_shapes())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    with mx.cpu():
        for layout in ("NCHW", "NHWC"):
            net = _narrow_resnet(gluon, layout)
            net.initialize()
            last = layout == "NHWC"
            interop.load_block_params(
                net, {k: _to_nhwc(v) if last else v for k, v in w.items()})
            with autograd.record():
                out = net(mx.nd.array(x.transpose(0, 2, 3, 1) if last
                                      else x))
                loss = loss_fn(out, mx.nd.array(y)).mean()
            loss.backward()
            runs.append((out.asnumpy(), {
                k: p.grad.asnumpy() if last else _to_nhwc(p.grad.asnumpy())
                for k, p in net.collect_params().items()
                if p.grad_req != "null"}))
    (out_c, g_c), (out_h, g_h) = runs
    _close(out_h, out_c, "logits")
    assert g_h.keys() == g_c.keys()
    for k, g in g_c.items():
        _close(g_h[k], g, k)


TRAIN = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})


def _train_batch():
    rng = np.random.RandomState(3)
    return (rng.uniform(-1, 1, (8, 16, 16, 3)).astype("float32"),
            rng.randint(0, 10, 8).astype("float32"))


def _jax_train(w0):
    net = _narrow_resnet(jgluon, "NHWC")
    net.initialize()
    x, y = _train_batch()
    net(jmx.nd.array(x))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(w0[k]))
    trainer = jparallel.DataParallelTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), TRAIN[0], dict(TRAIN[1]),
        mesh=jparallel.local_mesh("dp", devices=jax.devices()[:1]),
        passes=False)
    loss = float(trainer.step(jmx.nd.array(x), jmx.nd.array(y)))
    trainer.sync_to_net()
    return loss, {k: p.data().asnumpy()
                  for k, p in net.collect_params().items()}


def test_fused_resnet_step_matches_jax(jax_ref):
    w0 = {k: _to_nhwc(v) for k, v in _seeded(_nchw_shapes()).items()}
    jl, jw = jax_ref("train", lambda: _jax_train(w0))
    x, y = _train_batch()
    with mx.cpu():
        net = _narrow_resnet(gluon, "NHWC")
        net.initialize()
        interop.load_block_params(net, w0)
        trainer = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), TRAIN[0],
            dict(TRAIN[1]), mesh=parallel.local_mesh(devices=[mx.cpu()]))
        loss = float(trainer.step(mx.nd.array(x), mx.nd.array(y)))
        trainer.sync_to_net()
        got = interop.block_params_to_numpy(net)
    _close(loss, jl, "loss")
    assert got.keys() == jw.keys()
    for k, w in jw.items():
        _close(got[k], w, k)
        assert not np.array_equal(w, w0[k]), k

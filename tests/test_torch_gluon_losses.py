"""PyTorch port, slice 11's gluon layers against the JAX package's: the six
activations of ``gluon.nn`` (``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``,
``GELU``, ``Swish``), ``InstanceNorm`` and the losses of ``gluon.loss``
(the ten new ones and ``SigmoidBCELoss``), eager and hybridized, on the
same numpy inputs and the same parameter values: their outputs, the input
gradient under a seeded head gradient, and the parameters' gradients.

The JAX side runs each block hybridized (one program, the same
arithmetic as its eager run); ``CTCLoss``, whose eager and graph paths are
separate code in both packages, runs both ways there too. Each group is
one item that names the failing case. Tolerance: 2e-6 of the largest
|value| (float32; the CTC losses are float64, with float32 logits).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import once

TOL = 2e-6


def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


# ------------------------------------------------------------ the layers
def _layers(pkg):
    nn = pkg.gluon.nn
    return [("leaky_relu", nn.LeakyReLU(0.2), {}),
            ("prelu", nn.PReLU(), {"alpha": np.array([0.3], "float32")}),
            ("elu", nn.ELU(0.7), {}), ("selu", nn.SELU(), {}),
            ("gelu", nn.GELU(), {}), ("swish", nn.Swish(1.5), {}),
            ("instance_norm", nn.InstanceNorm(in_channels=3),
             {"gamma": _r(3, seed=1), "beta": _r(3, seed=2)}),
            ("instance_norm_deferred", nn.InstanceNorm(epsilon=1e-3),
             {"gamma": _r(3, seed=3), "beta": _r(3, seed=4)})]


X = np.concatenate([_r(2, 3, 4, 5), np.zeros((1, 3, 4, 5), "float32")])
HEAD = _r(3, 3, 4, 5, seed=7, lo=0.5, hi=1.5)


def _run_layer(pkg, block, values, hybridize, ctx):
    block.initialize(ctx=ctx)
    block(pkg.nd.array(X, ctx=ctx))              # finish deferred shapes
    params = block.collect_params()
    for name, p in params.items():
        for suffix, v in values.items():
            if name.endswith(suffix):
                p.set_data(pkg.nd.array(v, ctx=ctx))
    if hybridize:
        block.hybridize()
    x = pkg.nd.array(X, ctx=ctx)
    x.attach_grad()
    with pkg.autograd.record():
        y = block(x)
    y.backward(pkg.nd.array(HEAD, ctx=ctx))
    grads = {n.split("_", 1)[-1]: p.grad.asnumpy()
             for n, p in params.items() if p.grad_req != "null"}
    return y.asnumpy(), x.grad.asnumpy(), grads


def _jax_layers():
    return {cid: _run_layer(jmx, block, values, True, jmx.cpu())
            for cid, block, values in _layers(jmx)}


def _close(what, got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of {scale:.3e}"


def test_activation_and_instance_norm_layers_match_jax(tmp_path_factory):
    """Each layer eager and hybridized in the port against the JAX layer
    (inputs with zeros, where the leaky family switches branch; the
    ``InstanceNorm`` layer's epsilon 1e-5 and gamma always applied)."""
    want = once(tmp_path_factory, "gluon-layers-jax", _jax_layers)
    failed = []
    for hybridize in (False, True):
        for cid, block, values in _layers(mx):
            tag = f"{cid}{' hybridized' if hybridize else ''}"
            try:
                out, gx, grads = _run_layer(mx, block, values, hybridize,
                                            mx.cpu())
                w_out, w_gx, w_grads = want[cid]
                _close(tag, out, w_out)
                _close(tag + " dx", gx, w_gx)
                assert sorted(grads) == sorted(w_grads), (grads, w_grads)
                for k in grads:
                    _close(f"{tag} d{k}", grads[k], w_grads[k])
            except AssertionError as e:
                failed.append(str(e))
    assert not failed, "\n".join(failed)


# ------------------------------------------------------------ the losses
def _loss_cases(pkg):
    L = pkg.gluon.loss
    pred, label = _r(4, 6), _r(4, 6, seed=1)
    prob = _r(4, 6, seed=2, lo=0.05, hi=0.95)
    binary = (_r(4, 6, seed=3) > 0).astype("float32")
    signed = binary * 2 - 1
    sw = _r(4, 1, seed=4, lo=0.5, hi=1.5)
    dist = np.exp(_r(4, 6, seed=5))
    dist /= dist.sum(-1, keepdims=True)
    cos_label = np.array([1, -1, 1, -1], "float32")
    return [
        ("l1", L.L1Loss(), [pred, label]),
        ("l1_weighted", L.L1Loss(weight=0.5), [pred, label, sw]),
        ("sigmoid_bce", L.SigmoidBinaryCrossEntropyLoss(), [pred, binary]),
        ("sigmoid_bce_alias_weighted", L.SigmoidBCELoss(weight=2.0),
         [pred, binary, sw]),
        ("sigmoid_bce_from_sigmoid",
         L.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True), [prob, binary]),
        ("kl_div", L.KLDivLoss(), [np.log(dist[::-1].copy()), dist]),
        ("kl_div_logits", L.KLDivLoss(from_logits=False, axis=-1),
         [pred, dist]),
        ("huber", L.HuberLoss(rho=0.7), [pred, label]),
        ("hinge", L.HingeLoss(), [pred, signed]),
        ("squared_hinge", L.SquaredHingeLoss(margin=1.5), [pred, signed]),
        ("logistic_signed", L.LogisticLoss(), [pred, signed]),
        ("logistic_binary", L.LogisticLoss(label_format="binary"),
         [pred, binary]),
        ("triplet", L.TripletLoss(margin=0.5),
         [pred, label, _r(4, 6, seed=6)]),
        ("cosine_embedding", L.CosineEmbeddingLoss(margin=0.1),
         [pred, label, cos_label]),
    ]


CTC_X = _r(3, 7, 5, seed=8)                       # (N, T, C), blank C-1
CTC_LABEL = np.array([[0, 1, 1], [2, -1, -1], [3, 3, 3]], "float32")


def _ctc_cases(pkg):
    L = pkg.gluon.loss
    return [
        ("ctc_ntc", L.CTCLoss(), [CTC_X, CTC_LABEL]),
        ("ctc_tnc_tn", L.CTCLoss(layout="TNC", label_layout="TN"),
         [CTC_X.transpose(1, 0, 2).copy(), CTC_LABEL.T.copy()]),
        ("ctc_lengths", L.CTCLoss(),
         [CTC_X, np.abs(CTC_LABEL), np.array([7, 5, 6], "float32"),
          np.array([3, 1, 2], "float32")]),
    ]


def _run_loss(pkg, block, inputs, hybridize, ctx):
    if hybridize:
        block.hybridize()
    arrays = [pkg.nd.array(a, ctx=ctx) for a in inputs]
    arrays[0].attach_grad()
    with pkg.autograd.record():
        out = block(*arrays)
    head = np.random.RandomState(3).uniform(0.5, 1.5, out.shape)
    out.backward(pkg.nd.array(head.astype(out.dtype), ctx=ctx,
                              dtype=out.dtype))
    return out.asnumpy(), arrays[0].grad.asnumpy()


# the JAX CTCLoss's graph path is taken for this case, its eager path for
# the others (the port runs every case both ways)
JAX_CTC_GRAPH = ("ctc_tnc_tn",)
# a hybridized JAX CosineEmbeddingLoss raises (its graph's ``where`` does
# not bind its third input: KeyError 'where1_y'); it runs eagerly there
JAX_EAGER_ONLY = ("cosine_embedding",)


def _jax_losses():
    out = {cid: _run_loss(jmx, block, inputs, cid not in JAX_EAGER_ONLY,
                          jmx.cpu())
           for cid, block, inputs in _loss_cases(jmx)}
    for cid, block, inputs in _ctc_cases(jmx):
        out[cid] = _run_loss(jmx, block, inputs, cid in JAX_CTC_GRAPH,
                             jmx.cpu())
    out["ctc_weighted"] = _weighted_ctc(jmx)
    return out


def _weighted_ctc(pkg):
    """The eager ``CTCLoss`` with ``weight`` and ``sample_weight`` given."""
    ctx = pkg.cpu()
    return pkg.gluon.loss.CTCLoss(weight=3.0)(
        pkg.nd.array(CTC_X, ctx=ctx), pkg.nd.array(CTC_LABEL, ctx=ctx),
        None, None, pkg.nd.array(np.full((3, 1), 5, "float32"),
                                 ctx=ctx)).asnumpy()


def test_losses_match_jax(tmp_path_factory):
    """Every loss, eager and hybridized in the port, against the JAX loss
    hybridized (``CosineEmbeddingLoss`` eager: hybridized it raises in the
    JAX package, pinned here); ``CTCLoss`` through both of its paths in
    both packages (NTC and TNC/TN layouts, −1 padding or explicit
    lengths; the JAX graph path on the TNC case, its eager path on the
    others). Pinned JAX-side behaviour: ``CTCLoss`` applies neither
    ``weight`` nor ``sample_weight``."""
    cid, block, inputs = _loss_cases(jmx)[-1]
    with pytest.raises(KeyError, match="where"):
        _run_loss(jmx, block, inputs, True, jmx.cpu())
    want = once(tmp_path_factory, "gluon-losses-jax", _jax_losses)
    # pinned JAX-side behaviour, copied: CTCLoss applies neither weight
    # nor sample_weight
    np.testing.assert_array_equal(want["ctc_weighted"], want["ctc_ntc"][0])
    np.testing.assert_array_equal(_weighted_ctc(mx), _run_loss(
        mx, mx.gluon.loss.CTCLoss(), [CTC_X, CTC_LABEL], False,
        mx.cpu())[0])
    failed = []
    for hybridize in (False, True):
        for cid, block, inputs in _loss_cases(mx):
            key = cid
            try:
                got = _run_loss(mx, block, inputs, hybridize, mx.cpu())
                _close(f"{cid} h={hybridize}", got[0], want[key][0])
                _close(f"{cid} h={hybridize} grad", got[1], want[key][1])
            except AssertionError as e:
                failed.append(str(e))
        for cid, block, inputs in _ctc_cases(mx):
            try:
                out, g = _run_loss(mx, block, inputs, hybridize, mx.cpu())
                w_out, w_g = want[cid]
                assert out.dtype == w_out.dtype == np.float64, cid
                _close(f"{cid} h={hybridize}", out, w_out)
                _close(f"{cid} h={hybridize} grad", g, w_g)
            except AssertionError as e:
                failed.append(str(e))
    assert not failed, "\n".join(failed)


def test_loss_quirks_of_the_jax_package_are_kept():
    """Pinned JAX-side behaviours, in both packages: ``pos_weight`` is
    accepted and ignored by ``SigmoidBinaryCrossEntropyLoss``;
    ``KLDivLoss`` adds 1e-12 inside its log (a zero label costs nothing,
    not NaN) and ``CosineEmbeddingLoss`` 1e-12 to its norms' product (a
    zero input gives cos 0, not NaN). (``CTCLoss``'s unweighted output is
    pinned in ``test_losses_match_jax``.)"""
    pred, binary = _r(4, 6), (_r(4, 6, seed=3) > 0).astype("float32")
    zero = np.zeros((2, 6), "float32")
    for pkg in (jmx, mx):
        ctx = pkg.cpu()

        def arr(a):
            return pkg.nd.array(a, ctx=ctx)

        L = pkg.gluon.loss
        bce = L.SigmoidBinaryCrossEntropyLoss()
        np.testing.assert_array_equal(
            bce(arr(pred), arr(binary), None, arr(pred * 9)).asnumpy(),
            bce(arr(pred), arr(binary)).asnumpy())
        kl = L.KLDivLoss()(arr(pred[:2]), arr(zero)).asnumpy()
        np.testing.assert_array_equal(kl, np.zeros(2, "float32"))
        cos = L.CosineEmbeddingLoss()(arr(zero), arr(pred[:2]),
                                      arr(np.ones(2, "float32"))).asnumpy()
        np.testing.assert_array_equal(cos, np.ones(2, "float32"))

"""PyTorch port, the detection family: ``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``, ``box_nms`` and ``box_iou``
(``mxnet_tpu_torch/ops/multibox.py``), ``smooth_l1``,
``L2Normalization``, ``Variable``'s attributes and ``AttrScope``, and
``SoftmaxOutput``'s ignored labels, each against its JAX twin on the same
numpy inputs at small sizes.

Tolerances: whatever is discrete (classes, masks, targets' classes, the
kept rows and their order, ties included) must be equal; anchors, IoUs,
boxes and scores within 1e-6 of the largest entry (the same float32
arithmetic; the decode's ``exp`` may round differently); losses and
normalizations and their gradients within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops import multibox
from mxnet_tpu_torch.ops.registry import get_op as torch_op
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
TOL_BOX = 1e-6


def _jax(name, *arrays, **attrs):
    """The JAX op as one jitted program (one compile, where the op's
    primitives would each compile eagerly)."""
    fn = jax.jit(lambda *a: jax_op(name).fn(*a, **attrs))
    out = fn(*[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in out] if isinstance(out, tuple) \
        else np.asarray(out)


def _port(name, *arrays, **attrs):
    out = torch_op(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                            **attrs)
    return [o.numpy() for o in out] if isinstance(out, tuple) \
        else out.numpy()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _rs(seed):
    return np.random.RandomState(seed)


def _cases(check, cases):
    """``check`` on each case in turn; a failure names its case."""
    for cid, *args in cases:
        try:
            check(*args)
        except AssertionError as e:
            raise AssertionError(f"case {cid}: {e}") from e


# ------------------------------------------------------------ the anchors
PRIOR_CASES = [
    ("clip", 4, 4, dict(sizes=(0.3, 0.4), ratios=(1.0, 2.0, 0.5), clip=True)),
    ("steps_offsets", 3, 5, dict(sizes=(0.2,),
                                 ratios=(1.0, 2.0, 0.5, 3.0, 1.0 / 3),
                                 steps=(0.25, 0.2), offsets=(0.4, 0.6))),
    ("wide", 2, 3, dict(sizes=(0.88, 0.961), ratios=(1.0, 2.0, 0.5),
                        clip=False)),
]


def test_multibox_prior_matches_jax_and_is_cached():
    _cases(_check_prior, PRIOR_CASES)


def _check_prior(h, w, attrs):
    """The anchors of a feature map equal the JAX op's; a second call with
    the same shape and attributes returns the cached tensor (not an
    inference tensor, so a training graph may use it)."""
    data = np.zeros((2, 3, h, w), "float32")
    want = _jax("_contrib_MultiBoxPrior", data, **attrs)
    x = torch.zeros(2, 3, h, w)
    with torch.inference_mode():
        got = torch_op("_contrib_MultiBoxPrior").fn(x, **attrs)
    assert not got.is_inference()
    assert torch_op("_contrib_MultiBoxPrior").fn(x, **attrs) is got
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL_BOX)
    n = len(attrs["sizes"]) + len(attrs["ratios"]) - 1
    assert got.shape == (1, h * w * n, 4)
    f64 = torch_op("_contrib_MultiBoxPrior").fn(x.double(), **attrs)
    assert f64.dtype == torch.float64
    _close(f64.numpy(), want, TOL_BOX)


# ------------------------------------------------------------ the targets
def _anchors():
    return _jax("_contrib_MultiBoxPrior", np.zeros((1, 1, 4, 4), "float32"),
                sizes=(0.3, 0.45), ratios=(1.0, 2.0, 0.5), clip=True)


def _labels():
    """Three samples of up to four objects, −1 padded: one with a padded
    row between valid ones, one whose two objects share their best anchor
    (the later one wins the force match), one with none at all."""
    lab = np.full((3, 4, 5), -1.0, "float32")
    lab[0, 0] = (1, 0.0, 0.0, 0.2, 0.2)       # best anchor is anchor 0
    lab[0, 2] = (0, 0.5, 0.4, 0.95, 0.9)
    lab[0, 3] = (2, 0.3, 0.55, 0.6, 0.85)
    lab[1, 0] = (0, 0.40, 0.40, 0.62, 0.62)
    lab[1, 1] = (2, 0.41, 0.41, 0.61, 0.61)
    lab[1, 2] = (1, 0.05, 0.6, 0.35, 0.98)
    return lab


TARGET_CASES = [
    ("mining", "random", dict(negative_mining_ratio=3.0,
                              negative_mining_thresh=0.5)),
    ("mining_ties", "ties", dict(negative_mining_ratio=3.0,
                                 negative_mining_thresh=0.5)),
    ("mining_min_ties", "ties", dict(negative_mining_ratio=2.0,
                                     negative_mining_thresh=0.4,
                                     minimum_negative_samples=5,
                                     ignore_label=-2.0)),
    ("no_mining", "random", dict(overlap_threshold=0.3,
                                 variances=(0.1, 0.1, 0.3, 0.3))),
]


def test_multibox_target_matches_jax():
    _cases(_check_target, TARGET_CASES)


def _check_target(pred, attrs):
    """Matching, the force match (a padded row must not clobber anchor 0's
    claim; of two objects with one best anchor the later wins) and
    hard-negative mining, whose ranking is a stable sort: with equal
    hardness (all-zero predictions) the earlier anchors are taken, as in
    the JAX op."""
    anchors, label = _anchors(), _labels()
    n = anchors.shape[1]
    cls_pred = _rs(3).randn(3, 4, n).astype("float32") if pred == "random" \
        else np.zeros((3, 4, n), "float32")
    want = _jax("_contrib_MultiBoxTarget", anchors, label, cls_pred, **attrs)
    got = _port("_contrib_MultiBoxTarget", anchors, label, cls_pred, **attrs)
    np.testing.assert_array_equal(got[2], want[2])            # cls_target
    np.testing.assert_array_equal(got[1], want[1])            # loc_mask
    _close(got[0], want[0], TOL_BOX)
    assert got[2][0, 0] == 2.0                  # anchor 0 is object 0's
    if "negative_mining_ratio" in attrs:        # no positives: the minimum
        assert (got[2][2] == 0).sum() == attrs.get(
            "minimum_negative_samples", 0)


# ------------------------------------------------------------ detection
def _det_inputs(seed, n_anchor_side=4, tie=False):
    anchors = _jax("_contrib_MultiBoxPrior",
                   np.zeros((1, 1, n_anchor_side, n_anchor_side), "float32"),
                   sizes=(0.3, 0.45), ratios=(1.0, 2.0, 0.5), clip=True)
    n = anchors.shape[1]
    rs = _rs(seed)
    logits = rs.randn(2, 4, n).astype("float32") * 2
    if tie:         # scores that tie on purpose: two logit levels
        logits = np.round(logits).clip(-1, 1).astype("float32")
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))
    loc = (rs.randn(2, n * 4) * 0.5).astype("float32")
    return prob, loc, anchors


DETECTION_CASES = [
    ("topk_below", 0, False, dict(nms_threshold=0.45, nms_topk=20,
                                  threshold=0.2)),
    ("topk_above", 1, False, dict(nms_threshold=0.3, nms_topk=500,
                                  threshold=0.01)),
    ("ties", 2, True, dict(nms_threshold=0.5, threshold=0.1)),
    ("ties_force", 3, True, dict(nms_threshold=0.2, force_suppress=True,
                                 nms_topk=7)),
    ("background_2", 4, False, dict(nms_threshold=0.4, background_id=2,
                                    clip=False,
                                    variances=(0.2, 0.2, 0.1, 0.1))),
]


def test_multibox_detection_matches_jax(monkeypatch):
    _cases(_check_detection, DETECTION_CASES)
    _check_topk_prefix_only(monkeypatch)


def _check_detection(seed, tie, attrs):
    """The (B, N, 6) output: classes (−1 where a row is not kept) and the
    order of the rows equal, scores and boxes within TOL_BOX; ``nms_topk``
    below and above the candidate count, scores tied on purpose."""
    prob, loc, anchors = _det_inputs(seed, tie=tie)
    want = _jax("_contrib_MultiBoxDetection", prob, loc, anchors, **attrs)
    got = _port("_contrib_MultiBoxDetection", prob, loc, anchors, **attrs)
    assert got.shape == want.shape == (2, anchors.shape[1], 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    _close(got[..., 2:], want[..., 2:], TOL_BOX)
    kept = (got[..., 0] >= 0).sum()
    assert 0 < kept < got.shape[0] * got.shape[1]
    if tie:
        assert len(np.unique(got[..., 1])) < got.shape[1]


def _check_topk_prefix_only(monkeypatch):
    """At 2,000 anchors and ``nms_topk`` 50 the overlaps are taken only
    among the first 50 sorted rows (never an (N, N) matrix), and the rows
    after them are not kept; the prefix's result is the JAX op's on the
    same rows (held by the tests above)."""
    shapes = []
    real = multibox._corner_iou

    def spy(a, b):
        shapes.append(tuple(a.shape[-2:]) + tuple(b.shape[-2:]))
        return real(a, b)

    monkeypatch.setattr(multibox, "_corner_iou", spy)
    rs = _rs(5)
    n = 2000
    prob = torch.softmax(torch.from_numpy(rs.randn(2, 3, n).astype(
        "float32")), dim=1)
    loc = torch.from_numpy(rs.randn(2, 4 * n).astype("float32") * 0.1)
    corners = rs.rand(n, 2).astype("float32") * 0.8
    anchors = torch.from_numpy(np.concatenate(
        [corners, corners + 0.2], axis=1))[None]
    out = torch_op("_contrib_MultiBoxDetection").fn(
        prob, loc, anchors, nms_topk=50, threshold=0.01)
    assert shapes and max(max(s) for s in shapes) <= 50
    assert (out[:, 50:, 0] == -1).all()
    assert (out[:, :50, 0] >= 0).any()


# ------------------------------------------------------------ box_nms
def _nms_data(seed, lead=(2,), n=24, center=False):
    rs = _rs(seed)
    ids = rs.randint(0, 3, (*lead, n, 1)).astype("float32")
    score = np.round(rs.rand(*lead, n, 1), 1).astype("float32")   # ties
    xy = rs.rand(*lead, n, 2).astype("float32") * 0.6
    wh = rs.rand(*lead, n, 2).astype("float32") * 0.4 + 0.05
    box = np.concatenate([xy + wh / 2, wh] if center else [xy, xy + wh], -1)
    extra = rs.rand(*lead, n, 1).astype("float32")
    return np.concatenate([ids, score, box, extra], -1)


NMS_CASES = [
    ("topk_below", (2,), False, dict(overlap_thresh=0.3, valid_thresh=0.15,
                                     topk=8)),
    ("topk_above", (2,), False, dict(overlap_thresh=0.5, topk=100)),
    ("lead_dims_bg", (2, 2), False, dict(overlap_thresh=0.4,
                                         background_id=1)),
    ("force_to_center", (2,), False, dict(overlap_thresh=0.2,
                                          force_suppress=True,
                                          out_format="center")),
    ("center_in_no_id", (3,), True, dict(overlap_thresh=0.3,
                                         in_format="center",
                                         out_format="corner", id_index=-1)),
    ("center_both", (2,), True, dict(overlap_thresh=0.35, in_format="center",
                                     out_format="center", score_index=1)),
]


def test_box_nms_box_iou_and_names_match_jax():
    _cases(_check_box_nms, NMS_CASES)
    _cases(_check_box_iou, [("corner", "corner"), ("center", "center")])
    _check_names_and_aliases()


def _check_box_nms(lead, center, attrs):
    """Rows sorted by score (ties in anchor order), a row that is not kept
    all −1, the coordinates in ``out_format``: every entry equal but the
    converted coordinates (TOL_BOX)."""
    data = _nms_data(len(lead) + int(center), lead, center=center)
    want = _jax("_contrib_box_nms", data, **attrs)
    got = _port("_contrib_box_nms", data, **attrs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_array_equal(got[..., 6:], want[..., 6:])
    _close(got[..., 2:6], want[..., 2:6], TOL_BOX)
    assert 0 < (got[..., 0] == -1).sum() < got[..., 0].size


def _check_box_iou(fmt):
    rs = _rs(7)
    lhs = np.concatenate([rs.rand(2, 3, 2), rs.rand(2, 3, 2) + 0.1],
                         -1).astype("float32")
    rhs = np.concatenate([rs.rand(5, 2), rs.rand(5, 2) + 0.1],
                         -1).astype("float32")
    want = _jax("_contrib_box_iou", lhs, rhs, format=fmt)
    got = _port("_contrib_box_iou", lhs, rhs, format=fmt)
    assert got.shape == (2, 3, 5)
    _close(got, want, TOL_BOX)


def _check_names_and_aliases():
    for name, aliases in (
            ("_contrib_MultiBoxPrior", ["contrib_MultiBoxPrior"]),
            ("_contrib_MultiBoxTarget", ["contrib_MultiBoxTarget"]),
            ("_contrib_MultiBoxDetection", ["contrib_MultiBoxDetection"]),
            ("_contrib_box_nms", ["contrib_box_nms", "box_nms"]),
            ("_contrib_box_iou", ["contrib_box_iou"])):
        for a in aliases:
            assert torch_op(a) is torch_op(name)
        assert torch_op(name).differentiable is False
        assert torch_op(name).num_outputs == jax_op(name).num_outputs


# ------------------------------------------------------------ the losses
def _vjp_program(x, ct, name, attrs):
    out, vjp = jax.vjp(lambda a: jax_op(name).fn(a, **dict(attrs)), x)
    return out, vjp(ct)[0]


_vjp_program_jit = jax.jit(_vjp_program, static_argnums=(2, 3))


def _vjp_jax(name, x, ct, **attrs):
    out, g = _vjp_program_jit(jnp.asarray(x), jnp.asarray(ct), name,
                              tuple(sorted(attrs.items())))
    return np.asarray(out), np.asarray(g)


def _vjp_port(name, x, ct, **attrs):
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = torch_op(name).fn(t, **attrs)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), t.grad.numpy()


LOSS_CASES = [
    ("smooth_l1", "smooth_l1", (3, 40), dict(scalar=1.0)),
    ("smooth_l1_scalar", "smooth_l1", (3, 40), dict(scalar=2.5)),
    ("l2_instance", "L2Normalization", (2, 5, 3, 4), dict(mode="instance")),
    ("l2_channel", "L2Normalization", (2, 5, 3, 4), dict(mode="channel")),
    ("l2_spatial", "L2Normalization", (2, 5, 3, 4), dict(mode="spatial",
                                                         eps=1e-4)),
]


def test_loss_and_normalization_ops_match_jax():
    _cases(_check_loss_op, LOSS_CASES)


def _check_loss_op(name, shape, attrs):
    rs = _rs(11)
    x = (rs.randn(*shape) * 1.5).astype("float32")
    x.flat[0] = 0.0
    ct = rs.randn(*shape).astype("float32")
    want = _vjp_jax(name, x, ct, **attrs)
    got = _vjp_port(name, x, ct, **attrs)
    for g, w in zip(got, want):
        _close(g, w, TOL)


def test_softmax_output_ignored_labels_match_jax():
    _cases(_check_softmax_output_ignored,
           [("multi", True), ("single", False)])


def _check_softmax_output_ignored(multi):
    """``SoftmaxOutput`` with the ignore label −1 (SSD's unselected
    anchors): its backward gives such a label a row of zeros, as
    ``jax.nn.one_hot`` does, where ``F.one_hot`` raised on the negative
    class."""
    rs = _rs(12)
    if multi:
        data = rs.randn(2, 4, 6).astype("float32")
        label = rs.randint(-1, 4, (2, 6)).astype("float32")
        attrs = dict(multi_output=True, use_ignore=True,
                     normalization="valid", ignore_label=-1)
    else:
        data = rs.randn(5, 4).astype("float32")
        label = np.array([1, -1, 3, 0, -1], "float32")
        attrs = dict(normalization="batch")
    ct = np.ones_like(data)

    @jax.jit
    def grad(d, lab, c):
        _, vjp = jax.vjp(lambda a: jax_op("SoftmaxOutput").fn(a, lab, **attrs),
                         d)
        return vjp(c)[0]

    want = np.asarray(grad(jnp.asarray(data), jnp.asarray(label),
                           jnp.asarray(ct)))
    t = torch.from_numpy(data).requires_grad_()
    torch_op("SoftmaxOutput").fn(t, torch.from_numpy(label),
                                 **attrs).backward(torch.from_numpy(ct))
    _close(t.grad.numpy(), want, TOL)


# ------------------------------------------------------------ attributes
def _graph(pkg):
    with pkg.AttrScope(ctx_group="dev1", group="a"):
        x = pkg.sym.Variable("x", attr={"group": "b", "note": "x"},
                             lr_mult=2.0, wd_mult=0, dtype="float32",
                             init=pkg.init.Constant(3.0), stype="default",
                             mood="calm")
        with pkg.AttrScope(group="c"):
            w = pkg.sym.Variable("w", shape=(3, 4))
            y = pkg.sym.FullyConnected(x, weight=w, num_hidden=3,
                                       no_bias=True, name="fc",
                                       attr={"tag": "t"})
    return pkg.sym.MakeLoss(pkg.sym.sum(y), name="loss"), x, w


def test_variable_attributes_and_scopes_match_jax():
    _check_attributes_and_scopes()
    _check_lr_mult_is_not_read_by_module_like_jax()


def _check_attributes_and_scopes():
    """``Variable``'s full signature, nested ``AttrScope``s and ``attr=``
    on an op: every node's attribute dict equals the JAX package's. As in
    the JAX package, ``init`` and ``stype`` are accepted and dropped
    (ROADMAP C), and the attributes stay out of the graph JSON (only the
    port's ``__shape__`` op attribute is written)."""
    jy, jx, jw = _graph(jmx)
    py, px, pw = _graph(mx)
    assert px.list_attr() == jx.list_attr()
    assert pw.list_attr() == jw.list_attr()
    assert px.attr("__lr_mult__") == "2.0" and px.attr("init") is None
    assert "__init__" not in px.list_attr()
    assert py.attr_dict() == jy.attr_dict()
    assert mx.AttrScope.current()._attr == {}
    graph = mx.sym.load_json(py.tojson())
    assert graph.attr_dict() == {
        k: v for k, v in jmx.sym.load_json(jy.tojson()).attr_dict().items()}
    assert graph.infer_shape(x=(2, 4))[0] == [(2, 4), (3, 4)]


def _check_lr_mult_is_not_read_by_module_like_jax():
    """A ``Variable(lr_mult=0)`` is still updated by ``Module`` in both
    packages: no JAX module reads ``__lr_mult__``/``__wd_mult__`` (a
    standing fault of the JAX package, ROADMAP C), and the port follows."""
    x = np.arange(6, dtype="float32").reshape(2, 3) / 6
    w0 = np.full((2, 3), 0.5, "float32")

    def step(pkg, ctx):
        w = pkg.sym.Variable("w", lr_mult=0.0, wd_mult=0.0)
        net = pkg.sym.MakeLoss(pkg.sym.sum(pkg.sym.FullyConnected(
            pkg.sym.Variable("data"), weight=w, num_hidden=2, no_bias=True)))
        mod = pkg.mod.Module(net, data_names=["data"], label_names=None,
                             context=ctx)
        mod.bind(data_shapes=[("data", (2, 3))])
        mod.init_params(arg_params={"w": pkg.nd.array(w0, ctx=ctx)})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "wd": 0.1})
        mod.forward_backward(pkg.io.DataBatch(data=[pkg.nd.array(x,
                                                                 ctx=ctx)]))
        mod.update()
        return mod.get_params()[0]["w"].asnumpy()

    want = step(jmx, jmx.cpu())
    got = step(mx, mx.cpu())
    assert not np.allclose(want, w0)
    _close(got, want, TOL)

"""PyTorch port, the R-CNN family and the rest of the contrib ops (slice
14) against the JAX registry ops: ``ROIPooling``, ``ROIAlign``, the PSROI
poolings of ``parity_ops.py``, ``Proposal``/``MultiProposal`` with their
NMS, ``DeformableConvolution``, ``Correlation``, ``fft``/``ifft``,
``count_sketch``, ``AdaptiveAvgPooling2D`` and ``BilinearResize2D``.

The case tables are ``chip_smoke.CONTRIB_OP_GROUPS`` (the card's test
runs the same cases against the CPU). The JAX side of each group is one
``jax.jit`` of every case's forward and ``jax.vjp`` (with a seeded
cotangent), computed once a session; each group is one item that names
the failing case. Tolerance: ROIPooling's outputs (selected maxima) and
the NMS's kept indices equal; every other value and gradient within 1e-6
of the case's largest |value| (``TOL_GRID``). The JAX-side behaviours the
port copies are pinned here too (ROADMAP C).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import contrib_ops as jco
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops import contrib_ops as pco
from mxnet_tpu_torch.ops.registry import get_op as port_op
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import jax_grid, once

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_contrib", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _jax_group(group):
    return jax_grid(cs.CONTRIB_OP_GROUPS[group](), cs.grid_grad_inputs,
                    cs.grid_cotangents)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return once(tmp_path_factory, "contrib-ops-jax",
                lambda: {g: _jax_group(g) for g in cs.CONTRIB_OP_GROUPS})


def _check_group(group, jax_refs):
    failed = []
    for seed, (case, want) in enumerate(zip(cs.CONTRIB_OP_GROUPS[group](),
                                            jax_refs[group])):
        cid, name, inputs, attrs, how = case
        got = cs.run_grid_case(name, inputs, attrs, how, seed)
        failed += cs.library_case_errors(cid, name, how, got, want,
                                         cs.TOL_GRID)[0]
    assert not failed, "\n".join(failed)


def _both(name, arrays, **attrs):
    """One op of each package on the same numpy inputs, as numpy (the JAX
    op jitted: one compile, not one an operation)."""
    j = jax.jit(functools.partial(jax_op(name).fn, **attrs))(
        *[jnp.asarray(a) for a in arrays])
    p = port_op(name).fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    j = j if isinstance(j, (tuple, list)) else (j,)
    p = p if isinstance(p, (tuple, list)) else (p,)
    return [np.asarray(o) for o in j], [o.detach().numpy() for o in p]


def _grads(name, arrays, argnum, **attrs):
    """d(sum of the output)/d(input ``argnum``) in each package."""
    def jf(x):
        args = [jnp.asarray(a) for a in arrays]
        args[argnum] = x
        return jax_op(name).fn(*args, **attrs).sum()
    jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(arrays[argnum])))
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    ts[argnum].requires_grad_()
    port_op(name).fn(*ts, **attrs).sum().backward()
    return jg, ts[argnum].grad.numpy()


def _jax_nms(boxes, scores, threshold, keep):
    return jax.jit(jco._greedy_nms, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), threshold, keep)


def test_roi_ops_match_jax(jax_refs):
    """``ROIPooling`` (rounded bins, an ROI wholly outside the map: empty
    bins give 0; tied maxima), ``ROIAlign`` (a 2x2 grid and the adaptive
    stand-in, ``aligned``), ``PSROIPooling`` and ``DeformablePSROIPooling``
    (with and without ``trans``), forward and gradients; shape inference
    through ``mx.sym``. Pinned JAX-side behaviours, copied: ROIPooling's
    gradient splits evenly among tied maxima (each cell of an all-zero
    4x4 map under one full-map bin gets 1/16; the reference routes it to
    one argmax); ``sample_ratio <= 0`` samples a fixed 2x2 grid; the PSROI
    poolings average a bilinear sample grid (2x2 for ``PSROIPooling``, so
    it equals the deformable op without ``trans`` at ``sample_per_part``
    2), and ``DeformablePSROIPooling`` reads only class 0 of ``trans``;
    ``position_sensitive`` ROIAlign raises."""
    _check_group("roi", jax_refs)
    zeros = np.zeros((1, 1, 4, 4), np.float32)
    full = np.array([[0, 0, 0, 3, 3]], np.float32)
    jg, pg = _grads("ROIPooling", [zeros, full], 0, pooled_size=(1, 1))
    np.testing.assert_array_equal(jg, np.full((1, 1, 4, 4), 1 / 16))
    np.testing.assert_array_equal(pg, jg)

    data = cs.grid_values(2, 3, 8, 10, seed=1)
    rois = cs.roi_boxes(6, 2, 8, 10, seed=2)
    for sr in (0, -1):
        (j,), (p,) = _both("_contrib_ROIAlign", [data, rois],
                           pooled_size=(2, 3), sample_ratio=sr)
        (j2,), (p2,) = _both("_contrib_ROIAlign", [data, rois],
                             pooled_size=(2, 3), sample_ratio=2)
        np.testing.assert_array_equal(j, j2)
        np.testing.assert_array_equal(p, p2)
    for pkg in (jax_op, port_op):
        with pytest.raises(Exception, match="position_sensitive"):
            pkg("ROIAlign").fn(data, rois, position_sensitive=True)

    ps = cs.grid_values(2, 2 * 9, 8, 10, seed=3)
    trans = cs.grid_values(6, 4, 3, 3, seed=4)
    moved = trans.copy()
    moved[:, 2:] += 1.0                        # class 1's offsets
    attrs = dict(spatial_scale=1.0, output_dim=2, pooled_size=3,
                 trans_std=0.1)
    for want, got in zip(*_both("PSROIPooling", [ps, rois],
                                spatial_scale=1.0, output_dim=2,
                                pooled_size=3)):
        plain = _both("DeformablePSROIPooling", [ps, rois], no_trans=True,
                      sample_per_part=2, **attrs)
        np.testing.assert_allclose(plain[0][0], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(plain[1][0], got, rtol=1e-6, atol=1e-7)
    base = _both("DeformablePSROIPooling", [ps, rois, trans], **attrs)
    other = _both("DeformablePSROIPooling", [ps, rois, moved], **attrs)
    for b, o in zip(base, other):
        np.testing.assert_array_equal(b[0], o[0])

    s = mx.sym.Variable("data")
    r = mx.sym.Variable("rois")
    for sym, shape in (
            (mx.sym.ROIPooling(s, r, pooled_size=(3, 2)), (6, 3, 3, 2)),
            (mx.sym.contrib.ROIAlign(s, r, pooled_size=(2, 2)),
             (6, 3, 2, 2)),
            (mx.sym.contrib.PSROIPooling(s, r, output_dim=1, pooled_size=1),
             (6, 1, 1, 1))):
        _, out, _ = sym.infer_shape(data=(2, 3, 8, 10), rois=(6, 5))
        assert tuple(out[0]) == shape, (sym, out)


def test_proposal_ops_match_jax(jax_refs):
    """``MultiProposal`` and ``Proposal`` (with ``output_score``; tied
    scores, boxes below ``rpn_min_size`` scored -1, more slots than boxes)
    against the JAX ops; the NMS's kept list slot for slot. Pinned
    JAX-side behaviours, copied: the last slot holds the smallest index
    among the suppressed boxes (and the alive ones from that rank on), so
    five boxes with box 1 suppressed keep ``[0 2 1]`` at keep 3, and an
    empty slot holds slot 0's box (``[0 2 3 4 0 1]`` at keep 6; the
    reference repeats its kept boxes); ``Proposal`` uses image 0 only; a
    box grown by ``rpn_min_size`` still suppresses (two 16x16 anchors side
    by side, grown to 36x36, overlap at IoU 0.385 > 0.3)."""
    _check_group("proposal", jax_refs)
    boxes = np.array([[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30, 30],
                      [40, 40, 50, 50], [60, 60, 70, 70]], np.float32)
    scores = np.array([.9, .8, .7, .6, .5], np.float32)
    for keep, want in ((1, [0]), (3, [0, 2, 1]), (6, [0, 2, 3, 4, 0, 1])):
        jk, jn = _jax_nms(boxes, scores, 0.5, keep)
        pk, pn, _ = pco._greedy_nms(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None], 0.5,
                                    keep)
        np.testing.assert_array_equal(np.asarray(jk), want)
        np.testing.assert_array_equal(pk[0].numpy(), want)
        assert int(jn) == int(pn[0]) == 4
    rs = np.random.RandomState(7)
    corner = rs.uniform(0, 60, (40, 2))
    rand = np.concatenate([corner, corner + rs.uniform(4, 30, (40, 2))], 1) \
        .astype(np.float32)
    tied = np.round(rs.uniform(0, 1, 40), 1).astype(np.float32)
    for keep in (10, 45):
        jk, jn = _jax_nms(rand, tied, 0.3, keep)
        pk, pn, _ = pco._greedy_nms(torch.from_numpy(rand)[None],
                                    torch.from_numpy(tied)[None], 0.3, keep)
        np.testing.assert_array_equal(pk[0].numpy(), np.asarray(jk))
        assert int(jn) == int(pn[0])

    cls, deltas = cs.rpn_maps(2, 9, 5, 7)
    info = np.array([[80, 112, 1.0], [70, 100, 1.5]], np.float32)
    attrs = dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=60, threshold=0.5,
                 rpn_min_size=30, scales=(1, 2, 4), ratios=(0.5, 1, 2),
                 output_score=True)
    single = _both("Proposal", [cls, deltas, info], **attrs)
    multi = _both("MultiProposal", [cls, deltas, info], **attrs)
    for (rois, score), (mrois, mscore) in zip(single, multi):
        np.testing.assert_array_equal(rois, mrois[:60])
        np.testing.assert_array_equal(score, mscore[:60])
        assert (mscore == -1).sum() > 0
    np.testing.assert_array_equal(single[1][1], single[0][1])

    # two 16x16 anchors side by side, both below rpn_min_size 20
    cls2 = np.zeros((1, 2, 1, 2), np.float32)
    cls2[0, 1] = [0.9, 0.8]
    grown = _both("Proposal", [cls2, np.zeros((1, 4, 1, 2), np.float32),
                               np.array([[16, 32, 1.0]], np.float32)],
                  rpn_pre_nms_top_n=2, rpn_post_nms_top_n=3, threshold=0.3,
                  rpn_min_size=20, scales=(1,), ratios=(1,))
    want = np.array([[0, -10, -10, 25, 25], [0, -10, -10, 25, 25],
                     [0, 6, -10, 41, 25]], np.float32)
    for (rois,) in grown:
        np.testing.assert_array_equal(rois, want)


def test_other_contrib_ops_match_jax(jax_refs):
    """``DeformableConvolution`` (groups and deformable groups),
    ``Correlation`` (multiply and abs-diff, strides, a box filter),
    ``fft``/``ifft``, ``count_sketch``, ``AdaptiveAvgPooling2D`` and
    ``BilinearResize2D``, forward and gradients. Pinned JAX-side
    behaviours, copied: ``count_sketch`` drops an ``h`` outside
    [-out_dim, out_dim) and counts a negative one from the end;
    ``BilinearResize2D`` aligns corners; ``ifft`` is unnormalised."""
    _check_group("other", jax_refs)
    x = np.arange(1, 5, dtype=np.float32)[None]
    for out in _both("count_sketch", [x, np.array([0, -1, 5, -7], np.float32),
                                      np.ones(4, np.float32)], out_dim=5):
        np.testing.assert_array_equal(out[0], [[1, 0, 0, 0, 2]])
    img = cs.grid_values(1, 2, 4, 6, seed=3)
    for (out,) in _both("BilinearResize2D", [img], height=7, width=9):
        np.testing.assert_allclose(out[..., ::6, ::8], img[..., ::3, ::5],
                                   rtol=1e-6)
    v = cs.grid_values(2, 8, seed=4)
    fft = port_op("_contrib_fft").fn(torch.from_numpy(v))
    back = port_op("_contrib_ifft").fn(fft)
    np.testing.assert_allclose(back.numpy() / 8, v, atol=1e-6)

"""Detection, signal and sketch contrib operators: ``ROIPooling``,
``ROIAlign``, ``Proposal``/``MultiProposal``, ``DeformableConvolution``,
``Correlation``, ``fft``/``ifft``, ``count_sketch``,
``AdaptiveAvgPooling2D`` and ``BilinearResize2D``.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (reference
``src/operator/roi_pooling.cc``, ``contrib/roi_align.cc``,
``contrib/proposal.cc``, ``contrib/multi_proposal.cc``,
``contrib/deformable_convolution.cc``, ``correlation.cc``,
``contrib/fft.cc``, ``contrib/count_sketch.cc``,
``contrib/adaptive_avg_pooling.cc``, ``contrib/bilinear_resize.cc``), with
the same names, aliases, attributes and semantics. XLA lowered the JAX
versions; these are plain torch:

* ``ROIPooling`` keeps the JAX op's integer bins and its gradient, which
  splits a bin's cotangent evenly among tied maxima at each of its two
  stages (a column's maximum, then the bin's), where the reference routes
  it to one argmax. It gathers one bin column (row) of every ROI at a time
  instead of masking the whole map for each ROI.
* The bilinear samplers read only the points (and, for the PSROI poolings,
  the channels) they need, with the JAX sampler's validity test, clamping
  and ``jnp.clip``'s gradient (half to each side of a tie).
* The proposal NMS is class-agnostic greedy suppression reached as the
  fixed point of batched steps (:func:`.multibox.greedy_fixed_point`),
  over stable sorts; its kept list is the JAX op's slot for slot, faults
  included (see :func:`_greedy_nms`).
* ``Correlation`` computes a row of displacements per pass over the
  shifted windows, not one pass per displacement.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .multibox import greedy_fixed_point
from .registry import register


def _meta(t) -> bool:
    return t.device.type == "meta"


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: a maximum, then a minimum, whose gradient
    at a tie goes half to each side, as JAX's does."""
    def bound(v):
        return v if torch.is_tensor(v) else x.new_tensor(v)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def _grid_fractions(bins, grid, dtype, device):
    """(bins, grid): ``bin + (k + 0.5) / grid``, computed in float64 and
    rounded once to ``dtype``, as the JAX package's 64-bit weak types do."""
    py = torch.arange(bins, dtype=torch.float64, device=device)
    iy = (torch.arange(grid, dtype=torch.float64, device=device) + 0.5) / grid
    return (py[:, None] + iy[None, :]).to(dtype)


# ---------------------------------------------------------------- ROIPooling
def _roi_bounds(start, roi_sz, count, limit):
    """Exact integer floor/ceil of ``i·roi_sz/count`` plus ``start``,
    clipped to [0, limit]: (R, count) lower and upper bounds."""
    i = torch.arange(count, dtype=torch.int64, device=start.device)
    lo = (i[None, :] * roi_sz[:, None]) // count + start[:, None]
    hi = ((i[None, :] + 1) * roi_sz[:, None] + count - 1) // count \
        + start[:, None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def _roi_bins(rois, spatial_scale, ph, pw, height, width):
    """The reference's rounded-coordinate bins (roi_pooling.cc:54-106):
    (batch index, (h_lo, h_hi), (w_lo, w_hi))."""
    corner = torch.round(rois[:, 1:5] * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = corner.unbind(1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    return (rois[:, 0].to(torch.int64),
            _roi_bounds(y1, roi_h, ph, height),
            _roi_bounds(x1, roi_w, pw, width))


def _windows(lo, hi, limit):
    """For each bin (column of lo, hi): the indices ``lo + arange(K)`` of
    its cells (K the widest bin, clamped into [0, limit)) and the mask of
    those inside the bin."""
    k = max(1, int((hi - lo).max().item())) if lo.numel() else 1
    off = torch.arange(k, device=lo.device)
    return [((lo[:, j, None] + off).clamp(max=limit - 1),
             off < (hi - lo)[:, j, None]) for j in range(lo.shape[1])]


class _ROIPool(torch.autograd.Function):
    """Two-stage masked maximum (each ROI's bin columns, then its bin rows)
    with the JAX op's tie-splitting gradient."""

    @staticmethod
    def forward(ctx, data, rois, ph, pw, spatial_scale):
        n, c, height, width = data.shape
        r = rois.shape[0]
        b, (h_lo, h_hi), (w_lo, w_hi) = _roi_bins(rois, spatial_scale, ph,
                                                  pw, height, width)
        neg = torch.finfo(data.dtype).min
        rr = torch.arange(r, device=data.device)[:, None]
        cols = _windows(w_lo, w_hi, width)
        tmp = data.new_empty(r, c, height, pw)
        for j, (idx, ok) in enumerate(cols):
            vals = data[b[:, None], :, :, idx]             # (R, Kw, C, H)
            tmp[..., j] = torch.where(ok[:, :, None, None], vals,
                                      neg).amax(dim=1)
        rows = _windows(h_lo, h_hi, height)
        out = data.new_empty(r, c, ph, pw)
        for i, (idx, ok) in enumerate(rows):
            vals = tmp[rr, :, idx]                         # (R, Kh, C, pw)
            out[:, :, i] = torch.where(ok[:, :, None, None], vals,
                                       neg).amax(dim=1)
        empty = ((h_hi == h_lo)[:, None, :, None]
                 | (w_hi == w_lo)[:, None, None, :])
        out = torch.where(empty, torch.zeros((), dtype=data.dtype,
                                             device=data.device), out)
        ctx.save_for_backward(data, b, tmp, out, empty)
        ctx.windows = (cols, rows)
        return out

    @staticmethod
    def backward(ctx, g):
        data, b, tmp, out, empty = ctx.saved_tensors
        cols, rows = ctx.windows
        r, c, height, pw = tmp.shape
        rr = torch.arange(r, device=g.device)[:, None]
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        g = torch.where(empty, zero, g)
        # stage 2: a bin's cotangent split among its rows holding the max
        g_tmp = g.new_zeros(r, height, c, pw)
        for i, (idx, ok) in enumerate(rows):
            hit = (tmp[rr, :, idx] == out[:, None, :, i]) & \
                ok[:, :, None, None]
            cnt = hit.sum(dim=1, keepdim=True)
            share = torch.where(cnt > 0, g[:, None, :, i] / cnt, zero)
            g_tmp.index_put_((rr.expand_as(idx), idx),
                             torch.where(hit, share, zero), accumulate=True)
        g_tmp = g_tmp.permute(0, 2, 1, 3)                  # (R, C, H, pw)
        # stage 1: a column's cotangent split among its cells holding it
        g_data = g.new_zeros(data.shape[0], data.shape[3], c, height)
        for j, (idx, ok) in enumerate(cols):
            hit = (data[b[:, None], :, :, idx] == tmp[:, None, :, :, j]) & \
                ok[:, :, None, None]
            cnt = hit.sum(dim=1, keepdim=True)
            share = torch.where(cnt > 0, g_tmp[:, None, :, :, j] / cnt, zero)
            g_data.index_put_((b[:, None].expand_as(idx), idx),
                              torch.where(hit, share, zero), accumulate=True)
        return g_data.permute(0, 2, 3, 1), None, None, None, None


@register("ROIPooling", arg_names=("data", "rois"))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max-pool each ROI ``[batch, x1, y1, x2, y2]`` into a (ph, pw) grid
    of the reference's rounded, inclusive bins; an empty bin gives 0."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    if _meta(data):
        return data.new_empty(rois.shape[0], data.shape[1], ph, pw)
    return _ROIPool.apply(data, rois.detach(), ph, pw, float(spatial_scale))


# ----------------------------------------------------------------- ROIAlign
def _bilinear_gather(data, b, y, x, chan=None):
    """Sample image ``b`` of data (N, C, H, W) at float coordinates y, x
    (broadcast with ``b``) with bilinear weights: (..., C), or (..., K)
    for the channels ``chan`` (broadcast to (..., K)) of each point. A
    point outside (-1, H) × (-1, W) gives 0; inside, its coordinates are
    clamped into the image. Differentiable in data and coordinates."""
    n, c, h, w = data.shape
    valid = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = _clip(y, 0.0, h - 1.0)
    x = _clip(x, 0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    wy1 = (y - y0)[..., None]
    wx1 = (x - x0)[..., None]
    if chan is None:
        flat = data.permute(0, 2, 3, 1).reshape(-1, c)
        base = b * (h * w)

        def at(yy, xx):
            return flat[base + (yy * w + xx).long()]
    else:
        flat = data.reshape(-1)
        base = (b[..., None] * c + chan) * (h * w)

        def at(yy, xx):
            return flat[base + (yy * w + xx).long()[..., None]]

    val = ((1 - wy1) * (1 - wx1) * at(y0, x0) + (1 - wy1) * wx1 * at(y0, x1)
           + wy1 * (1 - wx1) * at(y1, x0) + wy1 * wx1 * at(y1, x1))
    return torch.where(valid[..., None], val, val.new_zeros(()))


@register("_contrib_ROIAlign", aliases=["ROIAlign"],
          arg_names=("data", "rois"))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    """Average of a grid × grid bilinear sample pattern per bin
    (roi_align.cc). With ``sample_ratio <= 0`` the grid is 2 × 2, the JAX
    package's fixed stand-in for the reference's adaptive per-ROI grid."""
    if position_sensitive:
        raise MXNetError("position_sensitive ROIAlign not supported yet")
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    grid = int(sample_ratio) if int(sample_ratio) > 0 else 2
    r, c = rois.shape[0], data.shape[1]
    if _meta(data):
        return data.new_empty(r, c, ph, pw)
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - offset
                      for k in range(1, 5))
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.maximum(roi_w, roi_w.new_tensor(1.0))
        roi_h = torch.maximum(roi_h, roi_h.new_tensor(1.0))
    ys = y1[:, None, None] + _grid_fractions(ph, grid, data.dtype,
                                             data.device) \
        * (roi_h / ph)[:, None, None]                    # (R, ph, g)
    xs = x1[:, None, None] + _grid_fractions(pw, grid, data.dtype,
                                             data.device) \
        * (roi_w / pw)[:, None, None]                    # (R, pw, g)
    shape = (r, ph, grid, pw, grid)
    vals = _bilinear_gather(
        data, rois[:, 0].long()[:, None, None, None, None],
        ys[:, :, :, None, None].expand(shape),
        xs[:, None, None, :, :].expand(shape))           # (R, ph, g, pw, g, C)
    return vals.mean(dim=(2, 4)).permute(0, 3, 1, 2)


# ----------------------------------------------------------------- Proposal
def _make_anchors(feature_stride, scales, ratios):
    """The reference's anchors (rcnn generate_anchors), (A, 4) float64 on
    the CPU: from the stride-sized box, the ratios with rounded widths and
    heights, then the scales."""
    w = h = float(feature_stride)
    cx = cy = 0.5 * (w - 1)
    anchors = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in scales:
            ws_s, hs_s = ws * s, hs * s
            anchors.append([cx - 0.5 * (ws_s - 1), cy - 0.5 * (hs_s - 1),
                            cx + 0.5 * (ws_s - 1), cy + 0.5 * (hs_s - 1)])
    return torch.tensor(anchors, dtype=torch.float64)


def _decode_bbox(anchors, deltas):
    """(dx, dy, dw, dh) deltas applied to (..., 4) boxes
    (bbox_transform_inv)."""
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (w - 1.0)
    cy = anchors[..., 1] + 0.5 * (h - 1.0)
    ncx = deltas[..., 0] * w + cx
    ncy = deltas[..., 1] * h + cy
    nw = torch.exp(deltas[..., 2]) * w
    nh = torch.exp(deltas[..., 3]) * h
    return torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                        ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], dim=-1)


def _iou_matrix(boxes):
    """(..., n, n) IoU of inclusive-pixel boxes (..., n, 4)."""
    area = ((boxes[..., 2] - boxes[..., 0] + 1.0)
            * (boxes[..., 3] - boxes[..., 1] + 1.0))
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def _greedy_alive(boxes, iou_threshold):
    """Greedy suppression of boxes (B, n, 4) in their order: (alive (B, n),
    the batched steps its fixed point took)."""
    n = boxes.shape[-2]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (_iou_matrix(boxes) > iou_threshold) & later
    alive0 = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                        device=boxes.device)
    return greedy_fixed_point(alive0, sup)


def _greedy_nms(boxes, scores, iou_threshold, keep_n):
    """The JAX package's kept list, for boxes (B, n, 4) and scores (B, n):
    (indices (B, keep_n), alive count (B,), the suppression's batched
    steps). Slot s holds the s-th alive box of the stable descending
    order, but the last slot holds the smallest index among the
    suppressed boxes and the alive ones from that rank on (the JAX
    scatter clips every other box into it), and an empty slot holds slot
    0's box."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    alive, steps = _greedy_alive(boxes, iou_threshold)
    bsz, n = alive.shape
    rank = torch.cumsum(alive, dim=1) - 1
    slots = torch.where(alive, rank, torch.full_like(rank, n))
    picked = torch.full((bsz, keep_n), n, dtype=torch.int64,
                        device=boxes.device)
    picked = picked.scatter_reduce(
        1, slots.clamp(0, keep_n - 1),
        torch.arange(n, device=boxes.device).expand(bsz, n), reduce="amin")
    picked = torch.where(picked == n, picked[:, :1], picked)
    return torch.gather(order, 1, picked), alive.sum(dim=1), steps


def _proposals(cls_prob, bbox_pred, im_info, anchors, feature_stride,
               pre_nms, post_nms, threshold, min_size):
    """The JAX ``_proposal_single`` over a batch: (rois (B, post, 4),
    scores (B, post), each roi's anchor index (B, post), the NMS's batched
    steps)."""
    bsz = cls_prob.shape[0]
    a = anchors.shape[0]
    height, width = cls_prob.shape[-2:]
    dev, dtype = cls_prob.device, cls_prob.dtype
    sx = torch.arange(width, device=dev) * feature_stride
    sy = torch.arange(height, device=dev) * feature_stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 4).to(dtype)
    anchors = anchors.to(dtype=dtype, device=dev)
    all_anchors = (anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    scores = cls_prob[:, a:].reshape(bsz, a, -1).transpose(1, 2) \
        .reshape(bsz, -1)
    deltas = bbox_pred.reshape(bsz, a, 4, height * width) \
        .permute(0, 3, 1, 2).reshape(bsz, -1, 4)
    props = _decode_bbox(all_anchors, deltas)
    info = im_info[:, None, :]
    props = torch.stack([_clip(props[..., 0], 0, info[..., 1] - 1.0),
                         _clip(props[..., 1], 0, info[..., 0] - 1.0),
                         _clip(props[..., 2], 0, info[..., 1] - 1.0),
                         _clip(props[..., 3], 0, info[..., 0] - 1.0)],
                        dim=-1)
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    min_sz = min_size * info[..., 2]
    small = (ws < min_sz) | (hs < min_sz)
    # FilterBox (proposal.cc:145-158): a box below min_size grows by half
    # of it on every side and gets score -1; the grown box still takes
    # part in the suppression
    grow = torch.where(small, min_sz / 2.0, 0.0)[..., None] * \
        torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=dtype, device=dev)
    props = props + grow
    scores = torch.where(small, torch.full_like(scores, -1.0), scores)
    k = min(pre_nms, scores.shape[1])
    top = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :k], top.indices[:, :k]
    top_props = torch.gather(props, 1, top_idx[..., None].expand(bsz, k, 4))
    keep, _, steps = _greedy_nms(top_props, top_scores, threshold,
                                 post_nms)
    return (torch.gather(top_props, 1, keep[..., None].expand(-1, -1, 4)),
            torch.gather(top_scores, 1, keep),
            torch.gather(top_idx, 1, keep), steps)


def _as_floats(v):
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _proposal_args(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride):
    with torch.no_grad():
        return _proposals(
            cls_prob.detach(), bbox_pred.detach(), im_info.detach(),
            _make_anchors(feature_stride, _as_floats(scales),
                          _as_floats(ratios)), feature_stride,
            int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n),
            float(threshold), float(rpn_min_size))


@register("_contrib_Proposal", aliases=["Proposal"], differentiable=False,
          num_outputs=1, arg_names=("cls_prob", "bbox_pred", "im_info"))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
              output_score=False, iou_loss=False):
    """RPN proposal layer (proposal.cc) of image 0 only: decode the
    anchors, clip, filter small boxes, NMS; (post_nms_top_n, 5) rois with
    batch index 0 (and (post_nms_top_n, 1) scores)."""
    post = int(rpn_post_nms_top_n)
    if _meta(cls_prob):
        rois = cls_prob.new_empty(post, 5)
        return (rois, cls_prob.new_empty(post, 1)) if output_score else rois
    rois, scores, _, _ = _proposal_args(
        cls_prob[:1], bbox_pred[:1], im_info[:1], rpn_pre_nms_top_n,
        rpn_post_nms_top_n, threshold, rpn_min_size, scales, ratios,
        feature_stride)
    rois = torch.cat([rois.new_zeros(post, 1), rois[0]], dim=1)
    if output_score:
        return rois, scores[0][:, None]
    return rois


@register("_contrib_MultiProposal", aliases=["MultiProposal"],
          differentiable=False,
          arg_names=("cls_prob", "bbox_pred", "im_info"))
def _multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                    rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                    scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                    feature_stride=16, output_score=False, iou_loss=False):
    """``Proposal`` for every image of the batch (multi_proposal.cc):
    (N·post_nms_top_n, 5) rois with each image's index."""
    n, post = cls_prob.shape[0], int(rpn_post_nms_top_n)
    if _meta(cls_prob):
        rois = cls_prob.new_empty(n * post, 5)
        return (rois, cls_prob.new_empty(n * post, 1)) if output_score \
            else rois
    rois, scores, _, _ = _proposal_args(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_post_nms_top_n,
        threshold, rpn_min_size, scales, ratios, feature_stride)
    batch = torch.arange(n, dtype=rois.dtype, device=rois.device)
    rois = torch.cat([batch[:, None, None].expand(n, post, 1), rois], dim=2)
    if output_score:
        return rois.reshape(n * post, 5), scores.reshape(n * post, 1)
    return rois.reshape(n * post, 5)


# ------------------------------------------------- DeformableConvolution
@register("_contrib_DeformableConvolution",
          aliases=["DeformableConvolution"],
          arg_names=("data", "offset", "weight", "bias"))
def _deformable_convolution(data, offset, weight, bias=None, kernel=(1, 1),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=1, num_group=1,
                            num_deformable_group=1, no_bias=False,
                            workspace=1024, layout=None):
    """Deformable convolution v1 (deformable_convolution.cc): every kernel
    tap reads the input at its learned fractional offset (offset channels
    ordered [deformable group][tap][y, x]); the taps form a column matrix
    that one grouped product contracts with the weight."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph, pw = int(pad[0]), int(pad[1])
    n, c, h, w = data.shape
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg, f, g = int(num_deformable_group), int(num_filter), int(num_group)
    taps = kh * kw
    if c % dg or offset.shape[1] != 2 * taps * dg:
        raise MXNetError(
            "offset channels must be 2*kh*kw*num_deformable_group")
    if _meta(data):
        return data.new_empty(n, f, oh, ow)
    dev, dtype = data.device, data.dtype
    u = torch.arange(taps, device=dev) // kw
    v = torch.arange(taps, device=dev) % kw
    base_y = (torch.arange(oh, device=dev)[None, :] * sh - ph
              + (u * dh)[:, None]).to(dtype)             # (T, oh)
    base_x = (torch.arange(ow, device=dev)[None, :] * sw - pw
              + (v * dw)[:, None]).to(dtype)             # (T, ow)
    off = offset.reshape(n, dg, taps, 2, oh, ow)
    yy = base_y[None, None, :, :, None] + off[:, :, :, 0]
    xx = base_x[None, None, :, None, :] + off[:, :, :, 1]
    imgs = data.reshape(n * dg, c // dg, h, w)
    b = torch.arange(n * dg, device=dev).reshape(n, dg, 1, 1, 1)
    vals = _bilinear_gather(imgs, b, yy, xx)      # (N, dg, T, oh, ow, c/dg)
    col = vals.permute(0, 1, 5, 2, 3, 4).reshape(n, g, (c // g) * taps,
                                                 oh * ow)
    wmat = weight.reshape(g, f // g, (c // g) * taps)
    out = torch.matmul(wmat[None], col).reshape(n, f, oh, ow)
    if not no_bias and bias is not None:
        out = out + bias[None, :, None, None]
    return out


# -------------------------------------------------------------- Correlation
@register("Correlation", num_outputs=1, arg_names=("data1", "data2"))
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet cost volume (correlation.cc): for every displacement of the
    stride2 grid, the channel sum of data1 times (or the absolute
    difference from) data2 shifted by it, box-summed over kernel_size² and
    sampled on the stride1 grid, divided by kernel_size²·channels. One pass
    per row of displacements: the row's shifted windows of data2 are one
    strided view."""
    k, md = int(kernel_size), int(max_displacement)
    s1, s2, p = int(stride1), int(stride2), int(pad_size)
    kr = (k - 1) // 2
    border = md + kr
    n, c, h, w = data1.shape
    hp, wp = h + 2 * p, w + 2 * p
    top_h = int(math.ceil((hp - border * 2) / s1))
    top_w = int(math.ceil((wp - border * 2) / s1))
    if top_h < 1 or top_w < 1:
        raise MXNetError("Correlation: displacement/kernel larger than input")
    r = md // s2
    grid = 2 * r + 1
    if _meta(data1):
        return data1.new_empty(n, grid * grid, top_h, top_w)
    span_h = (top_h - 1) * s1 + k
    span_w = (top_w - 1) * s1 + k
    # where the JAX op's dynamic_slice clamps its start
    y0 = min(border - kr, hp - span_h)
    x0 = min(border - kr, wp - span_w)
    f1 = F.pad(data1, (p, p, p, p))[:, :, y0:y0 + span_h, x0:x0 + span_w]
    # data2 padded by md more: a shift that leaves the padded map reads 0
    q = r * s2
    f2 = F.pad(data2, (p + q, p + q, p + q, p + q))
    maps = []
    for dy in range(-r, r + 1):
        rows = f2[:, :, y0 + q + dy * s2:y0 + q + dy * s2 + span_h,
                  x0:x0 + span_w + 2 * q]
        shifted = rows.unfold(3, span_w, s2)             # (N, C, sh, grid, sw)
        f1b = f1[:, :, :, None, :]
        prod = (f1b * shifted if is_multiply
                else (f1b - shifted).abs()).sum(dim=1)   # (N, sh, grid, sw)
        maps.append(prod.permute(0, 2, 1, 3))
    prod = torch.cat(maps, dim=1).reshape(n * grid * grid, 1, span_h, span_w)
    summed = F.avg_pool2d(prod, k, s1, divisor_override=1) if k > 1 or s1 > 1 \
        else prod
    return summed.reshape(n, grid * grid, top_h, top_w) / (k * k * c)


# ------------------------------------------------------------------ fft/ifft
@register("_contrib_fft", aliases=["fft"])
def _fft(data, compute_size=128):
    """FFT along the last axis in complex64; re/im interleaved, so the last
    dim doubles (fft.cc's layout)."""
    z = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([z.real, z.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        data.dtype)


@register("_contrib_ifft", aliases=["ifft"])
def _ifft(data, compute_size=128):
    """Unnormalised inverse FFT of interleaved re/im input: the last dim
    halves, and out/d is numpy's normalised ifft."""
    d = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (d, 2))
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(z, dim=-1).real * d).to(data.dtype)


# -------------------------------------------------------------- count_sketch
@register("_contrib_count_sketch", aliases=["count_sketch"],
          arg_names=("data", "h", "s"))
def _count_sketch(data, h, s, out_dim=None, processing_batch_size=32):
    """Count-sketch projection (count_sketch.cc): ``out[n, h[i]] +=
    s[i]·x[n, i]``. An ``h`` in [-out_dim, 0) counts from the end, and one
    outside [-out_dim, out_dim) is dropped, as the JAX scatter does."""
    if out_dim is None:
        raise MXNetError("count_sketch requires out_dim")
    out_dim = int(out_dim)
    hv = h.reshape(-1).to(torch.int64)
    hv = torch.where(hv < 0, hv + out_dim, hv)
    keep = (hv >= 0) & (hv < out_dim)
    signed = data * s.reshape(-1).to(data.dtype)[None, :]
    out = data.new_zeros(data.shape[0], out_dim)
    if _meta(data):
        return out
    return out.index_add(1, hv[keep], signed[:, keep])


# ---------------------------------------------------- AdaptiveAvgPooling2D
@register("_contrib_AdaptiveAvgPooling2D", aliases=["AdaptiveAvgPooling2D"])
def _adaptive_avg_pooling(data, output_size=None):
    """Average pooling to a fixed grid; output cell i covers
    [floor(i·I/O), ceil((i+1)·I/O)) (adaptive_avg_pooling.cc)."""
    if output_size is None or output_size == ():
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = int(output_size)
    else:
        pair = tuple(output_size)
        oh, ow = int(pair[0]), int(pair[-1])
    return F.adaptive_avg_pool2d(data, (oh, ow))


# ----------------------------------------------------------- BilinearResize2D
@register("_contrib_BilinearResize2D", aliases=["BilinearResize2D"])
def _bilinear_resize(data, height=None, width=None, scale_height=None,
                     scale_width=None, mode="size"):
    """Bilinear resize with align-corners sampling, as the reference's
    (bilinear_resize.cc:67: output corners land on input corners)."""
    oh = int(height) if height else int(data.shape[2] * float(scale_height))
    ow = int(width) if width else int(data.shape[3] * float(scale_width))
    return F.interpolate(data, size=(oh, ow), mode="bilinear",
                         align_corners=True)

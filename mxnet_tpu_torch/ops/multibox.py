"""SSD detection ops: ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``box_nms`` and ``box_iou``.

Counterpart of ``mxnet_tpu/ops/multibox.py`` (reference
``src/operator/contrib/`` multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc), with the same names, aliases and
outputs. XLA lowered the JAX versions; these are plain torch, batched over
the samples where the JAX package maps one sample at a time:

* ``MultiBoxPrior`` is a constant of the feature map's shape (XLA folded it
  at compile time): it is built once per (h, w, attributes, dtype, device)
  and cached.
* Sorts are stable, as ``jnp.argsort`` is: equal scores keep their anchor
  order (detection, ``box_nms`` and the hard-negative ranking).
* Suppression runs only over the rows that can be alive. After the
  descending sort those are a prefix: rows past ``nms_topk`` and rows at
  or below the score threshold never are. Its greedy result (a row is
  kept unless an earlier kept row of its class overlaps it) is the unique
  fixed point of one batched step over that prefix, reached by iterating
  the step until it no longer changes; the JAX package runs the same
  greedy rule as a loop over every row with an (N, N) matrix per sample.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .registry import register

# entries of one suppression step's (samples, k, k) overlap matrix above
# which the samples are taken a few at a time
_NMS_CHUNK = 1 << 26


def _corner_iou(a, b):
    """IoU between corner-format box sets: a (..., N, 4), b (..., M, 4) →
    (..., N, M)."""
    ax1, ay1, ax2, ay2 = (a[..., i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0.0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _float_dtype(t):
    """float64 for float64 (which the JAX package does not have), else
    float32, as the JAX ops compute."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


_PRIORS: Dict[Tuple, torch.Tensor] = {}


@register("_contrib_MultiBoxPrior", aliases=["contrib_MultiBoxPrior"],
          differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors (1, h·w·(len(sizes) + len(ratios) − 1), 4) in corner
    format, normalized to [0, 1]: float32, or float64 for float64 data."""
    h, w = int(data.shape[2]), int(data.shape[3])
    dtype = _float_dtype(data)
    key = (h, w, tuple(sizes), tuple(ratios), bool(clip), tuple(steps),
           tuple(offsets), dtype, data.device)
    out = _PRIORS.get(key)
    if out is None:
        # a constant: never an inference tensor, so that a training graph
        # may use what a detection forward cached
        with torch.inference_mode(False), torch.no_grad():
            out = _prior(h, w, sizes, ratios, clip, steps, offsets, dtype,
                         data.device)
        _PRIORS[key] = out
    return out


def _prior(h, w, sizes, ratios, clip, steps, offsets, dtype, device):
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=dtype, device=device) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=dtype, device=device) + offsets[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    s0 = sizes[0]
    whs = [(s, s) for s in sizes]
    for r in ratios[1:]:
        sr = float(r) ** 0.5
        whs.append((s0 * sr, s0 / sr))
    anchors = [torch.stack([cx - aw / 2.0, cy - ah / 2.0,
                            cx + aw / 2.0, cy + ah / 2.0], dim=-1)
               for (aw, ah) in whs]
    out = torch.stack(anchors, dim=2).reshape(h * w * len(whs), 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out[None]


def _centers(anchors):
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-12)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-12)
    return acx, acy, aw, ah


def _stable_rank_desc(score):
    """Each entry's position in a stable descending sort along dim 1
    (``rank[argsort(-score)] = arange`` in the JAX package)."""
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    pos = torch.arange(score.shape[1], device=score.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, pos)


@register("_contrib_MultiBoxTarget", aliases=["contrib_MultiBoxTarget"],
          num_outputs=3, differentiable=False)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor → ground-truth matching and box-regression targets. label
    (B, M, 5) rows ``[cls, x1, y1, x2, y2]``, −1 padded; cls_pred
    (B, classes, N). Returns loc_target (B, 4N), loc_mask (B, 4N) and
    cls_target (B, N)."""
    anchor, label, cls_pred = (t.detach() for t in (anchor, label,
                                                   cls_pred))
    dtype = torch.promote_types(_float_dtype(anchor), _float_dtype(label))
    anchors = anchor.reshape(-1, 4).to(dtype)
    label = label.to(dtype)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    if anchors.device.type == "meta":
        return (torch.empty(B, 4 * N, dtype=dtype, device="meta"),
                torch.empty(B, 4 * N, dtype=dtype, device="meta"),
                torch.empty(B, N, dtype=dtype, device="meta"))
    acx, acy, aw, ah = _centers(anchors)
    valid = label[:, :, 0] >= 0                                   # (B, M)
    gt = label[:, :, 1:5]
    iou = _corner_iou(anchors.expand(B, N, 4), gt)                # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = torch.max(iou, dim=2)
    matched = best_iou >= overlap_threshold
    # force-match: each valid gt claims its best anchor. A padded gt row
    # goes to a spare column N that is then dropped, so it cannot clobber
    # a valid gt's claim on anchor 0; where several valid gts claim one
    # anchor, the last of them wins, as XLA's in-order scatter leaves it
    best_anchor = torch.argmax(iou, dim=1)                        # (B, M)
    tgt = torch.where(valid, best_anchor, torch.full_like(best_anchor, N))
    gts = torch.arange(M, device=label.device).expand(B, M)
    claim = torch.full((B, N + 1), -1, dtype=torch.int64,
                       device=label.device)
    claim = claim.scatter_reduce(1, tgt, gts, reduce="amax")[:, :N]
    force = claim >= 0
    matched = matched | force
    gt_idx = torch.where(force, claim, best_gt)                   # (B, N)

    g = torch.gather(gt, 1, gt_idx[..., None].expand(B, N, 4))
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-12)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-12)
    loc_t = torch.stack([(gcx - acx) / aw / variances[0],
                         (gcy - acy) / ah / variances[1],
                         torch.log(gw / aw) / variances[2],
                         torch.log(gh / ah) / variances[3]], dim=2)
    zero = torch.zeros((), dtype=dtype, device=label.device)
    loc_t = torch.where(matched[..., None], loc_t, zero).reshape(B, -1)
    loc_mask = matched[..., None].expand(B, N, 4).to(dtype).reshape(B, -1)
    gt_cls = torch.gather(label[:, :, 0], 1, gt_idx)
    cls_t = torch.where(matched, gt_cls + 1.0, zero)

    if negative_mining_ratio > 0:
        # hard-negative mining: the hardest unmatched anchors (1 − p of
        # the background under cls_pred's softmax) are background, up to
        # ratio × positives (at least minimum_negative_samples); the other
        # unmatched anchors get ignore_label
        # the softmax as jax.nn.softmax writes it (a division by the sum)
        e = torch.exp(cls_pred - cls_pred.amax(dim=1, keepdim=True))
        hardness = 1.0 - e[:, 0] / e.sum(dim=1)
        eligible = (~matched) & (best_iou < negative_mining_thresh)
        num_pos = matched.sum(dim=1, dtype=torch.int32)
        num_neg = torch.clamp(
            (negative_mining_ratio * num_pos.to(torch.float32)).to(
                torch.int32), min=int(minimum_negative_samples))
        score = torch.where(eligible, hardness,
                            torch.full_like(hardness, -float("inf")))
        selected = eligible & (_stable_rank_desc(score) < num_neg[:, None])
        cls_t = torch.where(matched, cls_t, torch.where(
            selected, zero, torch.full_like(cls_t, float(ignore_label))))
    return loc_t, loc_mask, cls_t


def _greedy_keep(boxes, ids, alive0, thresh, force_suppress):
    """Greedy suppression over a sorted prefix: boxes (B, k, 4), ids
    (B, k), alive0 (B, k). Row i stays alive unless an earlier alive row
    of its id (any id under ``force_suppress``) overlaps it by more than
    ``thresh``. Iterates ``alive = alive0 & ~(earlier alive row
    suppresses)`` to its fixed point, which is that greedy result (after
    t steps the first t rows are final); each step is one (B, k, k)
    product."""
    k = boxes.shape[1]
    if k == 0:
        return alive0
    earlier = torch.ones(k, k, dtype=torch.bool,
                         device=boxes.device).triu(diagonal=1)
    sup = (_corner_iou(boxes, boxes) > thresh) & earlier     # [j, i]: j < i
    if not force_suppress:
        sup &= ids[:, :, None] == ids[:, None, :]
    alive = alive0
    for _ in range(k):
        new = alive0 & ~(alive[:, :, None] & sup).any(dim=1)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def _nms_prefix(boxes_s, ids_s, alive0, thresh, force_suppress):
    """Suppression over the longest alive prefix of the sorted rows;
    rows past it stay as ``alive0`` has them (never alive)."""
    B, N = alive0.shape
    k = int(alive0.sum(dim=1).max().item()) if B and N else 0
    alive = alive0.clone()
    if k == 0:
        return alive
    step = max(1, _NMS_CHUNK // (k * k))
    for s in range(0, B, step):
        alive[s:s + step, :k] = _greedy_keep(
            boxes_s[s:s + step, :k], ids_s[s:s + step, :k],
            alive0[s:s + step, :k], thresh, force_suppress)
    return alive


@register("_contrib_MultiBoxDetection", aliases=["contrib_MultiBoxDetection"],
          differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and per-class NMS. Output (B, N, 6) rows ``[cls_id, score,
    x1, y1, x2, y2]`` sorted by score; a row that is not kept has class
    −1 and keeps its score and box."""
    cls_prob, loc_pred, anchor = (t.detach() for t in (cls_prob, loc_pred,
                                                      anchor))
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B = cls_prob.shape[0]
    dtype = torch.promote_types(cls_prob.dtype, _float_dtype(anchors))
    if cls_prob.device.type == "meta":
        return torch.empty(B, N, 6, dtype=dtype, device="meta")
    acx, acy, aw, ah = _centers(anchors)
    l = loc_pred.reshape(B, N, 4)
    cx = l[..., 0] * variances[0] * aw + acx
    cy = l[..., 1] * variances[1] * ah + acy
    w = torch.exp(l[..., 2] * variances[2]) * aw
    h = torch.exp(l[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=2)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    # best non-background class per anchor, emitted as its index among the
    # non-background classes (with background_id 0, class k is k − 1)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score, cls_id = torch.max(fg, dim=1)
    cls_of = torch.where(score > threshold, cls_id.to(dtype),
                         torch.full_like(score, -1.0, dtype=dtype))
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    score_s = torch.gather(score, 1, order)
    cls_s = torch.gather(cls_of, 1, order)
    alive0 = cls_s >= 0
    if nms_topk > 0:
        alive0[:, nms_topk:] = False
    alive = _nms_prefix(boxes_s, cls_s, alive0, nms_threshold,
                        force_suppress)
    cls_final = torch.where(alive, cls_s, torch.full_like(cls_s, -1.0))
    return torch.cat([cls_final[..., None], score_s[..., None].to(dtype),
                      boxes_s.to(dtype)], dim=2)


def _center_to_corner(b):
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                       dim=-1)


@register("_contrib_box_nms", aliases=["contrib_box_nms", "box_nms"],
          differentiable=False)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=0, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Generic NMS over data (..., N, K): rows sorted by score, a row that
    is not kept all −1, the coordinates in ``out_format``."""
    data = data.detach()
    if data.device.type == "meta":
        return torch.empty_like(data)
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    B, N = flat.shape[0], flat.shape[1]
    score = flat[:, :, score_index]
    boxes = flat[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    ids = flat[:, :, id_index] if id_index >= 0 else torch.zeros_like(score)
    valid = score > valid_thresh
    if background_id >= 0 and id_index >= 0:
        valid = valid & (ids != background_id)
    key = torch.where(valid, score, torch.full_like(score, -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    arr_s = torch.gather(flat, 1, order[..., None].expand_as(flat))
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    ids_s = torch.gather(ids, 1, order)
    alive0 = torch.gather(valid, 1, order)
    if topk > 0:
        alive0[:, topk:] = False
    alive = _nms_prefix(boxes_s, ids_s, alive0, overlap_thresh,
                        force_suppress or id_index < 0)
    if out_format != in_format:
        if out_format == "center":
            x1, y1, x2, y2 = boxes_s.unbind(-1)
            conv = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                y2 - y1], dim=-1)
        else:
            conv = boxes_s
        arr_s = torch.cat([arr_s[..., :coord_start], conv.to(arr_s.dtype),
                           arr_s[..., coord_start + 4:]], dim=-1)
    out = torch.where(alive[..., None], arr_s, torch.full_like(arr_s, -1.0))
    return out.reshape(data.shape)


@register("_contrib_box_iou", aliases=["contrib_box_iou"],
          differentiable=False)
def _box_iou(lhs, rhs, format="corner"):
    a = lhs.detach().reshape(-1, 4)
    b = rhs.detach().reshape(-1, 4)
    if format == "center":
        a, b = _center_to_corner(a), _center_to_corner(b)
    return _corner_iou(a, b).reshape(tuple(lhs.shape[:-1])
                                     + tuple(rhs.shape[:-1]))

"""Mini Faster R-CNN on synthetic rectangles on ``mxnet_tpu_torch``, the
PyTorch port: the twin of ``mini_rcnn.py`` beside it, with the same
``make_batch``, ``iou_xyxy``, ``bbox_deltas``, ``decode_deltas``,
``anchor_grid``, ``MiniRCNN`` and ``train`` (the reference
``example/rcnn`` recipe sized to train in seconds: RPN anchors, then
``MultiProposal`` as a sampling stage without gradient, ``ROIPooling``
with gradients into the shared backbone, and the two-head loss, trained
through gluon autograd and Adam).

The task: 3x32x32 images of Gaussian noise with one bright axis-aligned
rectangle, which the detector must localize. ``train`` runs on the
current context (the card, ``gpu(0)``, unless the caller asks for the
CPU: ``ctx=mx.cpu()`` or ``--cpu``); cuDNN runs its convolutions, plain
torch its proposal and ROI ops, and no hand-written kernel is on its path.

Run: python example/rcnn/mini_rcnn_torch.py [--steps 80] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn
# the op decodes rpn_bbox against its anchor grid; training targets must
# use the same grid, so take the framework's generator (the reference
# rcnn example duplicates generate_anchor.py under the same contract)
from mxnet_tpu_torch.ops.contrib_ops import _make_anchors

IMG = 32
STRIDE = 4
FEAT = IMG // STRIDE
SCALES = (3.0,)
RATIOS = (1.0,)
A = len(SCALES) * len(RATIOS)


def make_batch(rng, n):
    """Noise images with one bright rectangle; returns images + gt boxes."""
    x = rng.randn(n, 3, IMG, IMG).astype("float32") * 0.1
    boxes = np.zeros((n, 4), "float32")
    for i in range(n):
        w = rng.randint(10, 18)
        h = rng.randint(10, 18)
        x1 = rng.randint(0, IMG - w)
        y1 = rng.randint(0, IMG - h)
        x[i, :, y1:y1 + h, x1:x1 + w] += 1.0
        boxes[i] = (x1, y1, x1 + w - 1, y1 + h - 1)
    return x, boxes


def iou_xyxy(b, gt):
    """IoU of (..., 4) boxes against a single (4,) gt (inclusive pixels)."""
    ix = np.maximum(0, np.minimum(b[..., 2], gt[2])
                    - np.maximum(b[..., 0], gt[0]) + 1)
    iy = np.maximum(0, np.minimum(b[..., 3], gt[3])
                    - np.maximum(b[..., 1], gt[1]) + 1)
    inter = ix * iy
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    area_g = (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1)
    return inter / (area_b + area_g - inter)


def bbox_deltas(src, gt):
    """Encode gt relative to src boxes: proposal.cc's (dx, dy, dw, dh)."""
    sw = src[:, 2] - src[:, 0] + 1.0
    sh = src[:, 3] - src[:, 1] + 1.0
    sx = src[:, 0] + 0.5 * (sw - 1)
    sy = src[:, 1] + 0.5 * (sh - 1)
    gw = gt[2] - gt[0] + 1.0
    gh = gt[3] - gt[1] + 1.0
    gx = gt[0] + 0.5 * (gw - 1)
    gy = gt[1] + 0.5 * (gh - 1)
    return np.stack([(gx - sx) / sw, (gy - sy) / sh,
                     np.log(gw / sw), np.log(gh / sh)], axis=1)


def decode_deltas(src, d):
    sw = src[:, 2] - src[:, 0] + 1.0
    sh = src[:, 3] - src[:, 1] + 1.0
    sx = src[:, 0] + 0.5 * (sw - 1)
    sy = src[:, 1] + 0.5 * (sh - 1)
    cx = d[:, 0] * sw + sx
    cy = d[:, 1] * sh + sy
    w = np.exp(d[:, 2]) * sw
    h = np.exp(d[:, 3]) * sh
    return np.stack([cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                     cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], axis=1)


def anchor_grid():
    """The op's anchors shifted over the feature map, (FEAT*FEAT*A, 4)."""
    base = _make_anchors(STRIDE, SCALES, RATIOS).numpy()
    sx, sy = np.meshgrid(np.arange(FEAT) * STRIDE, np.arange(FEAT) * STRIDE)
    shifts = np.stack([sx.ravel(), sy.ravel(),
                       sx.ravel(), sy.ravel()], axis=1).astype("float32")
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


class MiniRCNN(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.backbone = nn.HybridSequential()
            for ch in (16, 32):
                self.backbone.add(nn.Conv2D(ch, 3, strides=2, padding=1,
                                            activation="relu"))
            self.rpn_conv = nn.Conv2D(32, 3, padding=1, activation="relu")
            self.rpn_cls = nn.Conv2D(2 * A, 1)
            self.rpn_reg = nn.Conv2D(4 * A, 1)
            self.head_fc = nn.Dense(64, activation="relu")
            self.head_cls = nn.Dense(2)       # background / rectangle
            self.head_reg = nn.Dense(4)

    def features(self, x):
        f = self.backbone(x)
        r = self.rpn_conv(f)
        return f, self.rpn_cls(r), self.rpn_reg(r)

    def head(self, pooled):
        h = self.head_fc(pooled.reshape((pooled.shape[0], -1)))
        return self.head_cls(h), self.head_reg(h)


def proposals(net, x, im_info, batch, post_nms):
    """The RPN's proposals of ``x``: (feature map, RPN scores, RPN deltas,
    rois)."""
    feat, cls_raw, reg_raw = net.features(x)
    cls_prob = mx.nd.softmax(cls_raw.reshape((batch, 2, A * FEAT, FEAT)),
                             axis=1)
    rois = mx.nd.contrib.MultiProposal(
        cls_prob, reg_raw, im_info, feature_stride=STRIDE, scales=SCALES,
        ratios=RATIOS, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=post_nms,
        threshold=0.7, rpn_min_size=4)
    return feat, cls_raw, reg_raw, rois


def train(steps=80, batch=4, lr=2e-3, post_nms=8, seed=0, verbose=True,
          ctx=None):
    """Returns (first_loss, last_loss, eval_iou)."""
    ctx = ctx or mx.current_context()
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    net = MiniRCNN()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    anchors = anchor_grid()
    im_info = mx.nd.array(np.tile([IMG, IMG, 1.0], (batch, 1)), ctx=ctx)

    x_np, gt_np = make_batch(rng, batch)      # memorize one small batch
    x = mx.nd.array(x_np, ctx=ctx)
    # anchor objectness labels: positive iff the centre falls inside the gt
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    rpn_lab, rpn_tgt = [], []
    for i in range(batch):
        g = gt_np[i]
        pos = ((acx >= g[0]) & (acx <= g[2])
               & (acy >= g[1]) & (acy <= g[3]))
        rpn_lab.append(pos.astype("float32"))
        rpn_tgt.append(bbox_deltas(anchors, g).astype("float32"))
    rpn_lab = mx.nd.array(np.stack(rpn_lab), ctx=ctx)   # (N, HW*A)
    rpn_tgt = mx.nd.array(np.stack(rpn_tgt), ctx=ctx)   # (N, HW*A, 4)

    first = last = None
    for step in range(steps):
        with autograd.record():
            # proposals are a sampling stage without gradient, as in the
            # reference (Proposal registers no backward)
            feat, cls_raw, reg_raw, rois = proposals(net, x, im_info, batch,
                                                     post_nms)
            # (N, 2A, H, W) -> (N, HW*A, 2): softmax over {bg, fg}
            cls_pairs = cls_raw.reshape((batch, 2, A, FEAT * FEAT)) \
                .transpose((0, 3, 2, 1)).reshape((batch, -1, 2))
            rpn_cls_loss = ce(cls_pairs, rpn_lab).mean()
            reg = reg_raw.reshape((batch, A, 4, FEAT * FEAT)) \
                .transpose((0, 3, 1, 2)).reshape((batch, -1, 4))
            rpn_reg_loss = (mx.nd.smooth_l1(reg - rpn_tgt, scalar=3.0)
                            * rpn_lab.expand_dims(2)).sum() \
                / (rpn_lab.sum() + 1)
            rois_np = rois.asnumpy()

            # head targets by IoU against each image's gt
            lab_np = np.zeros(len(rois_np), "float32")
            tgt_np = np.zeros((len(rois_np), 4), "float32")
            for r, roi in enumerate(rois_np):
                g = gt_np[int(roi[0])]
                lab_np[r] = float(iou_xyxy(roi[1:], g) > 0.5)
                tgt_np[r] = bbox_deltas(roi[None, 1:], g)[0]
            lab = mx.nd.array(lab_np, ctx=ctx)
            tgt = mx.nd.array(tgt_np, ctx=ctx)

            pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(3, 3),
                                      spatial_scale=1.0 / STRIDE)
            scores, deltas = net.head(pooled)
            head_cls_loss = ce(scores, lab).mean()
            head_reg_loss = (mx.nd.smooth_l1(deltas - tgt, scalar=3.0)
                             * lab.expand_dims(1)).sum() / (lab.sum() + 1)
            loss = rpn_cls_loss + rpn_reg_loss + head_cls_loss + head_reg_loss
        loss.backward()
        trainer.step(1)
        val = float(loss.asnumpy())
        first = val if first is None else first
        last = val
        if verbose and step % 20 == 0:
            print(f"step {step}: loss {val:.4f}")

    # eval: detect on the training images (a memorization check)
    feat, _, _, rois = proposals(net, x, im_info, batch, post_nms)
    pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(3, 3),
                              spatial_scale=1.0 / STRIDE)
    scores, deltas = net.head(pooled)
    fg = mx.nd.softmax(scores, axis=1).asnumpy()[:, 1]
    rois_np = rois.asnumpy()
    deltas_np = deltas.asnumpy()
    ious = []
    for i in range(batch):
        mine = np.where(rois_np[:, 0] == i)[0]
        best = mine[np.argmax(fg[mine])]
        box = decode_deltas(rois_np[best:best + 1, 1:],
                            deltas_np[best:best + 1])[0]
        ious.append(iou_xyxy(box, gt_np[i]))
    eval_iou = float(np.mean(ious))
    if verbose:
        print(f"first {first:.4f} last {last:.4f} mean detection IoU "
              f"{eval_iou:.3f}")
    return first, last, eval_iou


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    train(steps=args.steps, ctx=mx.cpu() if args.cpu else mx.gpu(0))

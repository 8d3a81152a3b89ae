"""Small SSD detection network over the PyTorch port (the twin of
``symbol_ssd.py``; reference example/ssd/symbol/symbol_builder.py
distilled): conv body, two detection scales, per-scale class + box heads,
MultiBoxPrior anchors, MultiBoxTarget training targets, MultiBoxDetection
inference decode. The port's executor runs the graph op by op; the
anchors are built once per feature-map shape and cached.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402

sym = mx.sym


def conv_block(data, num_filter, name, stride=(1, 1)):
    net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), stride=stride,
                          num_filter=num_filter, name=f"{name}_conv")
    net = sym.BatchNorm(net, fix_gamma=False, name=f"{name}_bn")
    return sym.Activation(net, act_type="relu", name=f"{name}_relu")


def build_body(data):
    """Tiny VGG-ish body returning two feature scales."""
    net = conv_block(data, 16, "b1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = conv_block(net, 32, "b2")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    scale1 = conv_block(net, 64, "b3")                      # /4
    scale2 = conv_block(sym.Pooling(scale1, kernel=(2, 2), stride=(2, 2),
                                    pool_type="max"), 64, "b4")  # /8
    return [scale1, scale2]


SCALE_SIZES = [(0.3, 0.4), (0.6, 0.8)]
SCALE_RATIOS = [(1.0, 2.0, 0.5)] * 2


def build_ssd(num_classes, mode="train"):
    """Returns the SSD symbol. mode='train': outputs [cls_prob, loc_loss,
    cls_target] losses; mode='det': MultiBoxDetection output
    (B, N, 6) [cls, score, x1, y1, x2, y2]."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    feats = build_body(data)

    cls_preds, loc_preds, anchors = [], [], []
    for i, (feat, sizes, ratios) in enumerate(
            zip(feats, SCALE_SIZES, SCALE_RATIOS)):
        na = len(sizes) + len(ratios) - 1
        cp = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                             num_filter=na * (num_classes + 1),
                             name=f"cls_head{i}")
        lp = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                             num_filter=na * 4, name=f"loc_head{i}")
        # (B, na*(C+1), H, W) -> (B, N_i*(C+1)); N laid out anchor-major
        cls_preds.append(sym.Flatten(sym.transpose(cp, axes=(0, 2, 3, 1))))
        loc_preds.append(sym.Flatten(sym.transpose(lp, axes=(0, 2, 3, 1))))
        anchors.append(sym.Reshape(
            sym._contrib_MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                       clip=True, name=f"anchors{i}"),
            shape=(1, -1, 4)))

    cls_pred = sym.Concat(*cls_preds, dim=1, name="cls_concat")
    loc_pred = sym.Concat(*loc_preds, dim=1, name="loc_concat")
    anchor = sym.Concat(*anchors, dim=1, name="anchor_concat")
    # (B, total*(C+1)) -> (B, C+1, total): class-scores per anchor
    cls_pred = sym.transpose(
        sym.Reshape(cls_pred, shape=(0, -1, num_classes + 1)),
        axes=(0, 2, 1), name="cls_pred")

    if mode == "det":
        cls_prob = sym.softmax(cls_pred, axis=1, name="cls_prob")
        return sym._contrib_MultiBoxDetection(
            cls_prob, loc_pred, anchor, name="detection",
            nms_threshold=0.45, nms_topk=40)

    loc_target, loc_mask, cls_target = sym._contrib_MultiBoxTarget(
        anchor, label, cls_pred, overlap_threshold=0.5,
        negative_mining_ratio=3.0, negative_mining_thresh=0.5,
        name="multibox_target")
    cls_prob = sym.SoftmaxOutput(cls_pred, cls_target, ignore_label=-1,
                                 use_ignore=True, multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_pred * loc_mask - loc_target
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    # BlockGrad'd heads let the fit loop read targets for metrics
    return sym.Group([cls_prob, loc_loss, sym.BlockGrad(cls_target),
                      sym.BlockGrad(loc_target)])

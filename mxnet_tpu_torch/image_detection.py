"""Detection augmenters.

Counterpart of ``mxnet_tpu/image_detection.py`` (reference
``python/mxnet/image/detection.py`` and the det variants of
``src/io/image_aug_default.cc``).

Augmenters transform ``(image HWC NDArray, label (N, 5) numpy [cls, x1, y1,
x2, y2] normalized)`` pairs, keeping boxes consistent with the pixels:
flips mirror coordinates, IOU-constrained random crops drop/clip boxes,
random expansion pads and rescales them. They draw from Python's
``random``, as the JAX ones do."""
from __future__ import annotations

import random
from typing import List

import numpy as np

from . import image as img_mod
from . import ndarray as nd

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter"]


class DetAugmenter:
    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a plain image augmenter that doesn't move pixels' positions
    (color jitter, cast, normalize — reference DetBorrowAug)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = nd.flip(src, axis=1)
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[:, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1[valid]
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IOU-constrained random crop (reference DetRandomCropAug / SSD data
    augmentation): sample crops until one overlaps some box with IOU >=
    min_object_covered; clip boxes to the crop, drop those whose center
    falls outside."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts=25):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _crop_iou(self, crop, boxes):
        cx1, cy1, cx2, cy2 = crop
        ix1 = np.maximum(boxes[:, 0], cx1)
        iy1 = np.maximum(boxes[:, 1], cy1)
        ix2 = np.minimum(boxes[:, 2], cx2)
        iy2 = np.minimum(boxes[:, 3], cy2)
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        area = np.maximum((boxes[:, 2] - boxes[:, 0])
                          * (boxes[:, 3] - boxes[:, 1]), 1e-12)
        return inter / area

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        valid = label[:, 0] >= 0
        boxes = label[valid, 1:5]
        for _ in range(self.max_attempts):
            area = random.uniform(*self.area_range)
            ar = random.uniform(*self.aspect_ratio_range)
            cw = min(np.sqrt(area * ar), 1.0)
            ch = min(np.sqrt(area / ar), 1.0)
            cx = random.uniform(0, 1.0 - cw)
            cy = random.uniform(0, 1.0 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if len(boxes) and self._crop_iou(crop, boxes).max() \
                    < self.min_object_covered:
                continue
            # pixel crop
            x0, y0 = int(cx * w), int(cy * h)
            x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
            out = src[y0:y1, x0:x1]
            new_label = np.full_like(label, -1.0)
            j = 0
            for row in label[valid]:
                bx1, by1, bx2, by2 = row[1:5]
                ctr_x, ctr_y = (bx1 + bx2) / 2, (by1 + by2) / 2
                if not (crop[0] <= ctr_x <= crop[2]
                        and crop[1] <= ctr_y <= crop[3]):
                    continue
                nx1 = (max(bx1, crop[0]) - crop[0]) / cw
                ny1 = (max(by1, crop[1]) - crop[1]) / ch
                nx2 = (min(bx2, crop[2]) - crop[0]) / cw
                ny2 = (min(by2, crop[3]) - crop[1]) / ch
                new_label[j] = (row[0], nx1, ny1, nx2, ny2)
                j += 1
            if j == 0:
                continue
            return out, new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion: place the image inside a larger mean-filled canvas
    and rescale boxes (reference DetRandomPadAug / SSD zoom-out)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), pad_val=(127, 127, 127), p=0.5):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.pad_val = np.asarray(pad_val, "float32")
        self.p = p

    def __call__(self, src, label):
        if random.random() > self.p:
            return src, label
        h, w = src.shape[0], src.shape[1]
        expand = random.uniform(*self.area_range)
        if expand <= 1.0:
            return src, label
        nh, nw = int(h * np.sqrt(expand)), int(w * np.sqrt(expand))
        y0 = random.randint(0, nh - h)
        x0 = random.randint(0, nw - w)
        canvas = np.tile(self.pad_val.reshape(1, 1, 3), (nh, nw, 1))
        canvas[y0:y0 + h, x0:x0 + w] = src.asnumpy()
        label = label.copy()
        valid = label[:, 0] >= 0
        label[valid, 1] = (label[valid, 1] * w + x0) / nw
        label[valid, 3] = (label[valid, 3] * w + x0) / nw
        label[valid, 2] = (label[valid, 2] * h + y0) / nh
        label[valid, 4] = (label[valid, 4] * h + y0) / nh
        return nd.array(canvas, ctx=src.context), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_pad=0.0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, hue=0, pca_noise=0,
                       min_object_covered=0.3, area_range=(0.3, 3.0),
                       **kwargs) -> List[DetAugmenter]:
    """Detection augmentation list builder (reference
    image/detection.py:CreateDetAugmenter)."""
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(img_mod.ResizeAug(resize)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(
            min_object_covered=min_object_covered,
            area_range=(area_range[0], min(area_range[1], 1.0))))
    if rand_pad > 0:
        auglist.append(DetRandomPadAug(
            area_range=(1.0, max(area_range[1], 1.0)), p=rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(img_mod.ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    auglist.append(DetBorrowAug(img_mod.CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            img_mod.ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(img_mod.HueJitterAug(hue)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(img_mod.LightingAug(
            pca_noise, img_mod._PCA_EIGVAL, img_mod._PCA_EIGVEC)))
    norm = img_mod.make_norm_aug(mean, std)
    if norm is not None:
        auglist.append(DetBorrowAug(norm))
    return auglist

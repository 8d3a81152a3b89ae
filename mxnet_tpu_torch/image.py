"""``mx.image`` — image decoding, augmenters and ``ImageIter``.

Counterpart of ``mxnet_tpu/image.py`` (reference
``python/mxnet/image/image.py``): ``imdecode``/``imread``/``imresize``,
the crops, ``color_normalize``, the ``Augmenter`` family,
``CreateAugmenter`` and ``ImageIter``. Decoding and uint8 resizing run
through Pillow (imported at first use; without it they raise
``MXNetError``) into host arrays (``cpu()``), as the reference's decoder
gives them; an augmenter keeps its input's context. A float image is
resized with ``torch.nn.functional.interpolate`` where the JAX package
uses ``jax.image.resize`` (the same half-pixel grid; antialiased when it
shrinks). The augmenters draw from Python's ``random`` and numpy's global
stream, as the JAX ones do, so seeded runs match draw for draw.
"""
from __future__ import annotations

import io as _io
import os
import random
from typing import List, Optional

import numpy as np
import torch

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray
from .recordio import _pil

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ColorJitterAug", "LightingAug", "CastAug",
           "HueJitterAug", "RandomGrayAug", "RandomOrderAug",
           "CreateAugmenter", "ImageIter",
           "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter"]


def _const(values, like: NDArray) -> NDArray:
    """A float32 array of ``values`` on ``like``'s device."""
    return nd.array(np.asarray(values, dtype="float32"), ctx=like.context)


def imdecode(buf, flag=1, to_rgb=True, **kwargs) -> NDArray:
    """Decode an image file's bytes to an HWC uint8 host array (RGB, BGR
    with ``to_rgb=False``, one channel with ``flag=0``)."""
    Image = _pil()
    img = Image.open(_io.BytesIO(buf if isinstance(buf, bytes)
                                 else bytes(buf)))
    if flag == 0:
        arr = np.asarray(img.convert("L"))[:, :, None]
    else:
        arr = np.asarray(img.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return nd.array(arr, ctx=cpu(), dtype="uint8")


def imread(filename, flag=1, to_rgb=True) -> NDArray:
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src: NDArray, w: int, h: int, interp=1) -> NDArray:
    """Resize an HWC image to (h, w): uint8 through Pillow (nearest for
    ``interp=0``, else bilinear), any other dtype on its own device."""
    if src.dtype != np.uint8:
        x = src._data.permute(2, 0, 1)[None].float()
        if interp == 0:
            out = torch.nn.functional.interpolate(x, size=(h, w),
                                                  mode="nearest-exact")
        else:
            out = torch.nn.functional.interpolate(
                x, size=(h, w), mode="bilinear", align_corners=False,
                antialias=h < x.shape[2] or w < x.shape[3])
        return NDArray(out[0].permute(1, 2, 0).to(src._data.dtype))
    Image = _pil()
    arr = src.asnumpy()
    pil = Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr)
    out = np.asarray(pil.resize((w, h), Image.NEAREST if interp == 0
                                else Image.BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return nd.array(out, ctx=src.context, dtype="uint8")


def resize_short(src: NDArray, size: int, interp=2) -> NDArray:
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2) -> NDArray:
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None) -> NDArray:
    src = src.astype("float32", copy=False)
    out = src - (mean if isinstance(mean, NDArray) else _const(mean, src))
    if std is not None:
        out = out / (std if isinstance(std, NDArray) else _const(std, src))
    return out


# ---------------------------------------------------------------- augmenters
class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src: NDArray) -> NDArray:
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return nd.flip(src, axis=1)
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src.astype("float32", copy=False) * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        src = src.astype("float32", copy=False)
        gray = float(nd.mean(src).asscalar())
        return src * alpha + gray * (1 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        src = src.astype("float32", copy=False)
        coef = _const(np.array([0.299, 0.587, 0.114]).reshape(1, 1, 3), src)
        gray = nd.sum(src * coef, axis=2, keepdims=True)
        return src * alpha + gray * (1 - alpha)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        random.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


class LightingAug(Augmenter):
    """PCA-based lighting noise (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype="float32")
        self.eigvec = np.asarray(eigvec, dtype="float32")

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)).astype("float32")
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return src.astype("float32", copy=False) + _const(rgb.reshape(1, 1, 3),
                                                          src)


class HueJitterAug(Augmenter):
    """Random hue rotation in YIQ space (reference HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], "float32")
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], "float32")

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], "float32")
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        src = src.astype("float32", copy=False)
        return nd.dot(src, _const(t, src))


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel grayscale (reference RandomGrayAug)."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], "float32")

    def __call__(self, src):
        if random.random() < self.p:
            src = src.astype("float32", copy=False)
            return nd.dot(src, _const(self.mat, src))
        return src


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ, copy=False)


_PCA_EIGVAL = [55.46, 4.794, 1.148]
_PCA_EIGVEC = [[-0.5675, 0.7192, 0.4009],
               [-0.5808, -0.0045, -0.8140],
               [-0.5836, -0.6948, 0.4203]]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2,
                    **kwargs) -> List[Augmenter]:
    """Standard augmentation list builder (reference
    image.py:CreateAugmenter)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if kwargs.get("hue"):
        auglist.append(HueJitterAug(kwargs["hue"]))
    if kwargs.get("rand_gray"):
        auglist.append(RandomGrayAug(kwargs["rand_gray"]))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    norm = make_norm_aug(mean, std)
    if norm is not None:
        auglist.append(norm)
    return auglist


def make_norm_aug(mean, std) -> Optional[Augmenter]:
    """mean/std normalization augmenter; True selects the ImageNet defaults
    (shared by CreateAugmenter and CreateDetAugmenter). None if neither
    given."""
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], dtype="float32")
    if std is True:
        std = np.array([58.395, 57.12, 57.375], dtype="float32")
    if mean is None and std is None:
        return None

    class _Norm(Augmenter):
        def __call__(self, src):
            m = mean if mean is not None else np.zeros(np.shape(std))
            return color_normalize(src, _const(m, src),
                                   None if std is None else _const(std, src))

    return _Norm()


class ImageIter:
    """Image iterator over a ``.rec`` file or a ``.lst`` list of image
    files with augmenters (reference image.py:ImageIter). Batches go to
    ``ctx`` (the current context by default: the card)."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 ctx=None, **kwargs):
        from .context import current_context
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.ctx = ctx or current_context()
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(self.data_shape, **kwargs)
        self._entries: List = []
        if path_imgrec:
            from .io.io import ImageRecordIter
            self._rec_iter = ImageRecordIter(
                path_imgrec=path_imgrec, data_shape=self.data_shape,
                batch_size=batch_size, shuffle=shuffle, ctx=self.ctx,
                **kwargs)
        else:
            self._rec_iter = None
            entries = []
            if imglist is not None:
                entries = [(float(l[0]), os.path.join(path_root, l[1]))
                           for l in imglist]
            elif path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        entries.append((float(parts[1]),
                                        os.path.join(path_root, parts[-1])))
            self._entries = entries
            self._order = list(range(len(entries)))
            self._shuffle = shuffle
            self._pos = 0

    def reset(self):
        if self._rec_iter is not None:
            self._rec_iter.reset()
        else:
            self._pos = 0
            if self._shuffle:
                random.shuffle(self._order)

    def __iter__(self):
        return self

    def next(self):
        from .io.io import DataBatch
        if self._rec_iter is not None:
            return self._rec_iter.next()
        if self._pos >= len(self._entries):
            raise StopIteration
        datas, labels = [], []
        while len(datas) < self.batch_size and self._pos < len(self._entries):
            label, path = self._entries[self._order[self._pos]]
            img = imread(path)
            for aug in self.auglist:
                img = aug(img)
            datas.append(img._data.float().permute(2, 0, 1))
            labels.append(label)
            self._pos += 1
        pad = self.batch_size - len(datas)
        while len(datas) < self.batch_size:
            datas.append(datas[-1])
            labels.append(labels[-1])
        return DataBatch(
            data=[nd.array(torch.stack(datas), ctx=self.ctx)],
            label=[nd.array(np.asarray(labels, dtype="float32"),
                            ctx=self.ctx)], pad=pad)

    __next__ = next


# detection augmenters live in their own module but are exposed here like
# the reference's mxnet.image namespace (python/mxnet/image/detection.py)
from .image_detection import (DetAugmenter, DetBorrowAug,            # noqa: E402,F401
                              DetHorizontalFlipAug, DetRandomCropAug,
                              DetRandomPadAug, CreateDetAugmenter)

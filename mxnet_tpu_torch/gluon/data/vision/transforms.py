"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference
``python/mxnet/gluon/data/vision/transforms.py``). Each transform is a
``Block`` over one HWC image (``ToTensor`` makes it CHW) on its own
device; the random ones draw from numpy's global stream, as the JAX ones
do. ``Resize`` is bilinear on the half-pixel grid, antialiased when it
shrinks (``torch.nn.functional.interpolate`` where the JAX package uses
``jax.image.resize``); a uint8 image comes back as uint8, truncated."""
from __future__ import annotations

import numpy as np
import torch

from .... import ndarray as nd
from ....ndarray import NDArray
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation"]


def _const(values, like: NDArray) -> NDArray:
    return nd.array(np.asarray(values, dtype="float32"), ctx=like.context)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def forward(self, x):
        return nd.transpose(x.astype("float32") / 255.0, axes=(2, 0, 1))


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype="float32").reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype="float32").reshape(-1, 1, 1)

    def forward(self, x):
        return (x - _const(self._mean, x)) / _const(self._std, x)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        data = x._data.permute(2, 0, 1)[None].to(torch.float32)
        out = torch.nn.functional.interpolate(
            data, size=(h, w), mode="bilinear", align_corners=False,
            antialias=h < data.shape[2] or w < data.shape[3])
        out = out[0].permute(1, 2, 0)
        return NDArray(out.to(x._data.dtype) if x.dtype == np.uint8 else out)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            ar = np.exp(np.random.uniform(np.log(self._ratio[0]),
                                          np.log(self._ratio[1])))
            w = int(round(np.sqrt(target_area * ar)))
            h = int(round(np.sqrt(target_area / ar)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = x[y0:y0 + h, x0:x0 + w]
                return Resize(self._size).forward(crop)
        return Resize(self._size).forward(CenterCrop(min(H, W)).forward(x))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return nd.flip(x, axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return nd.flip(x, axis=0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._c, self._c)
        gray = nd.mean(x)
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._s, self._s)
        coef = _const(np.array([0.299, 0.587, 0.114]).reshape(1, 1, 3), x)
        gray = nd.sum(x * coef, axis=2, keepdims=True)
        return x * alpha + gray * (1 - alpha)

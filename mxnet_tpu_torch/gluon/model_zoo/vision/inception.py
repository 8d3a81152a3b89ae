"""Inception V3.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``
(reference ``python/mxnet/gluon/model_zoo/vision/inception.py``): the
same stage order, branch widths, factorized 7x7/3x3 convolutions
(Szegedy et al. 2015) and parameter names. Every stage takes ``layout``,
so the whole net can be built channel-last ("NHWC"), with the branches
concatenated on the trailing channel axis.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _ch_axis(layout):
    return -1 if layout.endswith("C") else 1


class _ConvUnit(nn.HybridSequential):
    """conv(no bias) -> BN(eps 1e-3) -> relu, the building unit every
    Inception branch is made of."""

    def __init__(self, channels, kernel, stride=1, pad=0, layout="NCHW"):
        super().__init__(prefix="")
        self.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                           padding=pad, use_bias=False, layout=layout))
        self.add(nn.BatchNorm(epsilon=0.001, axis=_ch_axis(layout)))
        self.add(nn.Activation("relu"))


class _Branches(HybridBlock):
    """Run child branches on the same input and concatenate on channels
    (the inception "mixed" pattern; gluon.contrib.HybridConcurrent)."""

    def __init__(self, branches, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._axis = _ch_axis(layout)
        for b in branches:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        return F.Concat(*[child(x) for child in self._children.values()],
                        dim=self._axis)


def _seq(*blocks):
    out = nn.HybridSequential(prefix="")
    for b in blocks:
        out.add(b)
    return out


def _stage_a(pool_features, layout, prefix):
    """35x35 stage: 1x1 / 5x5 / double-3x3 / pooled-1x1 branches."""
    L = layout
    return _Branches([
        _ConvUnit(64, kernel=1, layout=L),
        _seq(_ConvUnit(48, kernel=1, layout=L),
             _ConvUnit(64, kernel=5, pad=2, layout=L)),
        _seq(_ConvUnit(64, kernel=1, layout=L),
             _ConvUnit(96, kernel=3, pad=1, layout=L),
             _ConvUnit(96, kernel=3, pad=1, layout=L)),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1, layout=L),
             _ConvUnit(pool_features, kernel=1, layout=L)),
    ], layout=L, prefix=prefix)


def _reduction_b(layout, prefix):
    """35x35 -> 17x17 grid reduction."""
    L = layout
    return _Branches([
        _ConvUnit(384, kernel=3, stride=2, layout=L),
        _seq(_ConvUnit(64, kernel=1, layout=L),
             _ConvUnit(96, kernel=3, pad=1, layout=L),
             _ConvUnit(96, kernel=3, stride=2, layout=L)),
        nn.MaxPool2D(pool_size=3, strides=2, layout=L),
    ], layout=L, prefix=prefix)


def _stage_c(mid, layout, prefix):
    """17x17 stage with 7x7 factorized into 1x7/7x1 pairs; ``mid`` is the
    bottleneck width (128/160/192 across the four C stages)."""
    L = layout
    return _Branches([
        _ConvUnit(192, kernel=1, layout=L),
        _seq(_ConvUnit(mid, kernel=1, layout=L),
             _ConvUnit(mid, kernel=(1, 7), pad=(0, 3), layout=L),
             _ConvUnit(192, kernel=(7, 1), pad=(3, 0), layout=L)),
        _seq(_ConvUnit(mid, kernel=1, layout=L),
             _ConvUnit(mid, kernel=(7, 1), pad=(3, 0), layout=L),
             _ConvUnit(mid, kernel=(1, 7), pad=(0, 3), layout=L),
             _ConvUnit(mid, kernel=(7, 1), pad=(3, 0), layout=L),
             _ConvUnit(192, kernel=(1, 7), pad=(0, 3), layout=L)),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1, layout=L),
             _ConvUnit(192, kernel=1, layout=L)),
    ], layout=L, prefix=prefix)


def _reduction_d(layout, prefix):
    """17x17 -> 8x8 grid reduction."""
    L = layout
    return _Branches([
        _seq(_ConvUnit(192, kernel=1, layout=L),
             _ConvUnit(320, kernel=3, stride=2, layout=L)),
        _seq(_ConvUnit(192, kernel=1, layout=L),
             _ConvUnit(192, kernel=(1, 7), pad=(0, 3), layout=L),
             _ConvUnit(192, kernel=(7, 1), pad=(3, 0), layout=L),
             _ConvUnit(192, kernel=3, stride=2, layout=L)),
        nn.MaxPool2D(pool_size=3, strides=2, layout=L),
    ], layout=L, prefix=prefix)


class _Fork(HybridBlock):
    """stem -> concat(left(stem_out), right(stem_out)): the expanded-filter
    bank of the 8x8 stage, where a shared stem fans into two sibling convs."""

    def __init__(self, stem, left, right, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._axis = _ch_axis(layout)
        self.stem = stem
        self.left = left
        self.right = right

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        return F.Concat(self.left(x), self.right(x), dim=self._axis)


def _stage_e(layout, prefix):
    """8x8 stage: 3x3s expanded into parallel 1x3 + 3x1 siblings."""
    L = layout
    return _Branches([
        _ConvUnit(320, kernel=1, layout=L),
        _Fork(_ConvUnit(384, kernel=1, layout=L),
              _ConvUnit(384, kernel=(1, 3), pad=(0, 1), layout=L),
              _ConvUnit(384, kernel=(3, 1), pad=(1, 0), layout=L),
              layout=L),
        _Fork(_seq(_ConvUnit(448, kernel=1, layout=L),
                   _ConvUnit(384, kernel=3, pad=1, layout=L)),
              _ConvUnit(384, kernel=(1, 3), pad=(0, 1), layout=L),
              _ConvUnit(384, kernel=(3, 1), pad=(1, 0), layout=L),
              layout=L),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1, layout=L),
             _ConvUnit(192, kernel=1, layout=L)),
    ], layout=L, prefix=prefix)


class Inception3(HybridBlock):
    """Inception V3 (input 299x299; ``layout`` in {"NCHW", "NHWC"})."""

    def __init__(self, classes=1000, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        L = layout
        with self.name_scope():
            self.features = _seq(
                _ConvUnit(32, kernel=3, stride=2, layout=L),
                _ConvUnit(32, kernel=3, layout=L),
                _ConvUnit(64, kernel=3, pad=1, layout=L),
                nn.MaxPool2D(pool_size=3, strides=2, layout=L),
                _ConvUnit(80, kernel=1, layout=L),
                _ConvUnit(192, kernel=3, layout=L),
                nn.MaxPool2D(pool_size=3, strides=2, layout=L),
            )
            for i, pool_ch in enumerate((32, 64, 64)):
                self.features.add(_stage_a(pool_ch, L, f"A{i + 1}_"))
            self.features.add(_reduction_b(L, "B_"))
            for i, mid in enumerate((128, 160, 160, 192)):
                self.features.add(_stage_c(mid, L, f"C{i + 1}_"))
            self.features.add(_reduction_d(L, "D_"))
            self.features.add(_stage_e(L, "E1_"))
            self.features.add(_stage_e(L, "E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8, layout=L))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Constructor used by ``model_zoo.get_model('inceptionv3')``."""
    return Inception3(**kwargs)

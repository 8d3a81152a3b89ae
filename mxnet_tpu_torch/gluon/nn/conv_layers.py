"""Convolution and pooling Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference
``python/mxnet/gluon/nn/conv_layers.py``): the layers over the
``Convolution``, ``Deconvolution``, ``Pooling`` and ``Pad`` ops, with the
JAX package's parameter names and shapes. A channel-last conv weight is
(O, *kernel, I) and is drawn by its initializer in the (O, I, *kernel)
order, so its values' scale is its channel-first twin's.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """Convolution (``op_name="Convolution"``) or transposed convolution
    (``"Deconvolution"``, weight (in, out/g, *kernel)); ``in_channels=0``
    defers the weight's shape to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._in_channels = in_channels
        ndim = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        self._act_type = activation
        with self.name_scope():
            if op_name == "Convolution":
                if layout and layout.endswith("C"):  # channel-last: (O, *k, I)
                    wshape = (channels,) + tuple(kernel_size) \
                        + (in_channels // groups if in_channels else 0,)
                else:
                    wshape = (channels,
                              in_channels // groups if in_channels else 0) \
                        + tuple(kernel_size)
            else:  # Deconvolution: (in, out//g, *k)
                wshape = (in_channels if in_channels else 0, channels // groups) \
                    + tuple(kernel_size)
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if op_name == "Convolution" and layout and layout.endswith("C"):
                # initializers see the canonical (O,I,*k) view so fan-in/out
                # scaling (and the drawn values) match the NCHW twin exactly
                self.weight._init_perm = (0,) + tuple(
                    range(2, 2 + ndim)) + (1,)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        kw = dict(self._kwargs)
        kw["no_bias"] = bias is None
        out = op(x, weight, bias, **kw)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", in_channels=0,
                 prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1), padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, output_padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", in_channels=0,
                 prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tup(output_padding, 1), prefix=prefix, params=params)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tup(output_padding, 2), prefix=prefix, params=params)


class _Pooling(HybridBlock):
    """The ``Pooling`` op; ``ceil_mode`` is the "full" convention."""

    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "pool_type": pool_type, "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad, "layout": layout}

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 1), None if strides is None else _tup(strides, 1),
                         _tup(padding, 1), False, "max", layout, ceil_mode, **kw)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 2), None if strides is None else _tup(strides, 2),
                         _tup(padding, 2), False, "max", layout, ceil_mode, **kw)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0, layout="NCDHW",
                 ceil_mode=False, **kw):
        super().__init__(_tup(pool_size, 3), None if strides is None else _tup(strides, 3),
                         _tup(padding, 3), False, "max", layout, ceil_mode, **kw)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(_tup(pool_size, 1), None if strides is None else _tup(strides, 1),
                         _tup(padding, 1), False, "avg", layout, ceil_mode,
                         count_include_pad, **kw)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(_tup(pool_size, 2), None if strides is None else _tup(strides, 2),
                         _tup(padding, 2), False, "avg", layout, ceil_mode,
                         count_include_pad, **kw)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0, layout="NCDHW",
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(_tup(pool_size, 3), None if strides is None else _tup(strides, 3),
                         _tup(padding, 3), False, "avg", layout, ceil_mode,
                         count_include_pad, **kw)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kw):
        super().__init__((1,), (1,), (0,), True, "max", layout, **kw)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), (1, 1), (0, 0), True, "max", layout, **kw)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kw):
        super().__init__((1, 1, 1), (1, 1, 1), (0, 0, 0), True, "max", layout, **kw)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kw):
        super().__init__((1,), (1,), (0,), True, "avg", layout, **kw)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), (1, 1), (0, 0), True, "avg", layout, **kw)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kw):
        super().__init__((1, 1, 1), (1, 1, 1), (0, 0, 0), True, "avg", layout, **kw)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)

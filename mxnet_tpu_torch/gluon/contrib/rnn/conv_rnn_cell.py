"""Convolutional recurrent cells, ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``
(counterpart of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``;
reference ``gluon/contrib/rnn/conv_rnn_cell.py``; Shi et al. 2015's
ConvLSTM): the input-to-hidden and hidden-to-hidden projections are
convolutions (one for all the gates of each), and the states keep the
spatial dims, (batch, channels, *spatial). cuDNN runs the convolutions.
"""
from __future__ import annotations

from .... import ndarray as nd
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuplize(v, dims):
    return (v,) * dims if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(RecurrentCell):
    """The parameters, state shapes and gate convolutions shared by the
    three kinds; ``input_shape`` is (C_in, *spatial), the hidden-to-hidden
    kernel odd (its padding keeps the spatial dims)."""

    _num_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, activation, num_gates, dims,
                 conv_layout="NCHW", prefix=None, params=None):
        super().__init__(prefix, params)
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._dims = dims
        self._num_gates = num_gates
        self._activation = activation
        self._i2h_kernel = _tuplize(i2h_kernel, dims)
        self._h2h_kernel = _tuplize(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                f"h2h_kernel must be odd to preserve spatial dims, got "
                f"{self._h2h_kernel}")
        self._i2h_pad = _tuplize(i2h_pad, dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        out_ch = num_gates * hidden_channels
        in_ch = self._input_shape[0]
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(out_ch, in_ch, *self._i2h_kernel),
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(out_ch, hidden_channels, *self._h2h_kernel),
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(out_ch,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(out_ch,), init="zeros",
                allow_deferred_init=True)

    def _spatial_out(self):
        """The input-to-hidden convolution's output size (stride and
        dilation 1)."""
        return tuple(s + 2 * p - k + 1 for s, k, p in
                     zip(self._input_shape[1:], self._i2h_kernel,
                         self._i2h_pad))

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels, *self._spatial_out())
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}
                ] * self._num_states

    def _conv_gates(self, x, h):
        out_ch = self._num_gates * self._hidden_channels
        i2h = nd.Convolution(x, self.i2h_weight.data(), self.i2h_bias.data(),
                             kernel=self._i2h_kernel, pad=self._i2h_pad,
                             num_filter=out_ch)
        h2h = nd.Convolution(h, self.h2h_weight.data(), self.h2h_bias.data(),
                             kernel=self._h2h_kernel, pad=self._h2h_pad,
                             num_filter=out_ch)
        return i2h, h2h

    def _act(self, x):
        return nd.Activation(x, act_type=self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    _gates = 1

    def _cell_forward(self, x, states):
        i2h, h2h = self._conv_gates(x, states[0])
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _gates = 4
    _num_states = 2

    def _cell_forward(self, x, states):
        i2h, h2h = self._conv_gates(x, states[0])
        i, f, g, o = nd.split(i2h + h2h, 4, axis=1)
        c = nd.sigmoid(f) * states[1] + nd.sigmoid(i) * self._act(g)
        h = nd.sigmoid(o) * self._act(c)
        return h, [h, c]


class _ConvGRUCell(_BaseConvRNNCell):
    _gates = 3

    def _cell_forward(self, x, states):
        i2h, h2h = self._conv_gates(x, states[0])
        i2h_r, i2h_z, i2h_n = nd.split(i2h, 3, axis=1)
        h2h_r, h2h_z, h2h_n = nd.split(h2h, 3, axis=1)
        r = nd.sigmoid(i2h_r + h2h_r)
        z = nd.sigmoid(i2h_z + h2h_z)
        n = self._act(i2h_n + r * h2h_n)
        out = (1 - z) * n + z * states[0]
        return out, [out]


def _make(name, dims, base):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, activation="tanh", prefix=None, params=None):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad, activation, base._gates, dims,
                      prefix=prefix, params=params)
    return type(name, (base,), {"__init__": __init__,
                                "__module__": __name__})


Conv1DRNNCell = _make("Conv1DRNNCell", 1, _ConvRNNCell)
Conv2DRNNCell = _make("Conv2DRNNCell", 2, _ConvRNNCell)
Conv3DRNNCell = _make("Conv3DRNNCell", 3, _ConvRNNCell)
Conv1DLSTMCell = _make("Conv1DLSTMCell", 1, _ConvLSTMCell)
Conv2DLSTMCell = _make("Conv2DLSTMCell", 2, _ConvLSTMCell)
Conv3DLSTMCell = _make("Conv3DLSTMCell", 3, _ConvLSTMCell)
Conv1DGRUCell = _make("Conv1DGRUCell", 1, _ConvGRUCell)
Conv2DGRUCell = _make("Conv2DGRUCell", 2, _ConvGRUCell)
Conv3DGRUCell = _make("Conv3DGRUCell", 3, _ConvGRUCell)

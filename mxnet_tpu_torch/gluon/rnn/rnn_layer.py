"""Fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
``python/mxnet/gluon/rnn/rnn_layer.py``). The parameters are registered
for each layer and direction (``l0_i2h_weight`` … ``r1_h2h_bias``) under
the reference's names, so files and carried weights keep them. Traced to
a Symbol (``hybridize``, ``export``) the layer packs them into the ``RNN``
op's flat vector, as the JAX package does at every forward. On NDArrays it
hands them to :func:`~mxnet_tpu_torch.ops.rnn.rnn_forward` as they are:
eager torch would copy the whole vector forward and split it again in the
backward, where XLA folds the packing away.
"""
from __future__ import annotations

import torch

from ... import autograd, ndarray as nd
from ... import random as _random
from ...base import MXNetError
from ...ndarray import NDArray
from ...ops.rnn import rnn_forward
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"bad layout {layout}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        ng = _GATES[mode] * hidden_size
        with self.name_scope():
            for name, shape, init in self._param_specs(
                    ng, i2h_weight_initializer, h2h_weight_initializer,
                    i2h_bias_initializer, h2h_bias_initializer):
                setattr(self, name, self.params.get(
                    name, shape=shape, init=init, allow_deferred_init=True))

    def _param_specs(self, ng, i2h_w, h2h_w, i2h_b, h2h_b):
        for layer in range(self._num_layers):
            for d in "lr"[:self._dir]:
                in_sz = self._input_size if layer == 0 \
                    else self._hidden_size * self._dir
                yield f"{d}{layer}_i2h_weight", (ng, in_sz), i2h_w
                yield f"{d}{layer}_h2h_weight", (ng, self._hidden_size), \
                    h2h_w
                yield f"{d}{layer}_i2h_bias", (ng,), i2h_b
                yield f"{d}{layer}_h2h_bias", (ng,), h2h_b

    def _keys(self):
        """``(i2h_weight, h2h_weight, i2h_bias, h2h_bias)`` names for each
        layer and direction, in the packed order."""
        return [tuple(f"{d}{layer}_{k}" for k in
                      ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
                for layer in range(self._num_layers)
                for d in "lr"[:self._dir]]

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states as NDArrays (``func`` defaults to ``nd.zeros``)."""
        func = func or (lambda shape=None, **kw: nd.zeros(shape, **kw))
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _pack_params(self, F, kwargs):
        """The reference's flat vector: every weight, then every bias."""
        keys = self._keys()
        parts = [F.Reshape(kwargs[k], shape=(-1,))
                 for ks in keys for k in ks[:2]]
        parts += [kwargs[k] for ks in keys for k in ks[2:]]
        return F.Concat(*parts, dim=0) if len(parts) > 1 else parts[0]

    def _op_attrs(self):
        return dict(state_size=self._hidden_size, num_layers=self._num_layers,
                    bidirectional=self._dir == 2, p=self._dropout,
                    mode=self._mode, state_outputs=True)

    def hybrid_forward(self, F, x, *states, **params):
        if not states:
            raise MXNetError("RNN layer needs states: call with "
                             "begin_state() output, or call imperatively "
                             "for auto zero-states")
        if F is not nd:
            return self._symbol_forward(F, x, states, params)
        data = x._data
        if self._layout == "NTC":
            data = data.transpose(0, 1)
        weights = [tuple(params[k]._data for k in ks) for ks in self._keys()]
        train = autograd.is_training()
        rng = _random.generator(data.device) \
            if train and self._dropout > 0 else None
        with torch.set_grad_enabled(autograd.is_recording()):
            out, *rest = rnn_forward(
                data, weights, states[0]._data,
                states[1]._data if self._mode == "lstm" else None,
                mode=self._mode, bidirectional=self._dir == 2,
                p=self._dropout, rng=rng, is_train=train, state_outputs=True)
            if self._layout == "NTC":
                out = out.transpose(0, 1)
        return [NDArray(out)] + [NDArray(s) for s in rest]

    def _symbol_forward(self, F, x, states, params):
        if self._layout == "NTC":
            x = F.SwapAxis(x, dim1=0, dim2=1)
        flat = self._pack_params(F, params)
        if self._mode == "lstm":
            ret = F.RNN(x, flat, states[0], states[1], **self._op_attrs())
        else:
            ret = F.RNN(x, flat, states[0], **self._op_attrs())
        out, rest = ret[0], [ret[i] for i in range(1, len(ret))]
        if self._layout == "NTC":
            out = F.SwapAxis(out, dim1=0, dim2=1)
        return [out] + rest

    def __call__(self, x, *states):
        """``output`` when called without states (zero states are made),
        else ``(output, [new states])`` — the reference's contract."""
        explicit = bool(states)
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = tuple(states[0])
        if isinstance(x, NDArray):
            # the deferred input size comes from the data
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init(tuple(
                        x.shape[-1] if s == 0 else s for s in p.shape))
            if not states:
                batch = x.shape[self._layout.find("N")]
                states = tuple(self.begin_state(batch, ctx=x.context))
        ret = super().__call__(x, *states)
        out, rest = ret[0], list(ret[1:])
        return (out, rest) if explicit else out


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn_" + activation,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Fused multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Fused multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]

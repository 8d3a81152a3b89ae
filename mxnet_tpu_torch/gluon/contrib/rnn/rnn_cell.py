"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; reference
``gluon/contrib/rnn/rnn_cell.py``)."""
from __future__ import annotations

from .... import autograd
from .... import ndarray as nd
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(RecurrentCell):
    """Dropout around a base cell with one mask a sequence for the inputs,
    the first state and the outputs (Gal & Ghahramani 2016): each mask is
    drawn at its first training step after ``reset()`` (``unroll`` resets)
    and reused until the next reset. The masks draw from torch's
    generator."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0., prefix=None, params=None):
        super().__init__(prefix, params)
        self.base_cell = base_cell
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    @staticmethod
    def _mask(cached, like, rate):
        return nd.Dropout(nd.ones_like(like), p=rate) if cached is None \
            else cached

    def _cell_forward(self, x, states):
        training = autograd.is_training()
        if training and self.drop_inputs:
            self._input_mask = self._mask(self._input_mask, x,
                                          self.drop_inputs)
            x = x * self._input_mask
        if training and self.drop_states:
            self._state_mask = self._mask(self._state_mask, states[0],
                                          self.drop_states)
            states = [states[0] * self._state_mask] + list(states[1:])
        out, next_states = self.base_cell(x, states)
        if training and self.drop_outputs:
            self._output_mask = self._mask(self._output_mask, out,
                                           self.drop_outputs)
            out = out * self._output_mask
        return out, next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(p_in={self.drop_inputs}, "
                f"p_state={self.drop_states}, p_out={self.drop_outputs})")


class LSTMPCell(RecurrentCell):
    """LSTM whose recurrent state is a projection ``r = W_r·h`` of its
    hidden state (Sak et al. 2014): states ``[r (N, P), c (N, H)]``, gates
    ``[i, f, g, o]``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _cell_forward(self, x, states):
        h = self._hidden_size
        i2h = nd.FullyConnected(x, self.i2h_weight.data(),
                                self.i2h_bias.data(), num_hidden=4 * h)
        h2h = nd.FullyConnected(states[0], self.h2h_weight.data(),
                                self.h2h_bias.data(), num_hidden=4 * h)
        i, f, g, o = nd.split(i2h + h2h, 4, axis=1)
        c = nd.sigmoid(f) * states[1] + nd.sigmoid(i) * nd.tanh(g)
        hidden = nd.sigmoid(o) * nd.tanh(c)
        r = nd.FullyConnected(hidden, self.h2r_weight.data(), None,
                              num_hidden=self._projection_size, no_bias=True)
        return r, [r, c]

"""Recurrent cells, stepped one time step at a time.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
``python/mxnet/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell`` (gates
``[i, f, g, o]``), ``GRUCell`` (``[r, z, n]``), the ``SequentialRNNCell``
stack and the ``DropoutCell``, ``ZoneoutCell``, ``ResidualCell`` and
``BidirectionalCell`` modifiers, with ``unroll`` (``merge_outputs``, and
``valid_length`` through ``SequenceMask``). A cell runs on NDArrays, op
by op; the fused layers in ``rnn_layer.py`` are the fast path. Dropout and
zoneout draw from torch's generator, not from JAX's stream.
"""
from __future__ import annotations

from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _steps(inputs, length, layout):
    """(the length-``length`` list of (N, C) steps, the batch size)."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs), inputs[0].shape[0]
    axis = layout.find("T")
    batch = inputs.shape[layout.find("N")]
    if length == 1:
        return [nd.squeeze(inputs, axis=axis)], batch
    return [nd.squeeze(s, axis=axis)
            for s in nd.split(inputs, length, axis=axis)], batch


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        func = func or (lambda shape=None, **kw: nd.zeros(shape, **kw))
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times; ``(outputs, final states)``."""
        self.reset()
        axis = layout.find("T")
        seq, batch = _steps(inputs, length, layout)
        states = begin_state if begin_state is not None \
            else self.begin_state(batch, ctx=seq[0].context)
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if valid_length is not None:
            outputs = nd.SequenceMask(nd.stack(*outputs, axis=axis),
                                      valid_length, use_sequence_length=True,
                                      axis=axis)
            merge_outputs = True
        if merge_outputs and isinstance(outputs, list):
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, x, states):
        self._counter += 1
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init(tuple(x.shape[-1] if s == 0 else s
                                              for s in p.shape))
        return self._cell_forward(x, states)

    def _cell_forward(self, x, states):
        params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, states, **params)


class _GatedCell(RecurrentCell):
    """The three stepped cells: ``gates`` stacked projections of the input
    and of the state, each ``(gates·H, in)`` with its bias."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        ng = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _project(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """``h' = act(W_x·x + b_x + W_h·h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, x, states, **weights):
        i2h, h2h = self._project(F, x, states[0], **weights)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gate order ``[i, f, g, o]``."""

    _gates = 4

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def hybrid_forward(self, F, x, states, **weights):
        i2h, h2h = self._project(F, x, states[0], **weights)
        parts = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(parts[0])
        f = F.sigmoid(parts[1])
        g = F.Activation(parts[2], act_type="tanh")
        o = F.sigmoid(parts[3])
        c = f * states[1] + i * g
        out = o * F.Activation(c, act_type="tanh")
        return out, [out, c]


class GRUCell(_GatedCell):
    """Gate order ``[r, z, n]``; ``r`` multiplies ``W_hn·h + b_hn``."""

    _gates = 3

    def hybrid_forward(self, F, x, states, **weights):
        i2h, h2h = self._project(F, x, states[0], **weights)
        gi = F.SliceChannel(i2h, num_outputs=3, axis=1)
        gh = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(gi[0] + gh[0])
        z = F.sigmoid(gi[1] + gh[1])
        n = F.Activation(gi[2] + r * gh[2], act_type="tanh")
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def _cell_forward(self, x, states):
        next_states, p = [], 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, sub = cell(x, states[p:p + n])
            next_states.extend(sub)
            p += n
        return x, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class DropoutCell(RecurrentCell):
    """Dropout on the step's input; no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def _cell_forward(self, x, states):
        if self._rate > 0:
            x = nd.Dropout(x, p=self._rate, axes=self._axes)
        return x, states


class ZoneoutCell(RecurrentCell):
    """In training, each output and state entry keeps its previous value
    with probability ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self.base_cell = base_cell
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def reset(self):
        super().reset()
        self._prev_output = None

    def _cell_forward(self, x, states):
        from ... import autograd
        out, next_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zoneout_outputs > 0:
                mask = nd.Dropout(nd.ones_like(out), p=self._zoneout_outputs)
                prev = self._prev_output if self._prev_output is not None \
                    else nd.zeros_like(out)
                out = nd.where(mask, out, prev)
            if self._zoneout_states > 0:
                next_states = [
                    nd.where(nd.Dropout(nd.ones_like(new),
                                        p=self._zoneout_states), new, old)
                    for new, old in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(RecurrentCell):
    """Adds the step's input to the wrapped cell's output."""

    def __init__(self, base_cell, prefix=None, params=None):
        super().__init__(prefix, params)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def _cell_forward(self, x, states):
        out, next_states = self.base_cell(x, states)
        return out + x, next_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, their
    outputs joined on the feature axis; it only unrolls."""

    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix, params)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def __call__(self, x, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        seq, batch = _steps(inputs, length, layout)
        states = begin_state if begin_state is not None \
            else self.begin_state(batch, ctx=seq[0].context)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, seq, states[:nl],
                                             layout="NTC",
                                             merge_outputs=False)
        r_out, r_states = self.r_cell.unroll(length, list(reversed(seq)),
                                             states[nl:], layout="NTC",
                                             merge_outputs=False)
        outs = [nd.concat(lo, ro, dim=1)
                for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outs = nd.stack(*outs, axis=layout.find("T"))
        return outs, l_states + r_states

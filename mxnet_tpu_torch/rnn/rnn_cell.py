"""Symbolic RNN cells (the legacy ``mx.rnn`` API).

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
``python/mxnet/rnn/rnn_cell.py``): the same cell classes, unroll
semantics, parameter names and packed-weight layout, so checkpoints keyed
by ``{prefix}i2h_weight`` / ``{prefix}{dir}{layer}_i2h{gate}_weight``
interchange with the JAX package's and the reference's. Every gated
recurrence (vanilla, LSTM, GRU) is one recipe, :func:`_gate_step`: two
stacked ``FullyConnected`` projections, split by gate and combined; the
fused packed-vector layout is described once by :func:`_packed_layout` and
walked by both ``pack_weights`` and ``unpack_weights``. ``FusedRNNCell``
is one ``RNN`` op node (``ops/rnn.py``), whose executor slices its packed
parameter into views. ``begin_state`` emits zeros with a batch of 1 that
broadcasts against the first step, as the JAX package's cells do.
"""
from __future__ import annotations

from .. import symbol
from ..symbol import Symbol
from ..base import MXNetError
from ..ops.rnn import rnn_packed_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]

# gate suffixes per mode, in the packed layout's order
_GATES = {"rnn_relu": ("",), "rnn_tanh": ("",),
          "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}


# ------------------------------------------------------------ sequence forms
def _time_axis(layout):
    ax = layout.find("T")
    if ax < 0:
        raise MXNetError(f"layout {layout!r} has no time axis")
    return ax


def _split_merged_ndarray(inputs, length, layout):
    """A merged (N,T,C)/(T,N,C) NDArray → length-T list of (N, C) arrays
    (the reference's unroll accepts the merged imperative form too)."""
    from .._imperative import invoke
    ax = _time_axis(layout)
    if length is not None and inputs.shape[ax] != length:
        raise MXNetError(f"time axis has {inputs.shape[ax]} steps, "
                         f"expected {length}")
    return [invoke("squeeze", [invoke(
        "slice_axis", [inputs],
        {"axis": ax, "begin": t, "end": t + 1})], {"axis": ax})
        for t in range(inputs.shape[ax])]


def _to_steps(inputs, length, layout):
    """Whatever form ``inputs`` is in → a length-T list of (N, C) Symbols."""
    if isinstance(inputs, Symbol):
        if len(inputs.list_outputs()) != 1:
            raise MXNetError("unroll needs a single-output symbol as input")
        return list(symbol.SliceChannel(
            inputs, axis=_time_axis(layout), num_outputs=length,
            squeeze_axis=1))
    if hasattr(inputs, "ndim") and getattr(inputs, "ndim", 0) == 3:
        return _split_merged_ndarray(inputs, length, layout)
    steps = list(inputs)
    if length is not None and len(steps) != length:
        raise MXNetError(f"got {len(steps)} step inputs, expected {length}")
    return steps


def _to_merged(inputs, length, layout):
    """Whatever form ``inputs`` is in → one (N,T,C)/(T,N,C) Symbol."""
    if isinstance(inputs, Symbol):
        return inputs
    if hasattr(inputs, "ndim") and getattr(inputs, "ndim", 0) == 3:
        return inputs
    steps = list(inputs)
    if length is not None and len(steps) != length:
        raise MXNetError(f"got {len(steps)} step inputs, expected {length}")
    ax = _time_axis(layout)
    expanded = [symbol.expand_dims(s, axis=ax) for s in steps]
    return symbol.Concat(*expanded, dim=ax)


def _shape_outputs(outputs, length, layout, merge):
    """Present per-step outputs in the caller-requested form: True → merged
    Symbol, False → step list, None → leave as produced."""
    if merge is True:
        return _to_merged(outputs, length, layout)
    if merge is False:
        return _to_steps(outputs, length, layout)
    return outputs


# -------------------------------------------------------------- shared math
def _gate_step(mode, num_hidden, proj_i, proj_h, states, name,
               activation="tanh", get_act=None):
    """One recurrence step given the two stacked projections.

    ``proj_i``/``proj_h`` are the FullyConnected outputs of shape
    (N, num_gates*H) in the gate order of ``_GATES[mode]``.
    Returns (output, new_states).
    """
    if mode in ("rnn_relu", "rnn_tanh"):
        act = activation if get_act else mode.split("_")[1]
        out = get_act(proj_i + proj_h, act, name=name + "out") if get_act \
            else symbol.Activation(proj_i + proj_h, act_type=act)
        return out, [out]

    if mode == "lstm":
        parts = list(symbol.SliceChannel(proj_i + proj_h, num_outputs=4,
                                         name=name + "slice"))
        sig = lambda s, g: symbol.Activation(s, act_type="sigmoid",
                                             name=name + g)
        write = sig(parts[0], "i") * symbol.Activation(
            parts[2], act_type="tanh", name=name + "c")
        c_next = sig(parts[1], "f") * states[1] + write
        h_next = sig(parts[3], "o") * symbol.Activation(c_next,
                                                        act_type="tanh")
        return h_next, [h_next, c_next]

    if mode == "gru":
        gi = list(symbol.SliceChannel(proj_i, num_outputs=3,
                                      name=name + "i2h_slice"))
        gh = list(symbol.SliceChannel(proj_h, num_outputs=3,
                                      name=name + "h2h_slice"))
        reset = symbol.Activation(gi[0] + gh[0], act_type="sigmoid",
                                  name=name + "r_act")
        update = symbol.Activation(gi[1] + gh[1], act_type="sigmoid",
                                   name=name + "z_act")
        cand = symbol.Activation(gi[2] + reset * gh[2], act_type="tanh",
                                 name=name + "h_act")
        h_next = update * states[0] + (1.0 - update) * cand
        return h_next, [h_next]

    raise MXNetError(f"unknown cell mode {mode!r}")


class RNNParams(object):
    """Shared variable pool: ``get`` returns the same Variable for the same
    full name, so cells constructed on one RNNParams share weights
    (reference rnn_cell.py:78)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


class BaseRNNCell(object):
    """Abstract symbolic cell: step with ``__call__``, loop with ``unroll``."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._prefix = prefix
        self._params = RNNParams(prefix) if params is None else params
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the per-unroll step counters."""
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        """One step: (step_input, states) -> (step_output, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """List of dicts describing each state's shape/layout."""
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial states. With the default func the batch dim is emitted as
        1 and broadcasts against the data (the JAX package's rule, for the
        reference's 0 == unknown batch)."""
        if self._modified:
            raise MXNetError("cell is wrapped by a modifier; ask the "
                             "modifier for begin_state instead")
        kwargs = {k: v for k, v in kwargs.items() if k != "name"}
        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(func(
                name=f"{self._prefix}begin_state_{self._init_counter}",
                shape=tuple(d or 1 for d in info["shape"]), **kwargs))
        return states

    # ---- packed (stacked-gate) <-> per-gate weight dict conversion -------
    def _gate_slices(self, group):
        """(full_param_name per gate) for the stacked i2h/h2h weight+bias."""
        return [(f"{self._prefix}{group}{g}_weight",
                 f"{self._prefix}{group}{g}_bias")
                for g in self._gate_names]

    def unpack_weights(self, args):
        """Split stacked i2h/h2h weights into per-gate arrays."""
        if not self._gate_names:
            return args.copy()
        out = args.copy()
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            w = out.pop(f"{self._prefix}{group}_weight")
            b = out.pop(f"{self._prefix}{group}_bias")
            for j, (wname, bname) in enumerate(self._gate_slices(group)):
                out[wname] = w[j * h:(j + 1) * h].copy()
                out[bname] = b[j * h:(j + 1) * h].copy()
        return out

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        if not self._gate_names:
            return args.copy()
        from ..ndarray import concat
        out = args.copy()
        for group in ("i2h", "h2h"):
            ws, bs = [], []
            for wname, bname in self._gate_slices(group):
                ws.append(out.pop(wname))
                bs.append(out.pop(bname))
            out[f"{self._prefix}{group}_weight"] = concat(*ws, dim=0)
            out[f"{self._prefix}{group}_bias"] = concat(*bs, dim=0)
        return out

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll ``length`` steps; returns (outputs, final_states)."""
        self.reset()
        steps = _to_steps(inputs, length, layout)
        states = begin_state if begin_state is not None else self.begin_state()
        outputs = []
        for x in steps:
            y, states = self(x, states)
            outputs.append(y)
        return _shape_outputs(outputs, length, layout, merge_outputs), states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class _GateCell(BaseRNNCell):
    """Shared implementation of the three stepped gated cells: two stacked
    FullyConnected projections + the :func:`_gate_step` recipe."""

    _mode = None  # set by subclasses

    def __init__(self, num_hidden, prefix, params, i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        get = self.params.get
        self._weights = {
            "i2h": (get("i2h_weight"),
                    get("i2h_bias", **({"init": i2h_bias_init}
                                       if i2h_bias_init else {}))),
            "h2h": (get("h2h_weight"), get("h2h_bias")),
        }

    @property
    def _gate_names(self):
        return tuple(_GATES[self._mode])

    @property
    def state_info(self):
        slots = 2 if self._mode == "lstm" else 1
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}
                for _ in range(slots)]

    def _project(self, data, group, name):
        w, b = self._weights[group]
        return symbol.FullyConnected(
            data=data, weight=w, bias=b,
            num_hidden=self._num_hidden * len(self._gate_names),
            name=name + group)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        proj_i = self._project(inputs, "i2h", name)
        proj_h = self._project(states[0], "h2h", name)
        return _gate_step(self._mode, self._num_hidden, proj_i, proj_h,
                          states, name,
                          activation=getattr(self, "_activation", None),
                          get_act=(self._get_activation
                                   if self._mode.startswith("rnn") else None))


class RNNCell(_GateCell):
    """Vanilla RNN: h' = act(W_x x + W_h h + b)."""

    _mode = "rnn_tanh"

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(num_hidden, prefix, params)
        self._activation = activation


class LSTMCell(_GateCell):
    """LSTM; gate order [i, f, c, o] matches the reference packed layout
    (reference rnn_cell.py:408)."""

    _mode = "lstm"

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(num_hidden, prefix, params,
                         i2h_bias_init=LSTMBiasInit(forget_bias))


class GRUCell(_GateCell):
    """GRU; gate order [r, z, o] (reference rnn_cell.py:469)."""

    _mode = "gru"

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(num_hidden, prefix, params)


# ------------------------------------------------------------------- fused
def _packed_layout(mode, num_layers, directions, input_size, hidden):
    """Yield (param_name_parts, shape) over the fused packed vector, in wire
    order: all weights layer-major (i2h gates then h2h gates per direction),
    then all biases in the same order (reference rnn-inl.h packed layout)."""
    gates = _GATES[mode]
    b = len(directions)
    for kind in ("weight", "bias"):
        for layer in range(num_layers):
            for d in directions:
                for group in ("i2h", "h2h"):
                    if kind == "bias":
                        shape = (hidden,)
                    elif group == "h2h":
                        shape = (hidden, hidden)
                    else:
                        in_dim = input_size if layer == 0 else hidden * b
                        shape = (hidden, in_dim)
                    for g in gates:
                        yield (d, layer, group, g, kind), shape


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN backed by the ``RNN`` op: one packed parameter
    vector, one input projection and the stepped recurrence
    (``ops/rnn.py``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix=f"{mode}_" if prefix is None else prefix,
                         params=params)
        self._num_hidden, self._num_layers, self._mode = \
            num_hidden, num_layers, mode
        self._bidirectional, self._dropout = bidirectional, dropout
        self._get_next_state, self._forget_bias = get_next_state, forget_bias
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        layers = len(self._directions) * self._num_layers
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": (layers, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n_states)]

    @property
    def _gate_names(self):
        return _GATES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _infer_input_size(self, total):
        """Invert rnn_packed_param_size for the input dim (monotone in li)."""
        size_of = lambda li: rnn_packed_param_size(
            self._mode, self._num_layers, self._bidirectional, li,
            self._num_hidden)
        li = 0
        while size_of(li) < total:
            li += 1
        if size_of(li) != total:
            raise MXNetError(
                f"packed vector of {total} elements matches no input size "
                f"for mode={self._mode} layers={self._num_layers}")
        return li

    def _param_name(self, key):
        d, layer, group, gate, kind = key
        return f"{self._prefix}{d}{layer}_{group}{gate}_{kind}"

    def unpack_weights(self, args):
        out = args.copy()
        packed = out.pop(self._parameter.name)
        li = self._infer_input_size(packed.size)
        pos = 0
        for key, shape in _packed_layout(self._mode, self._num_layers,
                                         self._directions, li,
                                         self._num_hidden):
            n = 1
            for d in shape:
                n *= d
            out[self._param_name(key)] = packed[pos:pos + n].reshape(shape).copy()
            pos += n
        if pos != packed.size:
            raise MXNetError("packed parameter vector has trailing elements")
        return out

    def pack_weights(self, args):
        from ..ndarray import concat
        out = args.copy()
        pieces = [out.pop(self._param_name(key)).reshape((-1,))
                  for key, _ in _packed_layout(
                      self._mode, self._num_layers, self._directions,
                      None, self._num_hidden)
                  ]
        out[self._parameter.name] = concat(*pieces, dim=0)
        return out

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        seq = _to_merged(inputs, length, layout)
        if _time_axis(layout) != 0:
            seq = symbol.swapaxes(seq, dim1=0, dim2=1)  # RNN op wants TNC

        init = begin_state if begin_state is not None else self.begin_state()
        state_kwargs = {"state": init[0]}
        if self._mode == "lstm":
            state_kwargs["state_cell"] = init[1]

        rnn = symbol.RNN(data=seq, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode,
                         name=self._prefix + "rnn", **state_kwargs)

        if self._get_next_state:
            outputs = rnn[0]
            states = [rnn[1], rnn[2]] if self._mode == "lstm" else [rnn[1]]
        else:
            outputs, states = rnn, []

        if _time_axis(layout) != 0:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        return _shape_outputs(outputs, length, layout, merge_outputs), states

    def unfuse(self):
        """Equivalent unfused SequentialRNNCell (reference rnn_cell.py:714)."""
        def make(cell_prefix):
            if self._mode == "lstm":
                return LSTMCell(self._num_hidden, prefix=cell_prefix,
                                forget_bias=self._forget_bias)
            if self._mode == "gru":
                return GRUCell(self._num_hidden, prefix=cell_prefix)
            return RNNCell(self._num_hidden,
                           activation=self._mode.split("_")[1],
                           prefix=cell_prefix)

        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(f"{self._prefix}l{i}_"),
                    make(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(make(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


# -------------------------------------------------------------- containers
def _adopt_params(parent, *cells):
    """Merge child cells' variable pools into the parent's shared pool."""
    for cell in cells:
        parent.params._params.update(cell.params._params)


def _split_states(states, cells):
    """Partition a flat state list back into per-cell chunks."""
    chunks, pos = [], 0
    for cell in cells:
        n = len(cell.state_info)
        chunks.append(states[pos:pos + n])
        pos += n
    return chunks


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            if not cell._own_params:
                raise MXNetError("specify params on SequentialRNNCell or on "
                                 "child cells, not both")
            cell.params._params.update(self.params._params)
        _adopt_params(self, cell)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for cell, chunk in zip(self._cells, _split_states(states, self._cells)):
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("BidirectionalCell cannot be stepped "
                                 "inside a SequentialRNNCell")
            inputs, new = cell(inputs, chunk)
            next_states.extend(new)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        init = self.begin_state() if begin_state is None else begin_state
        chunks = _split_states(init, self._cells)
        final_states = []
        last = len(self._cells) - 1
        for i, (cell, chunk) in enumerate(zip(self._cells, chunks)):
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            final_states.extend(states)
        return inputs, final_states


class DropoutCell(BaseRNNCell):
    """Applies dropout to the input; stateless."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = float(dropout)

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if merge_outputs is True or (merge_outputs is None
                                     and isinstance(inputs, Symbol)):
            # dropout is elementwise: one Dropout node on the merged sequence
            out, _ = self(_to_merged(inputs, length, layout), [])
            return out, []
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Base for cells that decorate another cell (Zoneout/Residual); params
    belong to the wrapped cell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly hold the previous output/state instead of the new
    one (Krueger et al. 2017)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, FusedRNNCell):
            raise MXNetError("unfuse() the cell before applying zoneout")
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("BidirectionalCell cannot be zoned out "
                             "(it cannot be stepped)")
        super().__init__(base_cell)
        self.zoneout_outputs, self.zoneout_states = \
            zoneout_outputs, zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    @staticmethod
    def _keep_mask(p, like):
        # Dropout of ones == a 0/1 keep mask scaled by 1/(1-p); where() only
        # cares about zero vs nonzero, so the scale is harmless
        return symbol.Dropout(symbol.ones_like(like), p=p)

    def __call__(self, inputs, states):
        new_out, new_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0.:
            held = self.prev_output if self.prev_output is not None \
                else symbol.zeros_like(new_out)
            new_out = symbol.where(
                self._keep_mask(self.zoneout_outputs, new_out), new_out, held)
        if self.zoneout_states > 0.:
            new_states = [
                symbol.where(self._keep_mask(self.zoneout_states, ns), ns, os)
                for ns, os in zip(new_states, states)]
        self.prev_output = new_out
        return new_out, new_states


class ResidualCell(ModifierCell):
    """Adds the step input to the wrapped cell's output."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state, layout=layout,
                merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = isinstance(outputs, Symbol)
        if merge_outputs:
            outputs = outputs + _to_merged(inputs, length, layout)
        else:
            outputs = [o + x for o, x in
                       zip(outputs, _to_steps(inputs, length, layout))]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs one cell forward and one backward over the sequence and
    concatenates per-step outputs on the feature axis."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            if not (l_cell._own_params and r_cell._own_params):
                raise MXNetError("specify params on BidirectionalCell or on "
                                 "child cells, not both")
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        _adopt_params(self, l_cell, r_cell)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        init = self.begin_state() if begin_state is None else begin_state
        fwd, bwd = self._cells
        fwd_chunk, bwd_chunk = _split_states(init, self._cells)
        t_ax = _time_axis(layout)

        # keep the input in its native form: a merged Symbol reverses with
        # ONE reverse node (fused children then stay O(1) in graph size),
        # a step list reverses as a list
        if isinstance(inputs, Symbol):
            bwd_in = symbol.reverse(inputs, axis=t_ax)
        else:
            bwd_in = list(reversed(list(inputs)))

        # each direction unrolls in its natural/requested form; with
        # merge_outputs=None the children's output form decides the result
        # form (stepped cells yield lists, fused cells yield one Symbol)
        fwd_out, fwd_states = fwd.unroll(length, inputs,
                                         begin_state=fwd_chunk, layout=layout,
                                         merge_outputs=merge_outputs)
        bwd_out, bwd_states = bwd.unroll(length, bwd_in,
                                         begin_state=bwd_chunk, layout=layout,
                                         merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = (isinstance(fwd_out, Symbol)
                             and isinstance(bwd_out, Symbol))
        if merge_outputs:
            # O(1) graph nodes: reverse the backward stream on the time axis
            # and join the feature axes
            bwd_rev = symbol.reverse(_to_merged(bwd_out, length, layout),
                                     axis=t_ax)
            outputs = symbol.Concat(_to_merged(fwd_out, length, layout),
                                    bwd_rev, dim=2,
                                    name=f"{self._output_prefix}out")
        else:
            outputs = [
                symbol.Concat(f, b, dim=1, name=f"{self._output_prefix}t{t}")
                for t, (f, b) in enumerate(
                    zip(_to_steps(fwd_out, length, layout),
                        reversed(_to_steps(bwd_out, length, layout))))]
        return outputs, fwd_states + bwd_states


def LSTMBiasInit(forget_bias):
    """Initializer spec for the stacked LSTM i2h bias (forget gate filled
    with ``forget_bias``); resolved lazily to avoid an import cycle."""
    from ..initializer import LSTMBias
    return LSTMBias(forget_bias=forget_bias)

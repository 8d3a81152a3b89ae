"""Gluon recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,  # noqa: F401
                       SequentialRNNCell, DropoutCell, ZoneoutCell,
                       ResidualCell, BidirectionalCell)

"""``mx.rnn`` — the legacy symbolic RNN cell API.

Counterpart of ``mxnet_tpu/rnn`` (reference ``python/mxnet/rnn/``): the
symbolic cells, ``BucketSentenceIter`` and the checkpoint helpers. The
gluon cells are ``mxnet_tpu_torch.gluon.rnn``.
"""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ZoneoutCell, ResidualCell)
from .io import encode_sentences, BucketSentenceIter
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint)

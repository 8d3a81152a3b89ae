"""RNN checkpoint helpers (the legacy ``mx.rnn`` API).

Counterpart of ``mxnet_tpu/rnn/rnn.py`` (reference ``python/mxnet/rnn/rnn.py``):
checkpoints store unfused (per-gate) weights, so that a model trained with
``FusedRNNCell`` reloads into unfused cells and the reverse; the files are
``model.save_checkpoint``'s, which either package reads.
"""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint
from .rnn_cell import BaseRNNCell


def _as_list(cells):
    if isinstance(cells, BaseRNNCell):
        return [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save a checkpoint, unpacking fused RNN weights first."""
    cells = _as_list(cells)
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint, packing weights back for the given cells."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    cells = _as_list(cells)
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback that checkpoints with unpacked RNN weights."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback

"""Checkpoints: ``save_checkpoint``, ``load_params``, ``load_checkpoint``.

Counterpart of the same functions in ``mxnet_tpu/model.py`` (reference
``python/mxnet/model.py:388-418``): ``prefix-symbol.json`` (the JAX
package's graph JSON) and ``prefix-%04d.params`` (the ``MXTPU001``
container with ``arg:``/``aux:`` keys). A checkpoint written by either
package loads in the other. Loaded arrays stay on the host (``cpu()``), as
the reference's do, so a model's weights are not held twice on the card;
``Module.init_params`` copies them over. The ``FeedForward`` facade waits
for a later slice.
"""
from __future__ import annotations

from typing import Dict

from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, load as nd_load, save as nd_save

__all__ = ["save_checkpoint", "load_params", "load_checkpoint"]


def save_checkpoint(prefix: str, epoch: int, symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray],
                    remove_amp_cast: bool = True) -> None:
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix: str, epoch: int):
    """(arg_params, aux_params) of ``prefix-%04d.params``, on the host."""
    fname = f"{prefix}-{epoch:04d}.params"
    loaded = nd_load(fname, ctx=cpu())
    if not isinstance(loaded, dict):
        raise MXNetError(f"{fname}: holds a list of arrays, not named "
                         f"parameters")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int):
    """(symbol, arg_params, aux_params) of a checkpoint."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params

"""Checkpoints (``save_checkpoint``, ``load_params``, ``load_checkpoint``)
and the legacy ``FeedForward`` facade.

Counterpart of ``mxnet_tpu/model.py`` (reference
``python/mxnet/model.py``: the checkpoint functions :388-418,
``FeedForward`` :419+): ``prefix-symbol.json`` (the JAX package's graph
JSON) and ``prefix-%04d.params`` (the ``MXTPU001`` container with
``arg:``/``aux:`` keys). A checkpoint written by either package loads in
the other, and ``load_checkpoint`` reads the reference's own pair too (its
graph JSON and its ``.params`` file). Loaded arrays stay on the host
(``cpu()``), as the reference's do, so a model's weights are not held
twice on the card; ``Module.init_params`` copies them over.
``FeedForward`` is a thin adapter over ``Module``, as the reference's is
since ``Module`` came.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu
from .module.base_module import BatchEndParam  # re-exported (JAX parity)
from .ndarray import NDArray, load as nd_load, save as nd_save

__all__ = ["save_checkpoint", "load_params", "load_checkpoint",
           "BatchEndParam", "FeedForward", "create"]


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


class FeedForward:
    """The legacy training facade (reference ``model.py:FeedForward``):
    ``fit``/``predict``/``score``/``save``/``load`` over a ``Module`` on
    ``ctx`` (the current context by default). Keyword arguments it does
    not name go to the optimizer."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 begin_epoch=0, **kwargs):
        from . import context as ctx_mod
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else ctx_mod.current_context()
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._opt_kwargs = dict(kwargs)
        self._module = None

    def _label_name(self) -> str:
        name = self.symbol.list_outputs()[0]
        base = name[:-len("_output")] if name.endswith("_output") else name
        return f"{base}_label"

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None):
        from . import io as io_mod
        from . import module as mod_mod
        data = X if isinstance(X, io_mod.DataIter) else io_mod.NDArrayIter(
            np.asarray(X), np.asarray(y), batch_size=min(128, len(X)),
            label_name=self._label_name())
        label_names = [d.name for d in (data.provide_label or [])] or None
        self._module = mod_mod.Module(
            self.symbol, context=self.ctx,
            data_names=[d.name for d in data.provide_data],
            label_names=label_names)
        if self.num_epoch is None:
            raise MXNetError("FeedForward.fit requires num_epoch")
        self._module.fit(
            data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=self._opt_kwargs or
            (("learning_rate", 0.01),), initializer=self.initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None) -> np.ndarray:
        """The first output over ``X`` (a ``DataIter`` or an array) as a
        numpy array. The output layer's ``*_label`` arguments are bound
        with ``(batch,)`` placeholders, so that shape inference closes."""
        from . import io as io_mod
        from . import module as mod_mod
        data = X if isinstance(X, io_mod.DataIter) else io_mod.NDArrayIter(
            np.asarray(X), batch_size=min(128, len(X)))
        if self._module is None:
            label_args = [n for n in self.symbol.list_arguments()
                          if n.endswith("_label")]
            batch = data.provide_data[0].shape[0]
            mod = mod_mod.Module(
                self.symbol, context=self.ctx,
                data_names=[d.name for d in data.provide_data],
                label_names=label_args or None)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=[(n, (batch,)) for n in label_args]
                     or None, for_training=False)
            mod.set_params(self.arg_params, self.aux_params or {})
            self._module = mod
        outs = self._module.predict(data, num_batch=num_batch)
        first = outs[0] if isinstance(outs, list) else outs
        return first.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None):
        res = self._module.score(X, eval_metric, num_batch=num_batch)
        return dict(res).popitem()[1]

    def save(self, prefix, epoch=None) -> None:
        epoch = epoch if epoch is not None else (self.num_epoch or 0)
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs) -> "FeedForward":
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)


def create(symbol, X, y=None, ctx=None, num_epoch=None,
           **kwargs) -> FeedForward:
    """A ``FeedForward`` fitted on ``X`` (reference
    ``FeedForward.create``)."""
    model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
    model.fit(X, y)
    return model


FeedForward.create = staticmethod(create)

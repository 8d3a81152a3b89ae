"""Weights from outside the framework.

Counterpart of the weight-carrying part of ``mxnet_tpu/interop.py``:
:func:`params_from_numpy` for the predictor and the server,
:func:`module_params_from_numpy` for ``Module.init_params`` /
``set_params`` (a ``FusedRNNCell``'s packed vector among them, under its
name), and :func:`load_block_params` /
:func:`block_params_to_numpy` to carry a gluon net's weights across, both
ways, between the JAX package's net and the port's (the two
``collect_params()`` name the same parameters alike; a ``SymbolBlock``'s
names are its graph's; a ``gluon.rnn`` layer's or cell's per-layer names
are the JAX package's). The
reference's ``.params`` and graph-JSON readers and writers wait for the
interop slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .base import MXNetError
from .ndarray.ndarray import NDArray, array

__all__ = ["params_from_numpy", "module_params_from_numpy",
           "load_block_params", "block_params_to_numpy",
           "load_reference_params", "save_reference_params",
           "load_reference_checkpoint"]


def _reference_format(what: str):
    raise MXNetError(f"{what}: the reference's .params and graph-JSON "
                     f"formats wait for the interop slice (ROADMAP A6)")


def load_reference_params(fname: str):
    """A reference-format ``.params`` file: ROADMAP A6, not yet ported."""
    _reference_format("load_reference_params")


def save_reference_params(fname: str, params) -> None:
    _reference_format("save_reference_params")


def load_reference_checkpoint(prefix: str, epoch: int):
    _reference_format("load_reference_checkpoint")


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      ctx) -> Dict[str, NDArray]:
    """numpy arrays -> NDArrays on ``ctx``, keys unchanged: ``arg:``/
    ``aux:`` prefixes are kept, so the result can stand where a ``.params``
    file's bytes would (e.g. ``ModelConfig(param_bytes=...)``)."""
    return {str(k): array(np.asarray(v), ctx=ctx) for k, v in arrays.items()}


def module_params_from_numpy(arrays: Dict[str, np.ndarray], ctx):
    """(arg_params, aux_params) of NDArrays on ``ctx`` from numpy arrays
    keyed as a checkpoint keys them (``arg:name``, ``aux:name``): what
    ``model.load_checkpoint`` of the same values would give."""
    out = ({}, {})
    for k, v in arrays.items():
        tp, _, name = str(k).partition(":")
        if tp not in ("arg", "aux") or not name:
            raise MXNetError(f"module_params_from_numpy: key {k!r} is not "
                             f"'arg:name' or 'aux:name'")
        out[tp == "aux"][name] = array(np.asarray(v), ctx=ctx)
    return out


def load_block_params(net, arrays: Dict[str, np.ndarray]) -> None:
    """Set every parameter of ``net`` from ``arrays``, keyed by the full
    parameter name (as ``collect_params()`` of the JAX package's twin net
    gives them); the key sets must be equal."""
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"load_block_params: names differ; missing "
                         f"{missing[:5]}, extra {extra[:5]}")
    for name, p in params.items():
        p.set_data(np.asarray(arrays[name]))


def block_params_to_numpy(net) -> Dict[str, np.ndarray]:
    """{full parameter name: numpy array} of ``net``'s current values."""
    return {name: p.data().asnumpy()
            for name, p in net.collect_params().items()}

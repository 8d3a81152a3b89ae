"""The Predictor: one bound inference executor with fixed input shapes.

Counterpart of ``Predictor`` and ``_load_param_bytes`` in
``mxnet_tpu/native/predict_bridge.py`` (reference
``src/c_api/c_predict_api.cc``: load graph -> bind with static input
shapes -> set input / forward / get output). The C ABI over it waits for a
later slice; the serving stack drives :meth:`Predictor.predict` directly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from ..context import Context
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray

__all__ = ["Predictor"]

Params = Union[bytes, Mapping[str, NDArray]]


def _load_param_bytes(param_bytes: Params, ctx: Context):
    """-> (arg_params, aux_params) on ``ctx``, from the bytes of an
    ``MXTPU001`` file or of the reference's ``.params`` file, or from an
    already-loaded dict (e.g.
    :func:`~mxnet_tpu_torch.interop.params_from_numpy`). Keys carry
    ``arg:``/``aux:`` prefixes or are bare argument names; an unnamed
    list's arrays are ``ndarray_{i}``, as the JAX bridge names them."""
    arg, aux = {}, {}
    if not param_bytes:
        return arg, aux
    if isinstance(param_bytes, Mapping):
        loaded = {k: v.as_in_context(ctx) for k, v in param_bytes.items()}
    else:
        loaded = nd_utils.load_frombuffer(param_bytes, ctx=ctx)
        if isinstance(loaded, list):
            loaded = {f"ndarray_{i}": v for i, v in enumerate(loaded)}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg[k[4:]] = v
        elif k.startswith("aux:"):
            aux[k[4:]] = v
        else:
            arg[k] = v
    return arg, aux


class Predictor:
    """One bound inference executor with fixed input shapes.

    Every entry point takes a per-handle lock; :meth:`predict` runs the
    whole set-inputs -> forward -> read-outputs sequence under one hold.
    ``reshape`` clones share the parameter arrays (loaded and placed once)
    but carry their own executor and lock (handle-per-worker).
    ``dev_type`` 1 is the CPU, anything else the GPU ``dev_id``.
    """

    def __init__(self, symbol_json: str, param_bytes: Params,
                 dev_type: int, dev_id: int,
                 input_shapes: Dict[str, Sequence[int]],
                 output_keys: Optional[List[str]] = None):
        from .. import symbol as sym_mod
        sym = sym_mod.load_json(symbol_json)
        if output_keys:
            internals = sym.get_internals()
            avail = internals.list_outputs()
            chosen = []
            for key in output_keys:
                name = key if key in avail else key + "_output"
                if name not in avail:
                    raise ValueError(f"output {key!r} not found in graph")
                chosen.append(internals[name])
            sym = sym_mod.Group(chosen) if len(chosen) > 1 else chosen[0]
        self._sym = sym
        self._ctx = Context("cpu" if dev_type == 1 else "gpu", dev_id)
        self._ctx.torch_device()      # no card: raise now, not per request
        arg_params, aux_params = _load_param_bytes(param_bytes, self._ctx)
        self._input_names = list(input_shapes)
        args = {}
        for name in sym.list_arguments():
            if name in input_shapes:
                args[name] = nd_utils.zeros(
                    tuple(int(x) for x in input_shapes[name]), ctx=self._ctx)
            elif name in arg_params:
                args[name] = arg_params[name]
        missing = [n for n in sym.list_arguments() if n not in args]
        if missing:
            raise ValueError(f"missing parameters for arguments: {missing}")
        self._aux = {n: aux_params[n] for n in sym.list_auxiliary_states()
                     if n in aux_params}
        self._args = args
        self._exec = sym.bind(self._ctx, args, grad_req="null",
                              aux_states=self._aux if self._aux else None)
        self._lock = threading.RLock()

    def predict(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Atomic set-inputs -> forward -> read-outputs under one lock
        hold; returns every output as a float32 numpy array. The serving
        worker's entry point."""
        with self._lock:
            for name, arr in inputs.items():
                if name not in self._args:
                    raise ValueError(f"unknown input {name!r}")
                a = np.ascontiguousarray(arr, dtype=np.float32)
                bound = tuple(self._args[name].shape)
                if tuple(a.shape) != bound:
                    raise ValueError(
                        f"input {name!r}: shape {tuple(a.shape)} does not "
                        f"match bound shape {bound}")
                self._args[name]._set_data(a)
            return [np.asarray(o.asnumpy(), dtype=np.float32)
                    for o in self._exec.forward(is_train=False)]

    def reshape(self, new_shapes: Dict[str, Sequence[int]]) -> "Predictor":
        """A clone bound at new input shapes, sharing the parameters."""
        with self._lock:
            shapes = {n: tuple(self._args[n].shape)
                      for n in self._input_names}
            shapes.update({k: tuple(int(x) for x in v)
                           for k, v in new_shapes.items()})
            clone = object.__new__(Predictor)
            clone.__dict__.update(self.__dict__)
            args = dict(self._args)
            for n, s in shapes.items():
                args[n] = nd_utils.zeros(s, ctx=self._ctx)
            clone._args = args
            clone._exec = self._sym.bind(
                self._ctx, args, grad_req="null",
                aux_states=self._aux if self._aux else None)
            clone._input_names = list(self._input_names)
            clone._lock = threading.RLock()
            return clone

"""DataParallelTrainer: a gluon net's whole training step on one card.

Counterpart of the core of ``mxnet_tpu/parallel/data_parallel.py``
(``:193-1186``). The JAX package captures the net and its loss through the
same Symbol trace ``hybridize()`` uses and jits forward, backward, the
gradient all-reduce and optax's update into one XLA program over a device
mesh. The port captures the same graph and runs it through the executor's
interpreter under torch autograd: the loss is ``mean(float32
outputs[0])``, its gradients come from ``torch.autograd.grad``, optax's
rule (:mod:`.fused_rules`) updates the trainer's own copy of the weights
in place, and the moving statistics take the graph's aux updates. The
net's parameters are left alone until :meth:`DataParallelTrainer.sync_to_net`.

One card per process in this slice (``mesh=None`` is ``gpu(0)``, where the
JAX package spans every local device). The other knobs raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError
from ..executor import _GraphLowering
from ..ndarray.ndarray import NDArray
from .fused_rules import FusedRule
from .mesh import Mesh, local_mesh

__all__ = ["DataParallelTrainer"]

# knob -> the ROADMAP item it waits for
_UNPORTED = {
    "compute_dtype": "A1 (the DataParallelTrainer knobs: mixed precision)",
    "remat": "A1 (the DataParallelTrainer knobs: rematerialisation)",
    "grad_guard": "A9 (resilience: the grad-anomaly guard)",
    "loss_scaling": "A9 (resilience: loss scaling)",
    "dynamic_lr_scale": "A9 (resilience: the lr backoff)",
    "step_attribution": "A9 (observability)",
    "kvstore": "A1 (the NCCL multi-card DataParallelTrainer)",
    "grad_reduce_dtype": "A1 (the NCCL multi-card DataParallelTrainer)",
    "bucket_bytes": "A1 (the NCCL multi-card DataParallelTrainer)",
    "compression": "A8 (gradient compression)",
}


class DataParallelTrainer:
    """Whole-step trainer for a gluon net::

        trainer = parallel.DataParallelTrainer(net, loss_fn, "sgd",
                                               {"learning_rate": 0.1})
        loss = trainer.step(x, y)     # an NDArray; float() syncs
        trainer.sync_to_net()         # write the weights back
    """

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None,
                 mesh: Optional[Mesh] = None, data_axis: str = "dp",
                 compute_dtype=None, donate: bool = True, kvstore=None,
                 remat=None, grad_guard=None, loss_scaling=None,
                 dynamic_lr_scale: bool = False, step_attribution=None,
                 passes=None, grad_reduce: str = "all_reduce",
                 grad_reduce_dtype=None, bucket_bytes=None,
                 compression=None):
        given = dict(compute_dtype=compute_dtype, remat=remat,
                     grad_guard=grad_guard, loss_scaling=loss_scaling,
                     dynamic_lr_scale=dynamic_lr_scale,
                     step_attribution=step_attribution, kvstore=kvstore,
                     grad_reduce_dtype=grad_reduce_dtype,
                     bucket_bytes=bucket_bytes, compression=compression)
        for knob, value in given.items():
            if value not in (None, False):
                raise NotImplementedError(
                    f"DataParallelTrainer({knob}=...) waits for ROADMAP "
                    f"{_UNPORTED[knob]}")
        if passes not in (None, False):
            raise NotImplementedError("DataParallelTrainer(passes=...): the "
                                      "port has no graph passes yet "
                                      "(ROADMAP A9)")
        if grad_reduce != "all_reduce":
            raise NotImplementedError(
                f"grad_reduce={grad_reduce!r} (ZeRO-1) waits for ROADMAP A1 "
                f"(the NCCL multi-card DataParallelTrainer)")
        self._net = net
        self._loss_block = loss
        self._mesh = mesh or local_mesh(data_axis)
        self._device = self._mesh.devices[0].torch_device()
        self._rule = FusedRule(optimizer, optimizer_params)
        self._fn = None
        self._n_inputs = None
        self._param_names = self._aux_names = None
        self._pmap: Dict = {}
        self._params: Dict[str, torch.Tensor] = {}
        self._aux: Dict[str, torch.Tensor] = {}
        self._opt_state: Dict[str, tuple] = {}

    # ------------------------------------------------------------- capture
    def _capture(self, arrays) -> None:
        """Trace ``loss(net(*data), label)`` to one graph (after an eager
        forward that finishes deferred shapes, when any are pending), and
        take the trainer's copies of the parameters (``grad_req`` not
        ``null``) and of the auxiliary ones."""
        from .. import symbol as sym_mod
        params = self._net.collect_params()
        if any(p._data is None for p in params.values()):
            with autograd.pause():
                self._net(*[NDArray(a) for a in arrays[:-1]])
        data_syms = [sym_mod.Variable(f"__data{i}")
                     for i in range(len(arrays) - 1)]
        out = self._net(*data_syms)
        if isinstance(out, (list, tuple)):
            out = out[0]
        loss_sym = self._loss_block(out, sym_mod.Variable("__label"))
        self._data_names = [s.name for s in data_syms] + ["__label"]
        var_names = {n.name for n in loss_sym.topo_nodes() if n.is_var}
        self._pmap = {p.name: p for p in params.values()
                      if p.name in var_names}
        self._param_names = [n for n, p in self._pmap.items()
                             if p.grad_req != "null"]
        self._aux_names = [n for n, p in self._pmap.items()
                           if p.grad_req == "null"]
        dev = self._device

        def copy(n, grad):
            t = self._pmap[n].data()._data.detach().to(dev, copy=True)
            return t.requires_grad_(grad)

        self._params = {n: copy(n, True) for n in self._param_names}
        self._aux = {n: copy(n, False) for n in self._aux_names}
        self._opt_state = self._rule.init(self._params)
        self._fn = _GraphLowering(loss_sym).lower(is_train=True)
        self._n_inputs = len(arrays)

    # ------------------------------------------------------------- step
    def step(self, *data) -> NDArray:
        """One forward, backward and update on a batch (the data inputs,
        then the label). Returns the mean loss as a 0-d NDArray; reading
        it synchronises."""
        arrays = [d._data if isinstance(d, NDArray)
                  else torch.from_numpy(np.asarray(d)) for d in data]
        if self._fn is None or self._n_inputs != len(arrays):
            self._capture(arrays)
        inputs = dict(self._aux)
        inputs.update(zip(self._data_names,
                          (a.to(self._device) for a in arrays)))
        inputs.update(self._params)
        with torch.enable_grad():
            outs, aux_updates = self._fn(inputs)
            loss = outs[0].float().mean()
        del outs
        names = self._param_names
        got = torch.autograd.grad(loss, [self._params[n] for n in names],
                                  allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(self._params[n])
                 for n, g in zip(names, got)}
        del got
        self._rule.step(self._params, grads, self._opt_state)
        with torch.no_grad():
            for n, v in aux_updates.items():
                if n in self._aux:
                    self._aux[n].copy_(v)
        return NDArray(loss.detach())

    def sync_to_net(self) -> None:
        """Copy the trainer's parameters and auxiliary states into the
        net's, in place on each parameter's device."""
        with torch.no_grad():
            for src in (self._params, self._aux):
                for n, t in src.items():
                    self._pmap[n].data()._data.copy_(t)

    # ------------------------------------------------------------- unported
    def aot_save(self, path, *data):
        raise NotImplementedError("ahead-of-time executables wait for "
                                  "ROADMAP A9")

    aot_load = aot_save

"""DataParallelTrainer: a gluon net's whole training step on one card.

Counterpart of the core of ``mxnet_tpu/parallel/data_parallel.py``
(``:193-1346``). The JAX package captures the net and its loss through the
same Symbol trace ``hybridize()`` uses and jits forward, backward, the
gradient all-reduce and optax's update into one XLA program over a device
mesh. The port captures the same graph and runs it through the executor's
interpreter under torch autograd: the loss is ``mean(float32
outputs[0])``, its gradients come from ``torch.autograd.grad``, optax's
rule (:mod:`.fused_rules`) updates the trainer's own copy of the weights
in place, and the moving statistics take the graph's aux updates. The
net's parameters are left alone until :meth:`DataParallelTrainer.sync_to_net`.

The step's knobs, as the JAX package has them:

* ``compute_dtype`` — the f32 master weights stay the trainer's; each step
  casts them, and every floating data input but the label, to the compute
  dtype inside the differentiated function (the cast's backward brings
  the gradients back to f32), and casts the aux updates back to each aux
  state's dtype. Token ids fed as floats are cast too, as in the JAX
  package: under bfloat16 an id above 256 is rounded (feed integer ids).
* ``remat`` — ``None``/``"none"``, ``"full"``, ``"dots"`` (save the
  outputs of matrix products without batch dimensions, ``aten.mm`` and
  ``aten.addmm``, recompute the rest) or a callable: a torch
  selective-checkpoint policy (where the JAX package takes a
  ``jax.checkpoint_policies`` function). The JAX package wraps the loss
  run in ``jax.checkpoint`` and leaves the recompute's schedule to XLA.
  In eager torch one checkpoint around the whole run rebuilds every saved
  activation when the backward starts, so it lowers no peak (on the H100,
  30.09 GB without it, 30.52 GB with it); the port checkpoints the
  graph's ops in ⌈√n⌉ consecutive segments instead
  (``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` around
  each), which keeps only the tensors between segments and recomputes one
  segment at a time. The recompute launches the attention kernel again,
  and draws the random numbers the forward drew.
* ``grad_guard``, ``loss_scaling``, ``dynamic_lr_scale`` — the skip-step
  on a non-finite or spiking gradient norm, the dynamic loss scale and a
  multiplier on every update, all held as 0-d tensors on the card: the
  skip is a ``torch.where``, and a step reads nothing back to the host
  (only :meth:`DataParallelTrainer.anomaly_stats` does).

* ``passes`` — the graph-pass pipeline (:mod:`mxnet_tpu_torch.passes`)
  over the captured loss graph before it is lowered: ``None`` the
  ``MXNET_PASSES`` default, ``False`` none, a ``PassManager`` or spec
  string a custom one. Parameters the pipeline re-homes (OHWI conv
  weights, the space-to-depth stem's) are transformed at capture and
  transformed back by :meth:`DataParallelTrainer.sync_to_net`, so the net
  keeps its own layout; a transposed weight stays a view of the
  trainer's copy, in the net's memory layout, so cuDNN sees the layout
  it saw without the pass.

One card per process in this slice (``mesh=None`` is ``gpu(0)``, where the
JAX package spans every local device). The other knobs raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from .. import autograd
from .. import random as _random
from ..base import MXNetError, logger
from ..executor import _GraphLowering
from ..passes import manager as _passes
from ..ndarray.ndarray import NDArray, torch_dtype
from ..resilience import recovery as _recovery
from .fused_rules import FusedRule
from .mesh import Mesh, local_mesh

__all__ = ["DataParallelTrainer"]

# knob -> the ROADMAP item it waits for
_UNPORTED = {
    "step_attribution": "A9 (observability)",
    "kvstore": "A1 (the NCCL multi-card DataParallelTrainer)",
    "grad_reduce_dtype": "A1 (the NCCL multi-card DataParallelTrainer)",
    "bucket_bytes": "A1 (the NCCL multi-card DataParallelTrainer)",
    "compression": "A8 (gradient compression)",
}

# the kernels of the LM's path (B1, B3, B2) take float32 and bfloat16
_CARD_DTYPES = (torch.float32, torch.bfloat16)
_F16_ITEM = "B5 (f16 instantiations of B1/B3/B2)"

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matrix
    products without batch dimensions, recompute everything else."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat):
    """(remat on?, ``context_fn`` for ``checkpoint``) of a ``remat``
    mode."""
    if remat in (None, "none"):
        return False, None
    if remat == "full":
        return True, None
    if remat == "dots":
        policy = _dots_policy
    elif callable(remat):
        policy = remat
    else:
        raise MXNetError(f"unknown remat mode {remat!r}")
    return True, functools.partial(
        _ckpt.create_selective_checkpoint_contexts, policy)


# ---- grad-anomaly guard (NaN/Inf + norm-spike skip inside the step) -------
def _guard_config(grad_guard):
    """Normalize the ``grad_guard`` argument. None/False = off; True =
    NaN/Inf + spike detection with defaults; a dict overrides
    ``spike_factor`` (0 disables spike detection, keeping only the NaN/Inf
    check), ``ema_decay`` and ``warmup`` (good steps before spikes can
    fire)."""
    if not grad_guard:
        return None
    g = dict(grad_guard) if isinstance(grad_guard, dict) else {}
    return {"spike_factor": float(g.get("spike_factor", 10.0)),
            "ema_decay": float(g.get("ema_decay", 0.99)),
            "warmup": int(g.get("warmup", 5))}


def _guard_init_state(device) -> Dict[str, torch.Tensor]:
    def z(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return {"ema": z(torch.float32), "last_norm": z(torch.float32),
            "skips": z(torch.int32), "good": z(torch.int32),
            "steps": z(torch.int32), "last_skipped": z(torch.int32)}


def _guard_apply(cfg, gstate, gnorm):
    """Skip-step verdict on the gradient norm: ``bad`` when it is NaN/Inf
    or spikes past ``spike_factor``× its EMA (after ``warmup`` good steps).
    Returns (bad, new guard state); keys of the scaler and the lr scale
    pass through."""
    gnorm = gnorm.float()
    finite = torch.isfinite(gnorm)
    if cfg["spike_factor"] > 0:
        warm = gstate["good"] >= cfg["warmup"]
        spike = warm & (gnorm > cfg["spike_factor"] * gstate["ema"])
    else:
        spike = torch.zeros((), dtype=torch.bool, device=gnorm.device)
    bad = ~finite | spike
    d = cfg["ema_decay"]
    safe_norm = torch.where(finite, gnorm, gstate["ema"])
    ema = torch.where(
        bad, gstate["ema"],
        torch.where(gstate["good"] == 0, safe_norm,
                    d * gstate["ema"] + (1.0 - d) * safe_norm))
    badi = bad.to(torch.int32)
    new = dict(gstate)
    new.update({"ema": ema, "last_norm": gnorm,
                "skips": gstate["skips"] + badi,
                "good": gstate["good"] + (1 - badi),
                "steps": gstate["steps"] + 1,
                "last_skipped": badi})
    return bad, new


def _global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of every gradient together (the
    norm of the per-tensor norms, so no squared copy is made)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[k]) for k in sorted(grads)]))


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
        given = dict(step_attribution=step_attribution, kvstore=kvstore,
                     grad_reduce_dtype=grad_reduce_dtype,
                     bucket_bytes=bucket_bytes, compression=compression)
        for knob, value in given.items():
            if value not in (None, False):
                raise NotImplementedError(
                    f"DataParallelTrainer({knob}=...) waits for ROADMAP "
                    f"{_UNPORTED[knob]}")
        if grad_reduce != "all_reduce":
            raise NotImplementedError(
                f"grad_reduce={grad_reduce!r} (ZeRO-1) waits for ROADMAP A1 "
                f"(the NCCL multi-card DataParallelTrainer)")
        self._net = net
        self._loss_block = loss
        self._passes = _passes.resolve(passes)
        self._pass_result = None
        self._pass_info: Dict[str, Any] = {}
        self._mesh = mesh or local_mesh(data_axis)
        self._device = self._mesh.devices[0].torch_device()
        self._compute_dtype = (torch_dtype(compute_dtype)
                               if compute_dtype is not None else None)
        if (self._device.type == "cuda" and self._compute_dtype is not None
                and self._compute_dtype not in _CARD_DTYPES):
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} on the card: the "
                f"attention and cross-entropy kernels take float32 and "
                f"bfloat16; {self._compute_dtype} waits for ROADMAP "
                f"{_F16_ITEM}")
        self._remat, self._remat_context = _remat_context(remat)
        self._rule = FusedRule(optimizer, optimizer_params)
        self._guard_cfg = _guard_config(grad_guard)
        self._scaler_cfg = _recovery.scaler_config(loss_scaling)
        if self._scaler_cfg is not None and self._guard_cfg is None:
            # the scaler's overflow response is the guard's skip-step; only
            # the unset default (None) upgrades to guard-on
            if grad_guard is not None:
                raise MXNetError(
                    "loss_scaling= requires the grad-anomaly guard; drop "
                    "grad_guard=%r or disable loss scaling" % (grad_guard,))
            self._guard_cfg = _guard_config(True)
        self._dynamic_lr = bool(dynamic_lr_scale)
        self._guard_state: Optional[Dict[str, torch.Tensor]] = None
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
        init_arrays = arrays if self._passes is None \
            else self._passes.init_view(arrays)
        if any(p._data is None for p in params.values()):
            with autograd.pause():
                self._net(*[NDArray(torch.as_tensor(a))
                            for a in init_arrays[:-1]])
        data_syms = [sym_mod.Variable(f"__data{i}")
                     for i in range(len(arrays) - 1)]
        out = self._net(*data_syms)
        if isinstance(out, (list, tuple)):
            out = out[0]
        loss_sym = self._loss_block(out, sym_mod.Variable("__label"))
        self._data_names = [s.name for s in data_syms] + ["__label"]
        loss_sym = self._run_passes(loss_sym, init_arrays)
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
            return self._placed_param(n, t).requires_grad_(grad)

        self._params = {n: copy(n, True) for n in self._param_names}
        self._aux = {n: copy(n, False) for n in self._aux_names}
        self._opt_state = self._rule.init(self._params)
        self._guard_state = _guard_init_state(dev)
        if self._scaler_cfg is not None:
            self._guard_state.update(
                _recovery.scaler_init_state(self._scaler_cfg, dev))
        if self._dynamic_lr:
            self._guard_state["lr_scale"] = torch.ones(
                (), dtype=torch.float32, device=dev)
        self._fn = _GraphLowering(loss_sym).lower(
            is_train=True,
            segment=self._checkpointed if self._remat else None)
        self._n_inputs = len(arrays)

    # ------------------------------------------------------------- passes
    def _run_passes(self, loss_sym, init_arrays):
        """The configured pipeline over the captured loss graph: input
        shapes from the sample batch as the net takes it, parameter shapes
        from the net's parameters. A pipeline that raises leaves the graph
        unrewritten, with a warning, as in the JAX package."""
        from ..passes.layout import is_nchw_conv
        self._pass_result = None
        self._pass_info = {
            "nchw_convs": sum(1 for n in loss_sym.topo_nodes()
                              if not n.is_var and is_nchw_conv(n)),
            "layout_enabled": (self._passes is not None
                               and "layout" in self._passes.names)}
        if self._passes is None:
            return loss_sym
        shapes, pnames = {}, set()
        for p in self._net.collect_params().values():
            pnames.add(p.name)
            if p.shape and all(int(d) > 0 for d in p.shape):
                shapes[p.name] = tuple(int(d) for d in p.shape)
        for name, a in zip(self._data_names, init_arrays):
            shapes[name] = tuple(int(d) for d in a.shape)
        try:
            res = self._passes.run(loss_sym, shapes=shapes,
                                   input_vars=self._data_names,
                                   param_names=pnames)
        except Exception as e:
            logger.warning("graph-pass pipeline failed; capturing the "
                           "unrewritten graph: %r", e)
            return loss_sym
        self._pass_info["rewrites"] = dict(res.counts)
        if res.total_rewrites == 0:
            return loss_sym
        self._pass_result = res
        return res.symbol

    def _placed_param(self, name, value):
        """A parameter's value as the rewritten graph takes it: the
        recorded transform of a re-homed variable (a transpose stays a
        view), else the value itself."""
        if self._pass_result is None or \
                name not in self._pass_result.var_transforms:
            return value
        return self._pass_result.transform_var(name, value)

    def passes_provenance(self) -> Dict[str, Any]:
        """Which passes this trainer runs and what they rewrote (one schema
        with ``Module``: ``passes.manager.provenance``)."""
        return _passes.provenance(self._passes, self._pass_result,
                                  self._pass_info.get("rewrites"))

    # ------------------------------------------------------------- step
    def _checkpointed(self, run, *tensors):
        """One segment of the graph under ``torch.utils.checkpoint``; its
        recompute puts the random stream back where the forward found it
        (``jax.checkpoint`` replays the same key)."""
        gen, start = _random.generator(self._device), []

        def replay(*ts):
            if start:
                gen.set_state(start[0])
            else:
                start.append(gen.get_state())
            return run(*ts)

        kw = {} if self._remat_context is None else \
            {"context_fn": self._remat_context}
        return _ckpt.checkpoint(replay, *tensors, use_reentrant=False, **kw)

    def _captured_for(self, data):
        """The batch as tensors, the graph captured for it first where it
        is not yet."""
        arrays = [d._data if isinstance(d, NDArray)
                  else torch.from_numpy(np.asarray(d)) for d in data]
        if self._fn is None or self._n_inputs != len(arrays):
            self._capture(arrays)
        return arrays

    def step(self, *data) -> NDArray:
        """One forward, backward and update on a batch (the data inputs,
        then the label). Returns the mean loss as a 0-d NDArray; reading
        it synchronises."""
        arrays = self._captured_for(data)
        cdt = self._compute_dtype
        inputs = dict(self._aux)
        for name, a in zip(self._data_names, arrays):
            a = a.to(self._device)
            if cdt is not None and a.is_floating_point() \
                    and name != "__label":
                a = a.to(cdt)
            inputs[name] = a
        gstate = self._guard_state
        scale = gstate["loss_scale"] if self._scaler_cfg is not None \
            else None
        names = self._param_names
        gen = _random.generator(self._device) if self._remat else None
        with torch.enable_grad():
            inputs.update({n: self._params[n].to(cdt) if cdt is not None
                           else self._params[n] for n in names})
            outs, aux_updates = self._fn(inputs)
            loss = outs[0].float().mean()
            # the loss times the live scale; the host sees the true loss
            scaled = loss if scale is None else loss * scale
        del inputs, outs
        after = gen.get_state() if gen is not None else None
        got = torch.autograd.grad(scaled, [self._params[n] for n in names],
                                  allow_unused=True)
        del scaled
        if after is not None:
            gen.set_state(after)
        grads = {}
        for n, g in zip(names, got):
            g = torch.zeros_like(self._params[n]) if g is None else g.float()
            grads[n] = g if scale is None else g / scale
        del got
        skip = lr_scale = None
        if self._guard_cfg is not None:
            gnorm = _global_norm(grads)
            skip, gstate = _guard_apply(self._guard_cfg, gstate, gnorm)
            if self._scaler_cfg is not None:
                gstate.update(_recovery.scaler_apply(
                    self._scaler_cfg, gstate, ~torch.isfinite(gnorm), skip))
        if self._dynamic_lr:
            lr_scale = self._guard_state["lr_scale"]
        self._rule.step(self._params, grads, self._opt_state, skip=skip,
                        lr_scale=lr_scale)
        with torch.no_grad():
            for n, v in aux_updates.items():
                if n in self._aux:
                    v = v.to(self._aux[n].dtype)
                    self._aux[n].copy_(v if skip is None else
                                       torch.where(skip, self._aux[n], v))
        self._guard_state = gstate
        return NDArray(loss.detach())

    def sync_to_net(self) -> None:
        """Copy the trainer's parameters and auxiliary states into the
        net's, in place on each parameter's device; a re-homed parameter
        is transformed back to the net's layout first."""
        res = self._pass_result
        with torch.no_grad():
            for src in (self._params, self._aux):
                for n, t in src.items():
                    if res is not None and n in res.var_transforms:
                        t = res.inverse_var(n, t)
                    self._pmap[n].data()._data.copy_(t)

    # ------------------------------------------------------------- state
    def _checkpoint_trees(self, *data):
        """The trainer's state as ``checkpoint.ShardedCheckpointer.save``
        takes it: ``(params, aux)``. ``params`` holds every parameter and
        auxiliary value in the net's own layout (a re-homed weight
        transformed back, as :meth:`sync_to_net` writes it); ``aux`` the
        optimizer's state (``__opt__<name>_<i>``, the update count
        ``__count__``) and the guard's (``__guard__<key>``), in the
        trainer's layout. The tensors are the trainer's own wherever the
        layout is the net's (a save copies them). ``data``, a batch,
        captures the graph first where no step has run."""
        if data:
            self._captured_for(data)
        if self._fn is None:
            raise MXNetError("the trainer has no state before its first "
                             "step; pass a batch to capture the graph")
        res = self._pass_result
        params = {}
        for src in (self._params, self._aux):
            for n, t in src.items():
                if res is not None and n in res.var_transforms:
                    t = res.inverse_var(n, t)
                params[n] = t.detach()
        aux = {f"__opt__{n}_{i}": t
               for n, s in self._opt_state.items() for i, t in enumerate(s)}
        aux["__count__"] = self._rule.count
        aux.update({f"__guard__{k}": v
                    for k, v in (self._guard_state or {}).items()})
        return params, aux

    def _load_checkpoint(self, restored) -> None:
        """Copy a restore of :meth:`_checkpoint_trees`' two trees (the
        ``aux`` names under the checkpointer's ``__aux__`` prefix) into the
        trainer, in place; the graph must be captured."""
        params, aux = self._checkpoint_trees()
        with torch.no_grad():
            for n, t in params.items():
                dst = self._params.get(n, self._aux.get(n))
                dst.copy_(self._placed_param(n, restored[n].to(dst.device)))
            for k, t in aux.items():
                t.copy_(restored["__aux__" + k])

    # ------------------------------------------------------------- guard
    def anomaly_stats(self) -> Dict[str, Any]:
        """Grad-anomaly guard counters (empty when the guard is off or no
        step ran): skipped steps, the gradient norm's EMA, the last step's
        norm and whether it was skipped; the scaler's state and the lr
        scale where they are on. Reading copies the scalars to the host,
        which waits for the card."""
        if self._guard_cfg is None or self._guard_state is None:
            return {}
        gs = self._guard_state
        stats = {"grad_skipped_steps": int(gs["skips"]),
                 "grad_norm_ema": float(gs["ema"]),
                 "last_grad_norm": float(gs["last_norm"]),
                 "last_step_skipped": bool(int(gs["last_skipped"]))}
        if self._scaler_cfg is not None:
            stats["loss_scale"] = float(gs["loss_scale"])
            stats["scaler_overflows"] = int(gs["ls_overflows"])
            stats["scaler_good_steps"] = int(gs["ls_good"])
        if self._dynamic_lr:
            stats["lr_scale"] = float(gs["lr_scale"])
        return stats

    def set_loss_scale(self, scale: float) -> None:
        """Set the loss scale from the host (a power of two, clamped to the
        configured range); the growth counter restarts."""
        if self._scaler_cfg is None or self._guard_state is None:
            raise MXNetError("trainer has no loss scaler (construct with "
                             "loss_scaling=...)")
        _recovery._require_pow2("loss scale override", scale)
        scale = min(max(float(scale), float(self._scaler_cfg["min_scale"])),
                    float(self._scaler_cfg["max_scale"]))
        self._guard_state = dict(self._guard_state)
        self._guard_state["loss_scale"] = torch.tensor(
            scale, dtype=torch.float32, device=self._device)
        self._guard_state["ls_good"] = torch.zeros(
            (), dtype=torch.int32, device=self._device)

    def set_lr_scale(self, scale: float) -> None:
        """Set the multiplier on every update from the host."""
        if not self._dynamic_lr or self._guard_state is None:
            raise MXNetError("trainer has no dynamic lr scale "
                             "(construct with dynamic_lr_scale=True)")
        self._guard_state = dict(self._guard_state)
        self._guard_state["lr_scale"] = torch.tensor(
            float(scale), dtype=torch.float32, device=self._device)

    # ------------------------------------------------------------- unported
    def aot_save(self, path, *data):
        raise NotImplementedError("ahead-of-time executables wait for "
                                  "ROADMAP A9")

    aot_load = aot_save

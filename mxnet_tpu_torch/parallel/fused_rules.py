"""The fused trainer's optimizer rules: optax's, not MXNet's.

Counterpart of ``_make_optax`` in ``mxnet_tpu/parallel/data_parallel.py``
(``:166-190``), whose rules are optax's (read from optax's own
transforms). They differ from MXNet's (``optimizer.py``) and from
``torch.optim``'s:

* ``sgd``: ``m ← μ·m + g``, ``w ← w − lr·m`` (no momentum:
  ``w ← w − lr·g``); ``nag`` adds Nesterov's look-ahead,
  ``w ← w − lr·(g + μ·m)``, with μ = 0.9 by default;
* ``adam``: ``m ← β1·m + (1−β1)·g``, ``v ← β2·v + (1−β2)·g²``,
  ``w ← w − lr·m̂/(√v̂ + ε)`` with ε added to the *corrected* √v̂, the
  step count shared by all parameters;
* ``rmsprop`` (``gamma1`` is the decay, 0.9): ``ν ← d·ν + (1−d)·g²`` from
  ν = 0, ``w ← w − lr·g/√(ν + ε)``: ε *inside* the root (optax's
  ``eps_in_sqrt=True``);
* ``adagrad``: ``s ← s + g²`` from optax's ``initial_accumulator_value``
  0.1, ``w ← w − lr·g/√(s + 1e-7)``;
* ``wd``: ``g ← g + wd·w`` ahead of the rule (``add_decayed_weights``);
* ``learning_rate`` a number, or a schedule of the update count as optax
  takes it: ``lr(0)`` for the first update. The count is a 0-d int64
  tensor on the parameters' device, as optax's is a traced array, so a
  schedule is arithmetic on it (``0.3 * 0.5 ** count``; ``count == 0``
  is a tensor) and the step reads nothing back to the host.

Each parameter and state tensor takes its new value in place (the
tensor object stays, its storage is the new value's); under the gradient
guard a skipped step leaves every tensor and the update count as they
were.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..base import MXNetError

__all__ = ["FusedRule"]

_DEFAULTS = {
    "sgd": {"momentum": 0.0},
    "nag": {"momentum": 0.9},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "rmsprop": {"gamma1": 0.9, "epsilon": 1e-8},
    "adagrad": {},
}
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-7


class FusedRule:
    """One of optax's rules by the JAX package's optimizer name and
    ``optimizer_params`` (``learning_rate``, ``wd`` and the rule's own)."""

    def __init__(self, optimizer: str, optimizer_params=None):
        name = str(optimizer).lower()
        if name not in _DEFAULTS:
            raise MXNetError(f"fused path does not know optimizer "
                             f"{optimizer!r}; use gluon.Trainer for the full "
                             f"registry")
        p = dict(optimizer_params or {})
        self.name = name
        lr = p.pop("learning_rate", 0.01)
        self.lr = lr if callable(lr) else float(lr)
        self.wd = float(p.pop("wd", 0.0))
        self.hp = {k: float(p.pop(k, v)) for k, v in _DEFAULTS[name].items()}
        if p:
            raise MXNetError(f"the fused {name} rule takes no "
                             f"{sorted(p)}")
        self.count: Optional[torch.Tensor] = None

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
        """The state of each parameter, zeros like it (adagrad's sum of
        squares starts at 0.1); the update count restarts at 0."""
        dev = next(iter(params.values())).device if params else None
        self.count = torch.zeros((), dtype=torch.int64, device=dev)

        def z(t):
            return torch.zeros_like(t, memory_format=torch.contiguous_format)

        if self.name in ("sgd", "nag"):
            return {n: (z(t),) if self.hp["momentum"] else ()
                    for n, t in params.items()}
        if self.name == "adam":
            return {n: (z(t), z(t)) for n, t in params.items()}
        if self.name == "adagrad":
            return {n: (z(t).fill_(_ADAGRAD_INIT),)
                    for n, t in params.items()}
        return {n: (z(t),) for n, t in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict[str, tuple],
             skip: Optional[torch.Tensor] = None,
             lr_scale: Optional[torch.Tensor] = None) -> None:
        """One update of every parameter in ``grads``, in place.

        ``skip`` (the gradient guard's verdict, a 0-d bool tensor) keeps
        every parameter, every state and the update count where it is
        true, as the JAX step's ``jnp.where`` over its trees does.
        ``lr_scale`` (a 0-d tensor) multiplies every update."""
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        count = self.count + 1
        # adam's bias correction counts this update (in float64)
        t = count.double() if self.name == "adam" else None
        self.count = count if skip is None else \
            torch.where(skip, self.count, count)
        hp = self.hp

        def put(dst, new):
            # the new value's storage, not a copy of it: dst stays the
            # tensor the trainer (and autograd) hold
            dst.data = new if skip is None else torch.where(skip, dst, new)

        for n, g in grads.items():
            w, s = params[n], state[n]
            if self.wd:
                g = g + self.wd * w
            if self.name in ("sgd", "nag"):
                if s:
                    (m,) = s
                    m_new = m * hp["momentum"] + g
                    u = g + hp["momentum"] * m_new \
                        if self.name == "nag" else m_new
                    put(m, m_new)
                else:
                    u = g
            elif self.name == "adam":
                m, v = s
                b1, b2 = hp["beta1"], hp["beta2"]
                m_new = torch.add(m * b1, g, alpha=1.0 - b1)
                v_new = torch.addcmul(v * b2, g, g, value=1.0 - b2)
                m_hat = m_new / (1.0 - b1 ** t)
                v_hat = v_new / (1.0 - b2 ** t)
                u = m_hat / (v_hat.sqrt() + hp["epsilon"])
                put(m, m_new)
                put(v, v_new)
            elif self.name == "rmsprop":
                (nu,) = s
                d = hp["gamma1"]
                nu_new = torch.addcmul(nu * d, g, g, value=1.0 - d)
                u = g * torch.rsqrt(nu_new + hp["epsilon"])
                put(nu, nu_new)
            else:                                           # adagrad
                (acc,) = s
                acc_new = torch.addcmul(acc, g, g)
                u = g * torch.where(acc_new > 0,
                                    torch.rsqrt(acc_new + _ADAGRAD_EPS),
                                    torch.zeros((), device=acc.device))
                put(acc, acc_new)
            upd = lr * u
            if lr_scale is not None:
                upd = upd * lr_scale
            put(w, w - upd)

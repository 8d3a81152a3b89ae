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
  takes it: ``lr(0)`` for the first update.

Updates are written in place under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict

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
        self.count = 0

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
        """The state of each parameter, zeros like it (adagrad's sum of
        squares starts at 0.1)."""
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
             grads: Dict[str, torch.Tensor], state: Dict[str, tuple]) -> None:
        """One update of every parameter in ``grads``, in place."""
        lr = float(self.lr(self.count)) if callable(self.lr) else self.lr
        self.count += 1
        hp = self.hp
        for n, g in grads.items():
            w, s = params[n], state[n]
            if self.wd:
                g = g + self.wd * w
            if self.name in ("sgd", "nag"):
                if s:
                    (m,) = s
                    m.mul_(hp["momentum"]).add_(g)
                    u = g + hp["momentum"] * m if self.name == "nag" else m
                else:
                    u = g
                w.sub_(lr * u)
            elif self.name == "adam":
                m, v = s
                b1, b2 = hp["beta1"], hp["beta2"]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = m / (1.0 - b1 ** self.count)
                v_hat = v / (1.0 - b2 ** self.count)
                w.sub_(lr * (m_hat / (v_hat.sqrt() + hp["epsilon"])))
            elif self.name == "rmsprop":
                (nu,) = s
                d = hp["gamma1"]
                nu.mul_(d).addcmul_(g, g, value=1.0 - d)
                w.sub_(lr * (g * torch.rsqrt(nu + hp["epsilon"])))
            else:                                           # adagrad
                (acc,) = s
                acc.addcmul_(g, g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + _ADAGRAD_EPS),
                                    torch.zeros((), device=acc.device))
                w.sub_(lr * (g * scale))

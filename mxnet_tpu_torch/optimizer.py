"""Optimizers: MXNet's update rules, not ``torch.optim``'s.

Counterpart of ``mxnet_tpu/optimizer.py``: the registry, ``Updater``
and the whole MXNet family (SGD, NAG, Adam, AdaGrad, AdaDelta, RMSProp,
Ftrl, Signum, FTML, DCASGD, Adamax, Nadam, LBSGD and ``Test``), with
``multi_precision`` (float32 masters for float16 weights). Reference
``python/mxnet/optimizer/optimizer.py`` and the fused kernels of
``src/operator/optimizer_op.cc``. Each rule keeps the JAX package's
arithmetic in its order, its quirks included: ``AdaDelta`` ignores the
learning rate, ``Ftrl`` and ``FTML`` divide by it, ``Adamax`` adds a fixed
1e-8, ``Nadam``'s ``m_schedule`` is one scalar that every ``update`` call
multiplies (so it depends on the order parameters are updated in),
``LBSGD`` scales the learning rate by its LARS ratio only where no
``lr_scheduler`` is set (``_get_lr`` reads the schedule) and drops its
warm-up arguments. The rules differ from torch's:

* SGD with momentum: ``m ← μ·m − lr·g; w ← w + m`` (torch folds lr in
  after the momentum: the two part ways when the learning rate changes);
* Adam: bias correction folded into ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)``, then
  ``w ← w − lr_t·m/(√v + ε)`` with ε not bias-corrected (torch adds ε to
  the corrected √v̂), ``t`` counted per parameter index;
* weight decay is added to the gradient (L2), ``g ← rescale·g (clipped) +
  wd·w``, in both;
* an ``lr_scheduler`` (:mod:`.lr_scheduler`) gives the learning rate of
  each update from ``num_update``, as in the JAX package.

``Updater.get_states(dump_optimizer=True)`` pickles the states as numpy
arrays together with the optimizer (its per-index update counts,
``num_update`` and scheduler), as the reference's ``Trainer.save_states``
does, so that a resumed run takes the same steps as an uninterrupted one.
The JAX package's trainer saves the states without the optimizer
(``mxnet_tpu/gluon/trainer.py:149``): its resumed Adam restarts the
bias correction and the schedule. Its files pickle JAX arrays and do not
load here.

Updates run in place under ``torch.no_grad()``: the weight tensor is the
autograd leaf that the next ``backward`` reaches, so it must not be
rebound. The JAX package rebinds immutable arrays instead. A row_sparse
gradient takes ``Updater``'s lazy path under plain SGD (only its rows
are written) and is densified for every other rule.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "FTML", "DCASGD", "Adamax", "Nadam",
           "LBSGD", "Test", "create", "register", "Updater", "get_updater"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}")
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is active; set lr on the "
                             "scheduler")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def __getstate__(self):
        # parameters are bound again by the trainer that loads the states
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d

    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]) -> None:
        self.wd_mult = dict(args_wd_mult)

    def _mult(self, index, mults, attr) -> float:
        """A parameter's multiplier: its ``Parameter``'s, else one given
        for its index, else one given for its name (from
        ``param_idx2name``), else 1."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clipped(self, grad) -> torch.Tensor:
        """``rescale·g``, clipped: a new float tensor. A
        ``clip_gradient`` of 0 or None clips nothing, as in the JAX
        package."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        return g

    def _grad(self, index, weight, grad) -> torch.Tensor:
        """``rescale·g``, clipped, plus ``wd·w``: a new float tensor."""
        g = self._clipped(grad)
        wd = self._get_wd(index)
        if wd:
            g.add_(weight._data, alpha=wd)
        return g

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def create_state_multi_precision(self, index, weight):
        """A float16 weight under ``multi_precision`` gets a float32
        master copy, and the rule's state is made for the master."""
        if self.multi_precision and weight._data.dtype == torch.float16:
            master = weight._data.detach().float()
            return master, self.create_state(index, NDArray(master))
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        """The rule on the float32 master and the float32 gradient, the
        weight then the master rounded to float16."""
        if self.multi_precision and weight._data.dtype == torch.float16:
            master, base = state
            self.update(index, NDArray(master), NDArray(grad._data.float()),
                        base)
            with torch.no_grad():
                weight._data.copy_(master)
        else:
            self.update(index, weight, grad, state)


def _zeros(weight) -> torch.Tensor:
    return torch.zeros_like(weight._data.detach())


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (reference ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight._data.detach())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            self._step(weight._data, g, state, lr)

    def _step(self, w, g, mom, lr) -> None:
        # ``lr`` is a float, or a 0-d float32 tensor (LBSGD's)
        lr_g = g.mul_(lr) if isinstance(lr, torch.Tensor) else None
        if mom is None:
            if lr_g is None:
                w.sub_(g, alpha=lr)
            else:
                w.sub_(lr_g)
        else:
            mom.mul_(self.momentum)
            if lr_g is None:
                mom.sub_(g, alpha=lr)
            else:
                mom.sub_(lr_g)
            w.add_(mom)


@register
class NAG(SGD):
    """Nesterov momentum: ``m ← μ·m + g``, ``w ← w − lr·(g + μ·m)``."""

    def _step(self, w, g, mom, lr) -> None:
        if mom is None:
            w.sub_(g * lr)
            return
        mom.copy_(self.momentum * mom + g)
        w.sub_(lr * (g + self.momentum * mom))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        w = weight._data.detach()
        return torch.zeros_like(w), torch.zeros_like(w)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        m, v = state
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            denom = v.sqrt().add_(self.epsilon)
            weight._data.sub_(m.mul(lr_t).div_(denom))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            state.copy_(state + g * g)
            weight._data.sub_(lr * g / (state.sqrt() + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """Zeiler's rule; the learning rate is not read (as in the JAX
    package), and weight decay is subtracted after the step."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        with torch.no_grad():
            g = self._clipped(grad)
            ag = self.rho * acc_g + (1 - self.rho) * g * g
            delta = (acc_delta + self.epsilon).sqrt() \
                / (ag + self.epsilon).sqrt() * g
            ad = self.rho * acc_delta + (1 - self.rho) * delta * delta
            acc_g.copy_(ag)
            acc_delta.copy_(ad)
            w = weight._data
            w.copy_(w - delta - wd * w)


@register
class RMSProp(Optimizer):
    """Tieleman and Hinton's rule, or Graves's centred one, with
    ``clip_weights``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(weight), _zeros(weight), _zeros(weight)
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        g1 = self.gamma1
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            w = weight._data
            if self.centered:
                n, gbar, delta = state
                nn = g1 * n + (1 - g1) * g * g
                gb = g1 * gbar + (1 - g1) * g
                d = self.gamma2 * delta - lr * g / (nn - gb * gb
                                                    + self.epsilon).sqrt()
                n.copy_(nn)
                gbar.copy_(gb)
                delta.copy_(d)
                new_w = w + d
            else:
                nn = (1 - g1) * g * g + g1 * state
                state.copy_(nn)
                new_w = w - lr * g / (nn + self.epsilon).sqrt()
            if self.clip_weights:
                new_w = new_w.clamp(-self.clip_weights, self.clip_weights)
            w.copy_(new_w)


@register
class Ftrl(Optimizer):
    """FTRL-proximal; σ and the denominator divide by the learning rate,
    as in the JAX package."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)      # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        with torch.no_grad():
            g = self._clipped(grad)
            w = weight._data
            nn = n + g * g
            sigma = (nn.sqrt() - n.sqrt()) / lr
            zz = z + g - sigma * w
            z.copy_(zz)
            n.copy_(nn)
            shrunk = -(zz - zz.sign() * self.lamda1) \
                / ((self.beta + nn.sqrt()) / lr + wd)
            w.copy_(torch.where(zz.abs() > self.lamda1, shrunk,
                                torch.zeros_like(shrunk)))


@register
class Signum(Optimizer):
    """The sign of the momentum (or of the gradient without one)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = self._clipped(grad)
            w = weight._data
            if state is not None:
                mom = self.momentum * state - (1 - self.momentum) * (g + wd * w)
                state.copy_(mom)
                new_w = (1 - lr * self.wd_lh) * w + lr * mom.sign()
            else:
                new_w = (1 - lr * (wd + self.wd_lh)) * w - lr * g.sign()
            w.copy_(new_w)


@register
class FTML(Optimizer):
    """Follow the moving leader; ``d_t`` divides by the learning rate."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight), _zeros(weight)   # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        b1, b2 = self.beta1, self.beta2
        d, v, z = state
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            w = weight._data
            vv = b2 * v + (1 - b2) * g * g
            d_t = (1 - b1 ** t) / lr * ((vv / (1 - b2 ** t)).sqrt()
                                        + self.epsilon)
            sigma = d_t - b1 * d
            zz = b1 * z + (1 - b1) * g - sigma * w
            d.copy_(d_t)
            v.copy_(vv)
            z.copy_(zz)
            w.copy_(-zz / d_t)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the state keeps the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros(weight) if self.momentum != 0 else None,
                weight._data.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev = state
        with torch.no_grad():
            g = self._clipped(grad)
            w = weight._data
            comp = g + wd * w + self.lamda * g * g * (w - prev)
            prev.copy_(w)
            if mom is not None:
                mom.copy_(self.momentum * mom - lr * comp)
                w.copy_(w + mom)
            else:
                w.copy_(w - lr * comp)


@register
class Adamax(Optimizer):
    """Adam over the infinity norm; its ε is the JAX package's fixed
    1e-8."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1 - self.beta1 ** t)
        m, u = state
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            mm = self.beta1 * m + (1 - self.beta1) * g
            uu = torch.maximum(self.beta2 * u, g.abs())
            m.copy_(mm)
            u.copy_(uu)
            w = weight._data
            w.copy_(w - lr * mm / (uu + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum. ``m_schedule`` is one scalar of the
    optimizer, multiplied at every ``update`` call of any parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        b1, b2 = self.beta1, self.beta2
        mom_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= mom_t
        m_sched_next = self.m_schedule * mom_t1
        m, v = state
        with torch.no_grad():
            g = self._grad(index, weight, grad)
            mm = b1 * m + (1 - b1) * g
            vv = b2 * v + (1 - b2) * g * g
            g_prime = g / (1 - self.m_schedule)
            m_prime = mm / (1 - m_sched_next)
            v_prime = vv / (1 - b2 ** t)
            m_bar = (1 - mom_t) * g_prime + mom_t1 * m_prime
            m.copy_(mm)
            v.copy_(vv)
            w = weight._data
            w.copy_(w - lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD with a LARS ratio ``clip(‖w‖/(‖rescale·g‖ + 1e-9),
    0, 10)`` (1 where the gradient is zero) on the learning rate. The
    ratio stays a 0-d float32 tensor on the weight's device (the JAX
    package reads it back to the host for every parameter: the same
    value). The warm-up arguments are accepted and dropped, and under an
    ``lr_scheduler`` the ratio is not applied, as in the JAX package."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            wnorm = torch.linalg.vector_norm(weight._data)
            gnorm = torch.linalg.vector_norm(grad._data * self.rescale_grad)
            lars = torch.where(gnorm > 0, wnorm / (gnorm + 1e-9),
                               torch.ones_like(gnorm))
            scaled = self.lr * lars.clamp(0.0, 10.0)
        lr_save = self.lr
        try:
            self.lr = scaled
            super().update(index, weight, grad, state)
        finally:
            self.lr = lr_save


@register
class Test(Optimizer):
    """``w ← w − lr·rescale·g``, no update count (the reference's test
    rule)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            w = weight._data
            w.copy_(w - self.lr * grad._data * self.rescale_grad)


def _to_host(state):
    """A state (None, a tensor, or a tuple of them) with numpy arrays for
    tensors."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _to_device(state, device: torch.device):
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state).to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state


class Updater:
    """Applies an optimizer with per-index states. States loaded by
    :meth:`set_states` are numpy arrays until the index's next update
    moves them to its weight's device."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        from .ndarray.sparse import RowSparseNDArray
        if isinstance(grad, RowSparseNDArray):
            if self._lazy_row_sparse_update(index, grad, weight):
                return
            grad = grad.todense()       # every other rule: the dense update
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, False):
            self.states[index] = _to_device(self.states[index],
                                            weight._data.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def _lazy_row_sparse_update(self, index, grad, weight) -> bool:
        """The lazy update of a row_sparse gradient (reference SGD
        ``lazy_update=True``, ``optimizer_op.cc`` SGDUpdateEx): only the
        gradient's rows are written, in place, every other row keeps its
        bits. Taken for momentum-free ``SGD`` with ``lazy_update`` and no
        ``multi_precision`` only (a state that must decay every step, or
        ``lazy_update=False``'s weight decay on every row, needs the dense
        update); returns whether it was taken. Duplicate indices are summed
        first; weight decay falls on the touched rows; the update count
        and the schedule advance once a call."""
        opt = self.optimizer
        if not (type(opt).__name__ == "SGD"
                and getattr(opt, "momentum", 0) == 0
                and getattr(opt, "lazy_update", True)
                and not getattr(opt, "multi_precision", False)):
            return False
        opt._update_count(index)
        lr, wd = opt._get_lr(index), opt._get_wd(index)
        w = weight._data
        with torch.no_grad():
            vals = grad._values.to(w.device)
            uniq, inv = torch.unique(grad._indices.to(w.device), sorted=True,
                                     return_inverse=True)
            g = vals.new_zeros((uniq.numel(),) + vals.shape[1:])
            g = g.index_add_(0, inv, vals) * opt.rescale_grad
            if opt.clip_gradient:
                g.clamp_(-opt.clip_gradient, opt.clip_gradient)
            rows = w.index_select(0, uniq)
            w.index_copy_(0, uniq, rows - lr * (g + wd * rows))
        return True

    def dump_states(self, f, dump_optimizer: bool = False) -> None:
        """Pickle the states (numpy arrays), with the optimizer if asked,
        into the open binary file ``f``."""
        host = {i: _to_host(s) for i, s in self.states.items()}
        pickle.dump((host, self.optimizer) if dump_optimizer else host, f,
                    protocol=pickle.HIGHEST_PROTOCOL)

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        import io
        buf = io.BytesIO()
        self.dump_states(buf, dump_optimizer)
        return buf.getvalue()

    def set_states(self, states) -> None:
        """Load what :meth:`get_states` wrote (bytes, or an open binary
        file); the optimizer too, where it was dumped. Unpickle only files
        this program wrote."""
        obj = pickle.loads(states) if isinstance(states, (bytes, bytearray)) \
            else pickle.load(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj
        self.states_synced = dict.fromkeys(self.states, False)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

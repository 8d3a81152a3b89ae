"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (reference
``src/operator/random/``: sample_op.cc, multisample_op.cc, shuffle_op.cc):
the ``_random_*`` family with scalar parameters, the ``_sample_*`` family
with per-element parameter arrays (output shape = parameter shape +
``shape``), ``_sample_multinomial`` and ``_shuffle``.

Every draw comes from the ``torch.Generator`` passed as ``rng``: the
registry's callers give each op the generator of the device it runs on
(its first input's, else its context's), imperatively and in the
executor, in training and at inference. Torch's streams do not reproduce
JAX's bits; the distributions are the same. The negative binomials draw a
gamma and then a Poisson, as the JAX file does. An op without array inputs
creates its output on ``device``.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _dt(dtype):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(dtype or "float32")


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def standard_gamma(alpha, rng):
    """Gamma(alpha, 1) draws, one per entry of the float tensor ``alpha``
    (``torch._standard_gamma``; no draw on the meta device of shape
    inference)."""
    if alpha.device.type == "meta":
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha, generator=rng)


def poisson(lam, rng):
    """Poisson(lam) draws, one per entry of the float tensor ``lam``."""
    if lam.device.type == "meta":
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=rng)


def neg_binomial(k, p, rng):
    """NB(k, p) as the gamma-Poisson mixture: Poisson(Gamma(k) (1-p)/p)."""
    return poisson(standard_gamma(k, rng) * ((1.0 - p) / p), rng)


@register("_random_uniform", aliases=["random_uniform", "uniform"],
          needs_rng=True, differentiable=False)
def _uniform(low=0.0, high=1.0, shape=(), dtype="float32", rng=None,
             device=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=device) \
        .uniform_(float(low), float(high), generator=rng)


@register("_random_normal", aliases=["random_normal", "normal"],
          needs_rng=True, differentiable=False)
def _normal(loc=0.0, scale=1.0, shape=(), dtype="float32", rng=None,
            device=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=device) \
        .normal_(float(loc), float(scale), generator=rng)


@register("_random_gamma", aliases=["random_gamma"], needs_rng=True,
          differentiable=False)
def _gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", rng=None,
           device=None):
    a = torch.full(_shape(shape), float(alpha), dtype=_dt(dtype),
                   device=device)
    return standard_gamma(a, rng) * beta


@register("_random_exponential", aliases=["random_exponential"],
          needs_rng=True, differentiable=False)
def _exponential(lam=1.0, shape=(), dtype="float32", rng=None, device=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=device) \
        .exponential_(1.0, generator=rng) / lam


@register("_random_poisson", aliases=["random_poisson"], needs_rng=True,
          differentiable=False)
def _poisson(lam=1.0, shape=(), dtype="float32", rng=None, device=None):
    lam_t = torch.full(_shape(shape), float(lam), device=device)
    return poisson(lam_t, rng).to(_dt(dtype))


@register("_random_negative_binomial", aliases=["random_negative_binomial"],
          needs_rng=True, differentiable=False)
def _neg_binomial(k=1, p=1.0, shape=(), dtype="float32", rng=None,
                  device=None):
    k_t = torch.full(_shape(shape), float(k), device=device)
    return neg_binomial(k_t, float(p), rng).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial"], needs_rng=True,
          differentiable=False)
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                      rng=None, device=None):
    """Poisson(Gamma(1/alpha) mu alpha)."""
    r = torch.full(_shape(shape), 1.0 / float(alpha), device=device)
    lam = standard_gamma(r, rng) * (float(mu) * float(alpha))
    return poisson(lam, rng).to(_dt(dtype))


@register("_random_randint", aliases=["random_randint", "randint"],
          needs_rng=True, differentiable=False)
def _randint(low=0, high=1, shape=(), dtype="int32", rng=None, device=None):
    return torch.randint(int(low), int(high), _shape(shape), generator=rng,
                         dtype=_dt(dtype), device=device)


def _per_element(param, shape):
    """``param`` viewed as param.shape + (1,) * len(shape), to broadcast
    over the draws of each element."""
    return param.reshape(tuple(param.shape) + (1,) * len(shape))


def _expanded(param, shape, dtype=None):
    """``param`` broadcast to param.shape + shape (contiguous, ``dtype``)."""
    out = _per_element(param, shape).expand(tuple(param.shape) + shape)
    return out.to(dtype or param.dtype).contiguous()


@register("_sample_uniform", aliases=["sample_uniform"], needs_rng=True,
          differentiable=False)
def _sample_uniform(low, high, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    u = torch.empty(tuple(low.shape) + s, dtype=_dt(dtype),
                    device=low.device).uniform_(generator=rng)
    return _per_element(low, s) + u * _per_element(high - low, s)


@register("_sample_normal", aliases=["sample_normal"], needs_rng=True,
          differentiable=False)
def _sample_normal(mu, sigma, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    z = torch.empty(tuple(mu.shape) + s, dtype=_dt(dtype),
                    device=mu.device).normal_(generator=rng)
    return _per_element(mu, s) + z * _per_element(sigma, s)


@register("_sample_gamma", aliases=["sample_gamma"], needs_rng=True,
          differentiable=False)
def _sample_gamma(alpha, beta, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    g = standard_gamma(_expanded(alpha, s, _dt(dtype)), rng)
    return g * _per_element(beta, s)


@register("_sample_exponential", aliases=["sample_exponential"],
          needs_rng=True, differentiable=False)
def _sample_exponential(lam, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    e = torch.empty(tuple(lam.shape) + s, dtype=_dt(dtype),
                    device=lam.device).exponential_(1.0, generator=rng)
    return e / _per_element(lam, s)


@register("_sample_poisson", aliases=["sample_poisson"], needs_rng=True,
          differentiable=False)
def _sample_poisson(lam, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    lam_f = _expanded(lam, s, torch.promote_types(lam.dtype, torch.float32))
    return poisson(lam_f, rng).to(_dt(dtype))


@register("_sample_negative_binomial", aliases=["sample_negative_binomial"],
          needs_rng=True, differentiable=False)
def _sample_negative_binomial(k, p, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    return neg_binomial(_expanded(k, s, torch.float32), _expanded(p, s),
                        rng).to(_dt(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=["sample_generalized_negative_binomial"], needs_rng=True,
          differentiable=False)
def _sample_gen_neg_binomial(mu, alpha, shape=(), dtype="float32", rng=None):
    s = _shape(shape) if shape else ()
    a = _expanded(alpha, s, torch.float32).clamp_min(1e-12)
    lam = standard_gamma(1.0 / a, rng) * (_expanded(mu, s) * a)
    return poisson(lam, rng).to(_dt(dtype))


@register("_sample_multinomial", aliases=["sample_multinomial"],
          needs_rng=True, differentiable=False,
          num_outputs=lambda a: 2 if a.get("get_prob") else 1)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        rng=None):
    """Draws from the categorical distributions of ``data``'s last axis
    (entries at or below 1e-30 count as 1e-30, as the JAX package's log
    of them): data.shape[:-1] + shape; with ``get_prob`` also each draw's
    log-probability."""
    s = _shape(shape) if shape else ()
    n = max(math.prod(s), 1)
    k = data.shape[-1]
    probs = data.reshape(-1, k).clamp_min(1e-30)
    if data.device.type == "meta":
        samp = torch.empty(probs.shape[0], n, dtype=torch.int64,
                           device=data.device)
    else:
        samp = torch.multinomial(probs, n, replacement=True, generator=rng)
    out_shape = tuple(data.shape[:-1]) + s
    out = samp.reshape(out_shape).to(_dt(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(probs), dim=-1).gather(1, samp)
    return out, logp.reshape(out_shape)


@register("_shuffle", aliases=["shuffle"], needs_rng=True,
          differentiable=False)
def _shuffle(data, rng=None):
    """``data``'s rows in a random order."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=rng, device=data.device)
    return data[perm]

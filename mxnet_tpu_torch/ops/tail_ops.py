"""The op-name tail: gradient-accumulation helpers, the ``_scatter_*``
arithmetic, the ``*_like`` random samplers, the unique Zipfian candidate
sampler, ``_contrib_div_sqrt_dim`` and the image ops.

Counterpart of ``mxnet_tpu/ops/tail_ops.py`` (reference
``elemwise_binary_op_basic.cc`` ``_grad_add``, ``square_sum.cc``,
``elemwise_scatter_op.cc``, ``random/sample_op.cc`` ``_random_*_like``,
``random/unique_sample_op.cc``, ``contrib/transformer.cc``,
``image/image_random.cc``). The ``_scatter_*`` ops are dense arithmetic
over the same buffer, as in the JAX package; a ``*_like`` sampler draws
the input's shape in the input's dtype from the generator passed as
``rng``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .random_ops import neg_binomial, poisson, standard_gamma
from .registry import register


@register("_grad_add")
def _grad_add(lhs, rhs):
    """The addition of ``grad_req="add"`` accumulation."""
    return lhs + rhs


@register("_square_sum")
def _square_sum(data, axis=None, keepdims=False):
    if axis is None:
        out = data.square().sum()
        return out.reshape((1,) * data.ndim) if keepdims else out
    axes = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)
    return data.square().sum(dim=axes, keepdim=bool(keepdims))


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


@register("_scatter_plus_scalar")
def _scatter_plus_scalar(data, scalar=0.0):
    return data + scalar


@register("_scatter_minus_scalar")
def _scatter_minus_scalar(data, scalar=0.0):
    return data - scalar


# ------------------------------------------------- the *_like samplers
@register("_random_uniform_like", needs_rng=True, differentiable=False)
def _uniform_like(data, low=0.0, high=1.0, rng=None):
    return torch.empty_like(data).uniform_(float(low), float(high),
                                           generator=rng)


@register("_random_normal_like", needs_rng=True, differentiable=False)
def _normal_like(data, loc=0.0, scale=1.0, rng=None):
    return torch.empty_like(data).normal_(float(loc), float(scale),
                                          generator=rng)


@register("_random_gamma_like", needs_rng=True, differentiable=False)
def _gamma_like(data, alpha=1.0, beta=1.0, rng=None):
    a = torch.full(data.shape, float(alpha), device=data.device)
    return (standard_gamma(a, rng) * beta).to(data.dtype)


@register("_random_exponential_like", needs_rng=True, differentiable=False)
def _exponential_like(data, lam=1.0, rng=None):
    return torch.empty_like(data).exponential_(1.0, generator=rng) / lam


@register("_random_poisson_like", needs_rng=True, differentiable=False)
def _poisson_like(data, lam=1.0, rng=None):
    lam_t = torch.full(data.shape, float(lam), device=data.device)
    return poisson(lam_t, rng).to(data.dtype)


@register("_random_negative_binomial_like", needs_rng=True,
          differentiable=False)
def _neg_binomial_like(data, k=1, p=1.0, rng=None):
    k_t = torch.full(data.shape, float(k), device=data.device)
    return neg_binomial(k_t, float(p), rng).to(data.dtype)


@register("_random_generalized_negative_binomial_like", needs_rng=True,
          differentiable=False)
def _gen_neg_binomial_like(data, mu=1.0, alpha=1.0, rng=None):
    """NB(1/alpha, (1/alpha) / (1/alpha + mu)), the JAX file's form."""
    k = 1.0 / float(alpha)
    k_t = torch.full(data.shape, k, device=data.device)
    return neg_binomial(k_t, k / (k + float(mu)), rng).to(data.dtype)


# --------------------------------------------------- candidate sampling
def _zipfian_rows(seed, n_rows, n_col, range_max):
    """The host sampler: ``n_col`` distinct ids a row from
    P(k) = log1p(1/(k+1)) / log(range_max + 1), and each row's raw draws
    (the JAX file's loop, from a numpy stream seeded by ``seed``)."""
    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    out = np.empty((n_rows, n_col), dtype=np.int32)
    tries = np.empty((n_rows,), dtype=np.int32)
    log_range = np.log(range_max + 1.0)
    for r in range(n_rows):
        seen, seen_set, t = [], set(), 0
        while len(seen) < n_col:
            draws = np.minimum(np.exp(rs.uniform(size=n_col) * log_range)
                               .astype(np.int64) - 1, range_max - 1)
            for d in draws:
                if len(seen) >= n_col:
                    break
                t += 1
                if int(d) not in seen_set:
                    seen_set.add(int(d))
                    seen.append(int(d))
        out[r] = seen
        tries[r] = t
    return out, tries


@register("_sample_unique_zipfian", num_outputs=2, needs_rng=True,
          differentiable=False, host=True)
def _sample_unique_zipfian(range_max=1, shape=(1,), rng=None, device=None):
    """Unique log-uniform (Zipfian) candidates: ``(samples, num_tries)``,
    ``shape[-1]`` distinct ids a row and the raw draws each row took
    (reference ``unique_sample_op.cc``, a CPU-only kernel). Rejection has
    no fixed shape, so this is a host op: one seed is drawn from ``rng``
    and numpy samples the rows."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)
    n_rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
    n_col, range_max = shape[-1], int(range_max)
    if range_max < n_col:
        raise MXNetError(f"_sample_unique_zipfian: cannot draw {n_col} unique "
                         f"ids from range_max={range_max} (reference "
                         f"unique_sample_op.cc CHECKs the same precondition)")
    gen_dev = rng.device if rng is not None else "cpu"
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                             device=gen_dev).item())
    samples, tries = _zipfian_rows(seed, n_rows, n_col, range_max)
    return (torch.from_numpy(samples.reshape(shape)).to(device),
            torch.from_numpy(tries.reshape(shape[:-1] or (1,))).to(device))


# ------------------------------------------------ transformer / image
@register("_contrib_div_sqrt_dim", aliases=["contrib_div_sqrt_dim"])
def _div_sqrt_dim(data):
    """Attention logits scaled by 1/sqrt(d) (``contrib/transformer.cc``)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


@register("_image_to_tensor", aliases=["image_to_tensor"])
def _image_to_tensor(data):
    """HWC (or NHWC) [0, 255] to CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    if x.ndim == 3:
        return x.permute(2, 0, 1)
    if x.ndim == 4:
        return x.permute(0, 3, 1, 2)
    return x


@register("_image_normalize", aliases=["image_normalize"])
def _image_normalize(data, mean=0.0, std=1.0):
    """Channelwise (x - mean) / std over CHW / NCHW float images."""
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    if mean.ndim == 1:
        mean = mean.reshape(-1, 1, 1)
    if std.ndim == 1:
        std = std.reshape(-1, 1, 1)
    return (data - mean) / std

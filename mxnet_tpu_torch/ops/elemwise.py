"""Elementwise unary, binary and scalar ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` (reference
``src/operator/tensor/elemwise_unary_op_basic.cc``,
``elemwise_binary_op*.cc``, ``elemwise_binary_scalar_op*.cc`` and
``src/operator/mshadow_op.h``): every op it registers, in plain torch on
the tensor's device.

The gradients are the JAX package's where torch's differ: ``abs`` passes
the head gradient at 0 (``jnp.abs``: ``x >= 0``), and a tie of
``maximum``/``minimum`` (and of ``clip`` and ``hard_sigmoid`` at a bound)
splits the gradient half and half. ``gamma`` is ``exp(lgamma(x))`` as in
the JAX package, so it loses the sign of Γ at negative non-integers
(``gamma(-0.5)`` is +3.545, where Γ(−0.5) = −3.545). The rounding ops and
``logical_not`` carry no gradient.
"""
from __future__ import annotations

import torch

from .registry import register


class _Abs(torch.autograd.Function):
    """``|x|`` whose gradient is ``g`` where ``x >= 0`` and ``−g`` below,
    as ``jnp.abs``'s (torch's gives 0 at 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _cbrt(x):
    """The real cube root (torch has no ``cbrt``)."""
    return torch.abs(x).pow(1.0 / 3.0).copysign(x)


def _unary(name, fn, differentiable=True, aliases=()):
    register(name, differentiable=differentiable, aliases=aliases,
             arg_names=("data",))(lambda data, _fn=fn: _fn(data))


def _no_grad(fn):
    """``fn`` cut from the graph: the JAX package registers it as not
    differentiable."""
    return lambda x: fn(x.detach())


_unary("abs", _Abs.apply)
_unary("sign", torch.sign)
_unary("negative", torch.neg)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("floor", _no_grad(torch.floor), differentiable=False)
_unary("ceil", _no_grad(torch.ceil), differentiable=False)
_unary("round", _no_grad(torch.round), differentiable=False)   # half even
_unary("rint", _no_grad(torch.round), differentiable=False)
_unary("trunc", _no_grad(torch.trunc), differentiable=False)
_unary("fix", _no_grad(torch.trunc), differentiable=False)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("digamma", torch.digamma)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (1.0 + _Abs.apply(x)))
_unary("relu", torch.relu)
_unary("logical_not", _no_grad(lambda x: (x == 0).to(x.dtype)),
       differentiable=False)


def _clamp(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, a bound of None
    leaving that side open; a tie with a bound splits the gradient."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), float(lo)))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), float(hi)))
    return x


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    return _clamp(float(alpha) * x + float(beta), 0.0, 1.0)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    return _clamp(x, a_min, a_max)


register("identity", aliases=["_copy"])(lambda x: x)
register("BlockGrad", aliases=["stop_gradient"])(lambda x: x.detach())
# marks an output as a loss head; the graph seeds its gradient with ones
register("make_loss")(lambda x: x)


def _cast(x, dtype="float32"):
    from ..ndarray.ndarray import torch_dtype
    return x.to(torch_dtype(dtype))


register("Cast", aliases=["cast"])(_cast)
register("amp_cast")(_cast)


@register("amp_multicast",
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def _amp_multicast(*xs, num_outputs=1):
    """Every input in the widest of their types."""
    wide = xs[0].dtype
    for x in xs[1:]:
        wide = torch.promote_types(wide, x.dtype)
    return tuple(x.to(wide) for x in xs)


# ---- binary (numpy broadcasting, a superset of MXNet's same-shape rule) ---
def _binary(name, fn, aliases=()):
    register(name, aliases=aliases, arg_names=("lhs", "rhs"))(
        lambda lhs, rhs, _fn=fn: _fn(lhs, rhs))


_binary("elemwise_add", torch.add, aliases=["_plus", "_add"])
_binary("elemwise_sub", torch.sub, aliases=["_minus", "_sub"])
_binary("elemwise_mul", torch.mul, aliases=["_mul"])
_binary("elemwise_div", torch.div, aliases=["_div"])
_binary("_power", torch.pow, aliases=["pow"])
_binary("_maximum", torch.maximum)
_binary("_minimum", torch.minimum)
_binary("_hypot", torch.hypot)
_binary("_mod", torch.remainder, aliases=["mod"])   # the divisor's sign


@register("add_n", aliases=["ElementWiseSum", "_sum"])
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _cmp(name, fn):
    """A comparison in the left operand's dtype (1 or 0), no gradient."""
    register(name, differentiable=False, arg_names=("lhs", "rhs"))(
        lambda lhs, rhs, _fn=fn: _fn(lhs.detach(), rhs.detach()).to(
            lhs.dtype))


def _logical(fn):
    return lambda lhs, rhs: fn(lhs != 0, rhs != 0)


_cmp("_equal", torch.eq)
_cmp("_not_equal", torch.ne)
_cmp("_greater", torch.gt)
_cmp("_greater_equal", torch.ge)
_cmp("_lesser", torch.lt)
_cmp("_lesser_equal", torch.le)
_cmp("_logical_and", _logical(torch.logical_and))
_cmp("_logical_or", _logical(torch.logical_or))
_cmp("_logical_xor", _logical(torch.logical_xor))


# ---- scalar ops (attr ``scalar``) -----------------------------------------
def _scalar_op(name, fn):
    register(name)(lambda x, scalar=0.0, _fn=fn: _fn(x, float(scalar)))


def _like(x, s):
    """``s`` as a 0-d tensor filled on ``x``'s device (no host copy), in
    the type ``x`` and a Python scalar promote to."""
    return x.new_full((), s, dtype=torch.result_type(x, s))


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(x, _like(x, s)))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(x, _like(x, s)))
_scalar_op("_mod_scalar", lambda x, s: torch.remainder(x, s))
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(
    torch.full_like(x, s), x))
_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(x, _like(x, s)))


def _cmp_scalar(name, fn):
    """A comparison with the scalar, in ``x``'s dtype (1 or 0)."""
    register(name, differentiable=False)(
        lambda x, scalar=0.0, _fn=fn: _fn(x.detach(), float(scalar)).to(
            x.dtype))


def _logical_scalar(fn):
    return lambda x, s: fn(x != 0, _like(x, float(s != 0)) != 0)


_cmp_scalar("_equal_scalar", torch.eq)
_cmp_scalar("_not_equal_scalar", torch.ne)
_cmp_scalar("_greater_scalar", torch.gt)
_cmp_scalar("_greater_equal_scalar", torch.ge)
_cmp_scalar("_lesser_scalar", torch.lt)
_cmp_scalar("_lesser_equal_scalar", torch.le)
_cmp_scalar("_logical_and_scalar", _logical_scalar(torch.logical_and))
_cmp_scalar("_logical_or_scalar", _logical_scalar(torch.logical_or))
_cmp_scalar("_logical_xor_scalar", _logical_scalar(torch.logical_xor))


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    """``0.5·σ²·x²`` where ``|x| < 1/σ²``, else ``|x| − 0.5/σ²``."""
    s2 = float(scalar) * float(scalar)
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x,
                       torch.abs(x) - 0.5 / s2)

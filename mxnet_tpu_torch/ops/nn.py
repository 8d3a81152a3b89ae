"""Neural-network ops of the LM and its loss.

Counterpart of ``FullyConnected``, ``LayerNorm``, ``Activation``,
``Dropout``, ``log_softmax``, ``softmax_cross_entropy`` and
``_contrib_flash_attention`` in ``mxnet_tpu/ops/nn.py`` (reference
``src/operator/nn/``, ``src/operator/loss_binary_op.cc``). Matrix products
go to ``torch`` (cuBLAS on the card, in full float32: TF32 stays off);
attention and the fused cross-entropy go to the hand-written Hopper
kernels in :mod:`.hopper_kernels`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected", arg_names=("data", "weight", "bias"))
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    """out = X·Wᵀ + b, weight (num_hidden, input_dim); with
    ``flatten=False`` a 3-D input keeps its leading axes."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register("LayerNorm", num_outputs=3, arg_names=("data", "gamma", "beta"))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """One-pass statistics in float32: var = E[x²] − E[x]², clamped at 0.
    Outputs (out, mean, var) like the JAX package."""
    ax = int(axis) % data.ndim
    xf = data.float()
    mean = xf.mean(dim=ax, keepdim=True)
    var = ((xf * xf).mean(dim=ax, keepdim=True) - mean * mean).clamp_min(0.0)
    shape = [data.shape[ax] if i == ax else 1 for i in range(data.ndim)]
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(data.dtype) \
        * gamma.reshape(shape) + beta.reshape(shape)
    return (out, mean.squeeze(ax).to(data.dtype),
            var.squeeze(ax).to(data.dtype))


@register("Activation", arg_names=("data",))
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1.0 + data.abs())
    raise MXNetError(f"bad act_type {act_type}")


@register("Dropout", needs_rng=True, arg_names=("data",))
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             rng=None, is_train=True):
    """Identity at inference; in training mode a Bernoulli keep-mask drawn
    from the ``torch.Generator`` passed as ``rng``, scaled by 1/keep."""
    if (not is_train and mode != "always") or p <= 0.0 or rng is None:
        return data
    shape = list(data.shape)
    for ax in (axes or ()):
        shape[int(ax)] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device)
    mask.bernoulli_(keep, generator=rng)
    return data * (mask / keep)


@register("_contrib_flash_attention", aliases=["contrib_flash_attention"],
          arg_names=("query", "key", "value"))
def _flash_attention_op(query, key, value, causal=False, scale=None,
                        q_offset=0, k_offset=0):
    """Flash attention on (B, H, T, D); the Hopper kernel on the card."""
    from .hopper_kernels import flash_attention
    return flash_attention(query, key, value, causal=bool(causal),
                           scale=None if scale is None else float(scale),
                           q_offset=int(q_offset), k_offset=int(k_offset))


@register("log_softmax", arg_names=("data",))
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    from ..ndarray.ndarray import torch_dtype
    x = data / temperature if temperature else data
    out = torch.log_softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("softmax_cross_entropy", arg_names=("data", "label"))
def _softmax_cross_entropy(data, label):
    """Total softmax CE over the batch, shape (1,) (reference
    ``loss_binary_op.cc``: out = Σ_i CE(row_i)); the per-row CE is the
    fused Hopper kernel on the card, its gradient ``(softmax − onehot)·g``."""
    from .hopper_kernels import softmax_cross_entropy
    return softmax_cross_entropy(data, label.reshape(-1)).sum().reshape(1)

"""Neural-network ops of the LM, its losses and the symbolic heads.

Counterpart of ``FullyConnected``, ``LayerNorm``, ``BatchNorm``,
``Activation``, ``Dropout``, ``log_softmax``, ``softmax_cross_entropy``,
``SoftmaxOutput`` and ``_contrib_flash_attention`` in
``mxnet_tpu/ops/nn.py``, and ``MakeLoss`` in ``mxnet_tpu/ops/parity_ops.py``
(reference ``src/operator/nn/``, ``src/operator/loss_binary_op.cc``,
``softmax_output.cc``, ``make_loss.cc``). Matrix products
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
    ``flatten=False`` a 3-D input keeps its leading axes. Mixed input
    types promote as the JAX op's ``jnp.dot(X, Wᵀ) + b`` promotes them:
    the product in the type of X and W (bf16 data on a float32 weight runs
    in float32), then a bias of another type promotes the sum."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    bias = None if no_bias else bias
    dt = torch.promote_types(data.dtype, weight.dtype)
    data, weight = data.to(dt), weight.to(dt)
    if bias is None or bias.dtype == dt:
        return F.linear(data, weight, bias)
    return F.linear(data, weight) + bias


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


# ------------------------------------------------------------ symbolic heads
# The ops below carry the reference's own backward rules, each a
# ``torch.autograd.Function`` in plain torch (none is a TPU kernel).

@register("BatchNorm", num_outputs=3,
          arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
          aux_args=("moving_mean", "moving_var"))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                is_train=True):
    """Batch statistics in training (one float32 pass: ``var = E[x²] −
    E[x]²`` clamped at 0, the biased variance), the moving ones otherwise
    or under ``use_global_stats``; ``fix_gamma`` scales by 1 (gamma gets
    no gradient). Outputs (out, mean, var) like the JAX package; the
    executor folds mean and var into the moving statistics
    (``executor._bn_aux_update``)."""
    ax = int(axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    bshape = [data.shape[ax] if i == ax else 1 for i in range(data.ndim)]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if is_train and not use_global_stats:
        xf = data.float()
        mean = xf.mean(dim=red)
        var = ((xf * xf).mean(dim=red) - mean * mean).clamp_min(0.0)
    else:
        mean, var = moving_mean.float(), moving_var.float()
    scale = torch.rsqrt(var + eps) * g.float()
    shift = beta.float() - mean * scale
    out = data * scale.to(data.dtype).reshape(bshape) \
        + shift.to(data.dtype).reshape(bshape)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient and emits
    ``(p − onehot(label))·scale`` (reference ``softmax_output.cc``)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        multi = attrs["multi_output"]
        out = torch.softmax(data, dim=1) if multi else torch.softmax(
            data.reshape(data.shape[0], -1), dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        lab = label.to(torch.int64)
        if a["multi_output"]:            # data (N, C, ...), label (N, ...)
            oh = F.one_hot(lab, out.shape[1]).movedim(-1, 1).to(out.dtype)
        else:
            flat = out.reshape(out.shape[0], -1)
            oh = F.one_hot(lab.reshape(-1), flat.shape[-1]).to(
                out.dtype).reshape(out.shape)
        alpha = a["smooth_alpha"]
        if alpha:
            k = oh.shape[1] if a["multi_output"] else \
                oh.reshape(oh.shape[0], -1).shape[-1]
            oh = oh * (1.0 - alpha) + alpha / (k - 1) * (1.0 - oh)
        grad = out - oh
        keep = label != a["ignore_label"]
        if a["use_ignore"]:
            mask = keep.to(out.dtype)
            mask = mask.unsqueeze(1) if a["multi_output"] else \
                mask.reshape((-1,) + (1,) * (out.ndim - 1))
            grad = grad * mask
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / out.shape[0]
        elif a["normalization"] == "valid" and a["use_ignore"]:
            grad = grad / keep.to(out.dtype).sum().clamp_min(1.0)
        return grad * scale, torch.zeros_like(label), None


@register("SoftmaxOutput", aliases=["Softmax"], arg_names=("data", "label"))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Softmax with the implicit cross-entropy gradient: the head gradient
    is ignored, ``(p − onehot)·grad_scale`` flows back, normalised by
    ``batch`` or by the ``valid`` (not ignored) labels."""
    return _SoftmaxOutput.apply(data, label, {
        "grad_scale": float(grad_scale), "ignore_label": float(ignore_label),
        "multi_output": bool(multi_output), "use_ignore": bool(use_ignore),
        "normalization": str(normalization),
        "smooth_alpha": float(smooth_alpha)})


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and emits
    ``grad_scale`` (reference ``make_loss.cc``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        # the loss itself is kept only where its values set the scale
        if normalization == "valid":
            ctx.save_for_backward(data)
        ctx.like = torch.empty_like(data, device="meta")
        ctx.attrs = (grad_scale, valid_thresh, normalization)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        # built on the device (a fill, no copy from the host): a host
        # scalar copied in would wait for the whole forward to finish
        grad_scale, valid_thresh, normalization = ctx.attrs
        like = ctx.like
        if normalization == "batch":
            grad_scale /= like.shape[0]
        grad = torch.full(like.shape, grad_scale, dtype=like.dtype,
                          device=g.device)
        if normalization == "valid":
            (d,) = ctx.saved_tensors
            grad /= (d > valid_thresh).to(d.dtype).sum().clamp_min(1.0)
        return grad, None, None, None


@register("MakeLoss", arg_names=("data",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Marks a loss head: forward passes ``data`` through, backward emits
    ``grad_scale`` (normalised by ``valid`` elements or ``batch``) whatever
    the head gradient."""
    return _MakeLoss.apply(data, float(grad_scale), float(valid_thresh),
                           str(normalization))

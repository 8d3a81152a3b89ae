"""Reference op-name parity: the fused optimizer updates, legacy layer ops,
graph utilities and the contrib long tail.

Counterpart of ``mxnet_tpu/ops/parity_ops.py`` but for its four
``_contrib_quantized_*`` ops, which belong to the int8 family (reference
``src/operator/optimizer_op.cc``, ``crop.cc``,
``identity_attach_KL_sparse_reg.cc``, ``tensor/histogram.cc``,
``contrib/krprod.cc``, ``contrib/psroi_pooling.cc``,
``contrib/deformable_psroi_pooling.cc``, ``contrib/index_copy.cc``,
``contrib/quadratic_op.cc``, ``contrib/bounding_box.cc``,
``contrib/dgl_graph.cc``). ``MakeLoss`` of the same file is in
:mod:`.nn`.

The update ops are functional, as in the JAX package: a stateful rule
returns every tensor it changes, ``(weight, state...)``; pass
``out=[weight, state...]`` to update in place. They keep the JAX file's
arithmetic (MXNet's rule for each), which :mod:`..optimizer` also
follows.
"""
from __future__ import annotations

import torch

from .index import _scatter
from .registry import alias, register


# -------------------------------------------------- fused optimizer updates
def _clipped(g, clip):
    if clip is not None and clip > 0:
        return g.clamp(-clip, clip)
    return g


def _prep_grad(grad, weight, rescale_grad, clip_gradient, wd):
    return _clipped(grad * rescale_grad, clip_gradient) + wd * weight


@register("sgd_update", differentiable=False)
def _sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    return weight - lr * _prep_grad(grad, weight, rescale_grad,
                                    clip_gradient, wd)


@register("sgd_mom_update", num_outputs=2, differentiable=False)
def _sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("mp_sgd_update", num_outputs=2, differentiable=False)
def _mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """Multi-precision: float32 master weights, a low-precision copy."""
    g = _prep_grad(grad.to(torch.float32), weight32, rescale_grad,
                   clip_gradient, wd)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3, differentiable=False)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad.to(torch.float32), weight32, rescale_grad,
                   clip_gradient, wd)
    mom = momentum * mom - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register("adam_update", num_outputs=3, differentiable=False)
def _adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    mean = beta1 * mean + (1.0 - beta1) * g
    var = beta2 * var + (1.0 - beta2) * g * g
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


@register("ftrl_update", num_outputs=3, differentiable=False)
def _ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _clipped(grad * rescale_grad, clip_gradient)
    n_new = n + g * g
    z_new = z + g - (torch.sqrt(n_new) - torch.sqrt(n)) / lr * weight
    w = torch.where(z_new.abs() <= lamda1, torch.zeros_like(weight),
                    -(z_new - torch.sign(z_new) * lamda1)
                    / ((beta + torch.sqrt(n_new)) / lr + wd))
    return w, z_new, n_new


@register("ftml_update", num_outputs=4, differentiable=False)
def _ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _clipped(grad * rescale_grad + wd * weight, clip_grad)
    v_new = beta2 * v + (1.0 - beta2) * g * g
    d_new = (1.0 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1.0 - beta2 ** t)) + epsilon)
    z_new = beta1 * z + (1.0 - beta1) * g - (d_new - beta1 * d) * weight
    return -z_new / d_new, d_new, v_new, z_new


@register("rmsprop_update", num_outputs=2, differentiable=False)
def _rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1.0 - gamma1) * g * g
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    return _clipped(w, clip_weights), n_new


@register("rmspropalex_update", num_outputs=4, differentiable=False)
def _rmspropalex_update(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1.0 - gamma1) * g * g
    g_new = gamma1 * g_avg + (1.0 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(n_new - g_new * g_new
                                                     + epsilon)
    return (_clipped(weight + delta_new, clip_weights), n_new, g_new,
            delta_new)


@register("signsgd_update", differentiable=False)
def _signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _clipped(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2, differentiable=False)
def _signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clipped(grad * rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    return (1.0 - lr * wd_lh) * weight + lr * torch.sign(mom_new), mom_new


@register("_contrib_adamw_update", aliases=["adamw_update"], num_outputs=3,
          differentiable=False,
          arg_names=("weight", "grad", "mean", "var", "rescale_grad"))
def _adamw_update(weight, grad, mean, var, rescale_grad, lr, beta1=0.9,
                  beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  clip_gradient=-1.0):
    """AdamW: decoupled weight decay; ``rescale_grad`` is a tensor input,
    so that a global-norm scale can feed it (reference contrib/adamw.cc)."""
    g = _clipped(grad * rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1.0 - beta1) * g
    var_new = beta2 * var + (1.0 - beta2) * g * g
    w = weight - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                        + wd * weight)
    return w, mean_new, var_new


@register("_contrib_group_adagrad_update",
          aliases=["group_adagrad_update", "_sparse_adagrad_update"],
          num_outputs=2, differentiable=False)
def _group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """Per-row (group) AdaGrad: the history keeps each row's mean squared
    gradient, in its own (rows,) or (rows, 1) shape."""
    g = _clipped(grad * rescale_grad, clip_gradient)
    if g.ndim > 1:
        mean_sq = (g * g).mean(dim=tuple(range(1, g.ndim)))
        h_new = history + mean_sq.reshape(history.shape)
        scale = h_new.reshape((-1,) + (1,) * (g.ndim - 1))
    else:
        h_new = history + g * g
        scale = h_new
    return weight - lr * g / (torch.sqrt(scale) + epsilon), h_new


@register("multi_sum_sq", num_outputs=lambda a: int(a.get("num_arrays", 1)),
          differentiable=False)
def _multi_sum_sq(*arrays, num_arrays=1):
    """Each array's sum of squares in float32 (``multi_sum_sq.cc``)."""
    return tuple(a.to(torch.float32).square().sum() for a in arrays)


# ------------------------------------------------------- legacy layer ops
@register("Crop", arg_names=("data",))
def _legacy_crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
                 num_args=1):
    """NCHW ``data`` cropped to ``h_w`` (or to the second input's spatial
    size) at ``offset``, or centred (reference ``crop.cc``)."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        y0, x0 = (data.shape[2] - th) // 2, (data.shape[3] - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds the KL sparseness penalty's
    gradient, from the batch's mean activation."""

    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(data)
        ctx.target, ctx.penalty = target, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        s = torch.sigmoid(d)
        rho_hat = s.mean(0).clamp(1e-6, 1.0 - 1e-6)
        rho = ctx.target
        kl = ctx.penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl * s * (1 - s), None, None


@register("IdentityAttachKLSparseReg", arg_names=("data",))
def _identity_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                            momentum=0.9):
    """Identity forward; the backward adds the KL sparseness penalty
    (``identity_attach_KL_sparse_reg.cc``). As in the JAX package the mean
    activation is the current batch's (the reference keeps a momentum-
    smoothed running mean as op state; ``momentum`` is unused)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


# -------------------------------------------- graph-builder / utilities
@register("cast_storage")
def _cast_storage(data, stype="default"):
    """Storage-type cast: dense tensors are the only storage here, so the
    identity."""
    return data


@register("_histogram", aliases=["histogram"], num_outputs=2,
          differentiable=False, arg_names=("data",))
def _histogram_op(data, bin_cnt=10, range=None):
    """(int64 counts of ``bin_cnt`` equal bins, their edges) over
    ``range`` or the data's min and max; samples outside the range are
    dropped and the top edge falls in the last bin (numpy's rule). The
    edges are float64 for a given ``range`` and the data's dtype
    otherwise, as the JAX package (64-bit types on) returns them."""
    bins = int(bin_cnt)
    if range:
        lo, hi = float(range[0]), float(range[1])
        edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                               device=data.device)
        span = max(hi - lo, 1e-30)
    else:
        lo, hi = data.min(), data.max()
        steps = torch.arange(bins + 1, dtype=data.dtype, device=data.device)
        edges = lo + steps * ((hi - lo) / bins)
        edges[-1] = hi
        span = (hi - lo).clamp_min(1e-30)
    flat = data.reshape(-1)
    pos = (flat - lo) / span * bins
    inside = (pos >= 0) & (pos <= bins)
    idx = pos.to(torch.int64).clamp(0, bins - 1)
    hist = torch.zeros(bins, dtype=torch.int64, device=data.device)
    return hist.index_add(0, idx, inside.to(torch.int64)), edges


@register("khatri_rao", arg_names=None)
def _khatri_rao(*mats):
    """Column-wise Kronecker product (``contrib/krprod.cc``)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


def _slices(begin, end, step):
    step = tuple(step) if step else (None,) * len(begin)
    return tuple(slice(b, e, s or None) for b, e, s in zip(begin, end, step))


@register("_slice_assign")
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with ``rhs`` written into ``lhs[begin:end:step]``."""
    out = lhs.clone()
    out[_slices(begin, end, step)] = rhs
    return out


@register("_slice_assign_scalar")
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_slices(begin, end, step)] = scalar
    return out


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("_zeros_without_dtype", differentiable=False)
def _zeros_without_dtype(shape=(), device=None):
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


@register("_rnn_param_concat", arg_names=None)
def _rnn_param_concat(*arrays, dim=0, num_args=None):
    """The RNN op's flat parameter vector (``dim=0`` flattens each
    array), or a concatenation along ``dim``."""
    if dim == 0:
        return torch.cat([a.reshape(-1) for a in arrays])
    return torch.cat(arrays, dim=int(dim))


@register("_CrossDeviceCopy", differentiable=False)
def _cross_device_copy(data):
    """The executor's cross-device copy: the identity (an op's inputs are
    on one device here)."""
    return data


@register("_sparse_retain", aliases=["sparse_retain"], differentiable=False)
def _sparse_retain_op(data, indices):
    """The rows in ``indices`` kept, the rest zeroed (the dense form of
    ``sparse_retain.cc``)."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.ndim - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


# ----------------------------------------------------- contrib long tail
@register("_contrib_quadratic", aliases=["quadratic"])
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("_contrib_index_copy", aliases=["index_copy"],
          differentiable=False)
def _index_copy(old, idx, new):
    """``old`` with the rows ``idx`` replaced by ``new``'s rows (an
    out-of-range row dropped, as JAX's ``.at[].set``; with repeated
    indices one write is kept, which one is unspecified)."""
    return _scatter(old, idx.reshape(1, -1), new)


@register("_contrib_edge_id", aliases=["edge_id"], differentiable=False)
def _edge_id(data, u, v):
    """The edge ids of the (u, v) pairs in a dense adjacency, -1 where the
    entry is 0 (no edge)."""
    vals = data[u.to(torch.int64), v.to(torch.int64)]
    return torch.where(vals == 0, torch.full_like(vals, -1.0), vals)


@register("_contrib_getnnz", aliases=["getnnz"], differentiable=False)
def _getnnz(data, axis=None):
    nz = data != 0
    return nz.sum() if axis is None else nz.sum(dim=int(axis))


@register("_contrib_bipartite_matching", aliases=["bipartite_matching"],
          num_outputs=2, differentiable=False)
def _bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy bipartite matching over (..., R, C) scores
    (``bounding_box.cc``): take the best (row, column) left, while it
    meets ``threshold``, and strike its row and column. Returns (each
    row's column, each column's row), -1 where unmatched, float32."""
    R, C = data.shape[-2], data.shape[-1]
    n_iter = min(R, C) if topk <= 0 else min(topk, min(R, C))
    s = (-data if is_ascend else data).reshape(-1, R, C).clone()
    thresh = -threshold if is_ascend else threshold
    B = s.shape[0]
    rows = torch.arange(B, device=data.device)
    rmatch = torch.full((B, R), -1.0, device=data.device)
    cmatch = torch.full((B, C), -1.0, device=data.device)
    for _ in range(n_iter):
        flat = s.reshape(B, -1).argmax(1)
        r, c = flat // C, flat % C
        ok = s[rows, r, c] >= thresh
        rmatch[rows, r] = torch.where(ok, c.to(rmatch.dtype),
                                      rmatch[rows, r])
        cmatch[rows, c] = torch.where(ok, r.to(cmatch.dtype),
                                      cmatch[rows, c])
        okb = ok.reshape(B, 1)
        s[rows, r, :] = torch.where(okb, float("-inf"), s[rows, r, :])
        s[rows, :, c] = torch.where(okb, float("-inf"), s[rows, :, c])
    lead = tuple(data.shape[:-2])
    return rmatch.reshape(lead + (R,)), cmatch.reshape(lead + (C,))


# ------------------------------------------------- the PSROI poolings
def _psroi_sample(data, rois, spatial_scale, output_dim, pooled_size,
                  group_size, trans=None, trans_std=0.0, part_size=0,
                  grid=2):
    """Shared core of [Deformable]PSROIPooling: channel c of bin (i, j)
    reads input channel ``(c·gs + gi)·gs + gj``, (gi, gj) the group cell
    of the bin, averaged over a grid × grid bilinear sample pattern of the
    bin (the JAX package's stand-in for the reference's average of whole
    cells). With ``trans`` each bin moves by ``trans_std`` × its class-0
    offsets (x in plane 0, y in plane 1) times the ROI's size. Only the
    channels each bin reads are sampled."""
    from .contrib_ops import _bilinear_gather, _grid_fractions
    ps = int(pooled_size) if not isinstance(pooled_size, (tuple, list)) \
        else int(pooled_size[0])
    gs = int(group_size) if group_size else ps
    grid = max(1, int(grid))
    od, r = int(output_dim), rois.shape[0]
    if data.device.type == "meta":
        return data.new_empty(r, od, ps, ps)
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - 0.5 for k in range(1, 5))
    roi_w = torch.maximum(x2 - x1, x1.new_tensor(0.1))
    roi_h = torch.maximum(y2 - y1, y1.new_tensor(0.1))
    frac = _grid_fractions(ps, grid, data.dtype, data.device)
    ys = y1[:, None, None] + frac * (roi_h / ps)[:, None, None]  # (R, ps, g)
    xs = x1[:, None, None] + frac * (roi_w / ps)[:, None, None]
    if trans is not None:
        pt = int(part_size) if part_size else ps
        t = trans.reshape(trans.shape[0], -1, 2, pt, pt)
        sel = torch.arange(ps, device=data.device) * pt // ps
        dx = t[:, 0, 0][:, sel][:, :, sel] * trans_std   # (R, ps, ps)
        dy = t[:, 0, 1][:, sel][:, :, sel] * trans_std
        ys = ys[:, :, None, :] + (dy * roi_h[:, None, None])[..., None]
        xs = xs[:, None, :, :] + (dx * roi_w[:, None, None])[..., None]
    else:
        ys = ys[:, :, None, :].expand(r, ps, ps, grid)
        xs = xs[:, None, :, :].expand(r, ps, ps, grid)
    shape = (r, ps, ps, grid, grid)
    cell = torch.arange(ps, device=data.device) * gs // ps
    chan = ((torch.arange(od, device=data.device) * gs)[None, None, :]
            + cell[:, None, None]) * gs + cell[None, :, None]  # (ps, ps, od)
    vals = _bilinear_gather(
        data, rois[:, 0].long()[:, None, None, None, None],
        ys[..., :, None].expand(shape), xs[..., None, :].expand(shape),
        chan=chan[:, :, None, None, :])          # (R, ps, ps, g, g, od)
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


@register("_contrib_PSROIPooling", aliases=["PSROIPooling"],
          arg_names=("data", "rois"))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=1, group_size=0):
    """Position-sensitive ROI pooling (contrib/psroi_pooling.cc); each bin
    averages a 2 × 2 bilinear sample grid."""
    return _psroi_sample(data, rois, spatial_scale, output_dim, pooled_size,
                         group_size)


@register("_contrib_DeformablePSROIPooling",
          aliases=["DeformablePSROIPooling"],
          arg_names=("data", "rois", "trans"))
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, pooled_size=1, group_size=0,
                              part_size=0, sample_per_part=2, trans_std=0.0,
                              no_trans=False):
    """Deformable position-sensitive ROI pooling
    (contrib/deformable_psroi_pooling.cc): ``sample_per_part`` sets each
    bin's sample grid; only class 0 of ``trans`` moves the bins."""
    return _psroi_sample(data, rois, spatial_scale, output_dim, pooled_size,
                         group_size,
                         trans=None if no_trans else trans,
                         trans_std=trans_std, part_size=part_size,
                         grid=sample_per_part)


# -------------------------------------------------------------- aliases
def _register_aliases():
    # the names the JAX registry gives to the same ops
    alias("BatchNorm", "_contrib_SyncBatchNorm", "SyncBatchNorm",
          "CuDNNBatchNorm", "BatchNorm_v1")
    alias("Convolution", "Convolution_v1")
    alias("Pooling", "Pooling_v1")
    alias("Embedding", "_contrib_SparseEmbedding")


_register_aliases()

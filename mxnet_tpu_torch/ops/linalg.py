"""Linear-algebra ops.

Counterpart of ``mxnet_tpu/ops/linalg.py`` (reference
``src/operator/tensor/la_op.cc``): ``gemm``, ``gemm2``, ``potrf``,
``potri``, ``trsm``, ``trmm``, ``syrk``, ``sumlogdiag``, ``extractdiag``,
``makediag``, ``extracttrian``, ``maketrian``, ``inverse``, ``det``,
``slogdet``, ``gelqf`` and ``syevd`` over the last two axes, batched over
the rest. The JAX package lowers them through XLA; here ``torch.linalg``
runs them (cuSOLVER and cuBLAS on the card). A triangular operand is read
from its ``lower`` (or upper) triangle only.

``gelqf`` returns ``(L, Q)`` with ``A = L Q`` and ``syevd`` ``(U, w)`` with
the eigenvectors as the rows of ``U`` (``A = Uᵀ diag(w) U``), as the JAX
package returns them; the signs of Q's and U's rows are the solver's.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm", aliases=["linalg_gemm"])
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_gemm2", aliases=["linalg_gemm2"])
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_potrf", aliases=["linalg_potrf"])
def _potrf(A, lower=True):
    """The Cholesky factor of a symmetric positive-definite ``A``."""
    L = torch.linalg.cholesky(A)
    return L if lower else _t(L)


@register("_linalg_potri", aliases=["linalg_potri"])
def _potri(A, lower=True):
    """The inverse of L Lᵀ (or Uᵀ U) from its triangular factor ``A``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv = torch.linalg.solve_triangular(A, eye, upper=not lower)
    return torch.matmul(_t(inv), inv) if lower else torch.matmul(inv, _t(inv))


@register("_linalg_trsm", aliases=["linalg_trsm"])
def _trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """X with op(A) X = alpha B (X op(A) with ``rightside``), op(A) = A or
    Aᵀ."""
    tri, upper = (_t(A), lower) if transpose else (A, not lower)
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper,
                                         left=not rightside)


@register("_linalg_trmm", aliases=["linalg_trmm"])
def _trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("_linalg_syrk", aliases=["linalg_syrk"])
def _syrk(A, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("_linalg_sumlogdiag", aliases=["linalg_sumlogdiag"])
def _sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_extractdiag", aliases=["linalg_extractdiag"])
def _extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=["linalg_makediag"])
def _makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset), dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    make = torch.tril_indices if lower else torch.triu_indices
    return make(n, n, int(offset), device=device)


@register("_linalg_extracttrian", aliases=["linalg_extracttrian"])
def _extracttrian(A, offset=0, lower=True):
    """The lower (upper) triangle from diagonal ``offset`` on, row by
    row."""
    rows, cols = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register("_linalg_maketrian", aliases=["linalg_maketrian"])
def _maketrian(A, offset=0, lower=True):
    """The inverse of ``extracttrian``: n from len = n0 (n0 + 1) / 2,
    n = n0 + |offset|."""
    n = (math.isqrt(8 * A.shape[-1] + 1) - 1) // 2 + abs(int(offset))
    rows, cols = _trian_indices(n, offset, lower, A.device)
    out = A.new_zeros(tuple(A.shape[:-1]) + (n, n))
    out[..., rows, cols] = A
    return out


@register("_linalg_inverse", aliases=["linalg_inverse"])
def _inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_det", aliases=["linalg_det"])
def _det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", aliases=["linalg_slogdet"], num_outputs=2)
def _slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("_linalg_gelqf", aliases=["linalg_gelqf"], num_outputs=2)
def _gelqf(A):
    """LQ as the transpose of the QR of Aᵀ: ``(L, Q)``."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_syevd", aliases=["linalg_syevd"], num_outputs=2)
def _syevd(A):
    """Eigenvectors (as rows) and ascending eigenvalues of a symmetric
    ``A``."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w

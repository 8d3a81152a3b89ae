"""Sparse NDArrays: ``row_sparse`` and ``csr`` storage.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference
``include/mxnet/ndarray.h:61-66`` storage types and
``python/mxnet/ndarray/sparse.py``): :class:`RowSparseNDArray`,
:class:`CSRNDArray`, their constructors, ``retain``, ``dot`` and
``add_n``. Every part of an array is a tensor on one device, and every
operation runs there: the CSR structure work that the JAX package does in
host numpy (sorting by (row, column), summing duplicates, pruning zeros,
intersecting patterns) runs here with ``torch.sort``/``unique``/
``searchsorted`` on the array's own device, and gives the JAX package's
entries in its order, with its pruning and its dtypes (int64 row ids,
int32 CSR ``indices`` and ``indptr``).

``CSRNDArray.dot`` runs ``csr · dense`` as a ``torch.sparse`` CSR product
(cuSPARSE's SpMM on the card) and ``csrᵀ · dense`` as a gather of the
dense rows and an ``index_add_`` into the columns (atomic adds on the
card, so its repeats need not be bitwise). Ops that need dense math
densify explicitly (``tostype('default')``), as in the JAX package.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import NDArray, torch_dtype

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "zeros", "empty", "retain", "dot"]


def _tensor(x, device: Optional[torch.device] = None,
            dtype=None) -> torch.Tensor:
    """An NDArray, tensor or array-like as a detached tensor: a tensor
    stays on its device unless ``device`` is given; host data goes to
    ``device``, else to the current context's."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if device is not None:
            t = t.to(device)
    else:
        a = np.asarray(x)
        t = torch.from_numpy(np.array(a, copy=True)).to(
            device if device is not None
            else current_context().torch_device())
    return t if dtype is None else t.to(torch_dtype(dtype))


def _device(ctx: Optional[Context], source=None) -> Optional[torch.device]:
    """``ctx``'s device; else that of a tensor ``source`` (None: the
    current context's, chosen by :func:`_tensor`)."""
    if ctx is not None:
        return Context(ctx).torch_device()
    if isinstance(source, NDArray):
        return source._data.device
    if isinstance(source, torch.Tensor):
        return source.device
    return None


class BaseSparseNDArray:
    @property
    def shape(self):
        return self._shape

    def norm(self) -> NDArray:
        """Frobenius norm over the stored values, in float32 (valid since
        the constructors and arithmetic keep indices duplicate-free)."""
        return NDArray(torch.sqrt(torch.sum(self._values.float() ** 2)))

    @property
    def dtype(self):
        return NDArray(self._values).dtype

    @property
    def context(self) -> Context:
        return Context.from_torch(self._values.device)

    def asnumpy(self) -> np.ndarray:
        return self.todense().asnumpy()

    def wait_to_read(self) -> None:
        NDArray(self._values).wait_to_read()

    def __repr__(self):
        return f"<{type(self).__name__} {'x'.join(map(str, self.shape))}>"


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` hold ``values``; every other row is zero
    (reference ``ndarray.h`` kRowSparseStorage)."""

    stype = "row_sparse"

    def __init__(self, values, indices, shape):
        self._values = _tensor(values)
        self._indices = _tensor(indices, self._values.device, "int64")
        self._shape = tuple(int(d) for d in shape)

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    def copy(self) -> "RowSparseNDArray":
        return RowSparseNDArray(self._values.clone(), self._indices.clone(),
                                self._shape)

    def todense(self) -> NDArray:
        out = torch.zeros(self._shape, dtype=self._values.dtype,
                          device=self._values.device)
        return NDArray(out.index_add_(0, self._indices, self._values))

    def tostype(self, stype: str):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"cannot convert row_sparse to {stype}")

    def retain(self, row_ids) -> "RowSparseNDArray":
        """The rows ``row_ids``, in that order, under those ids; a row not
        stored comes back as zeros (reference ``sparse_retain``). Gathers
        only the requested rows: the array is never densified."""
        rid = _tensor(row_ids, self._values.device, "int64").reshape(-1)
        tail = self._values.shape[1:]
        if self._indices.numel() == 0:
            return RowSparseNDArray(
                self._values.new_zeros((rid.numel(),) + tail), rid,
                self._shape)
        # the (values, indices) constructor allows unsorted indices: a
        # stable sort, then the first stored copy of each requested row
        sorted_idx, order = torch.sort(self._indices, stable=True)
        pos = torch.searchsorted(sorted_idx, rid).clamp_(
            0, sorted_idx.numel() - 1)
        present = (sorted_idx[pos] == rid).reshape((-1,) + (1,) * len(tail))
        vals = torch.where(present, self._values[order[pos]],
                           self._values.new_zeros(()))
        return RowSparseNDArray(vals, rid, self._shape)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            # rows present in both are summed into one stored row (a raw
            # concatenation would leave duplicate indices behind)
            if other._shape != self._shape:
                raise MXNetError(f"shape mismatch {self._shape} vs "
                                 f"{other._shape}")
            idx = torch.cat([self._indices,
                             other._indices.to(self._indices.device)])
            vals = torch.cat([self._values,
                              other._values.to(self._values.device)])
            uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
            merged = vals.new_zeros((uniq.numel(),) + vals.shape[1:])
            return RowSparseNDArray(merged.index_add_(0, inv, vals), uniq,
                                    self._shape)
        return self.todense() + other

    def __sub__(self, other):
        if isinstance(other, RowSparseNDArray):
            return self + RowSparseNDArray(-other._values, other._indices,
                                           other._shape)
        return self.todense() - other

    def __mul__(self, other):
        if np.isscalar(other):
            return RowSparseNDArray(self._values * other, self._indices,
                                    self._shape)
        return self.todense() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        if np.isscalar(other):
            return RowSparseNDArray(self._values / other, self._indices,
                                    self._shape)
        return self.todense() / other

    def _unary(self, fn) -> "RowSparseNDArray":
        """A zero-preserving elementwise ``fn`` on the stored values."""
        return RowSparseNDArray(fn(self._values), self._indices, self._shape)

    def square(self):
        return self._unary(torch.square)

    def sqrt(self):
        return self._unary(torch.sqrt)

    def abs(self):
        return self._unary(torch.abs)

    def sign(self):
        return self._unary(torch.sign)

    def clip(self, a_min, a_max):
        if a_min > 0 or a_max < 0:
            raise MXNetError("clip range excluding 0 would densify a "
                             "row_sparse array; convert with "
                             "tostype('default') first")
        return self._unary(lambda v: torch.clamp(v, a_min, a_max))


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows (reference ``ndarray.h`` kCSRStorage)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self._values = _tensor(data)
        dev = self._values.device
        self._indices = _tensor(indices, dev, "int32")
        self._indptr = _tensor(indptr, dev, "int32")
        self._shape = tuple(int(d) for d in shape)

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._indptr)

    @property
    def nnz(self) -> int:
        return int(self._values.shape[0])

    def _row_ids(self) -> torch.Tensor:
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._values.device),
            counts, output_size=self.nnz)

    def todense(self) -> NDArray:
        out = torch.zeros(self._shape, dtype=self._values.dtype,
                          device=self._values.device)
        out.index_put_((self._row_ids(), self._indices.long()),
                       self._values, accumulate=True)
        return NDArray(out)

    def tostype(self, stype: str):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"cannot convert csr to {stype}")

    def dot(self, rhs, transpose_a: bool = False) -> NDArray:
        """``self · rhs`` (or ``selfᵀ · rhs``) for a dense ``rhs``: the
        CSR product of ``torch.sparse`` (cuSPARSE on the card), or for the
        transpose a gather and an ``index_add_`` over the stored entries."""
        b = _tensor(rhs, self._values.device)
        dt = torch.promote_types(self._values.dtype, b.dtype)
        vals, b = self._values.to(dt), b.to(dt)
        vec = b.dim() == 1
        if vec:
            b = b.unsqueeze(1)
        if transpose_a:
            out = b.new_zeros((self._shape[1],) + b.shape[1:])
            out.index_add_(0, self._indices.long(),
                           vals.unsqueeze(1) * b[self._row_ids()])
        else:
            with warnings.catch_warnings():   # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                a = torch.sparse_csr_tensor(
                    self._indptr, self._indices, vals, size=self._shape,
                    check_invariants=False)
            out = a @ b
        return NDArray(out.squeeze(1) if vec else out)

    def __getitem__(self, i):
        if isinstance(i, slice):
            # a row range stays CSR (reference CSR slice, matrix_op
            # FComputeEx kCSRStorage)
            start, stop, step = i.indices(self._shape[0])
            if step != 1:
                raise MXNetError("CSR slicing supports step 1 only")
            if stop <= start:          # empty (or inverted) row range
                return CSRNDArray(self._values[:0], self._indices[:0],
                                  self._indptr.new_zeros(1),
                                  (0, self._shape[1]))
            ptr = self._indptr[start:stop + 1]
            lo, hi = ptr[[0, -1]].tolist()
            return CSRNDArray(self._values[lo:hi], self._indices[lo:hi],
                              ptr - lo, (stop - start, self._shape[1]))
        return self.todense()[i]

    # -------------------------------------------------- sparse arithmetic
    def _coo(self):
        """(row ids, column ids, values) of the stored entries, int64 ids,
        on the array's device."""
        return self._row_ids(), self._indices.long(), self._values

    @staticmethod
    def _merge_coo(rows, cols, vals):
        """Canonicalize: sort by (row, col), stably, and sum duplicate
        entries in their order (the raw constructor canonicalizes
        nothing)."""
        order = torch.sort(cols, stable=True)[1]
        order = order[torch.sort(rows[order], stable=True)[1]]
        rows, cols, vals = rows[order], cols[order], vals[order]
        if rows.numel():
            boundary = torch.ones_like(rows, dtype=torch.bool)
            boundary[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            starts = boundary.nonzero().reshape(-1)
            seg = torch.cumsum(boundary, 0) - 1
            vals = vals.new_zeros(starts.numel()).index_add_(0, seg, vals)
            rows, cols = rows[starts], cols[starts]
        return rows, cols, vals

    @staticmethod
    def _from_coo(rows, cols, vals, shape, prune_zeros=True):
        rows, cols, vals = CSRNDArray._merge_coo(rows, cols, vals)
        if prune_zeros and rows.numel():
            keep = vals != 0
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        counts = torch.bincount(rows, minlength=shape[0])
        indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return CSRNDArray(vals, cols, indptr, shape)

    def _same_shape(self, other) -> None:
        if other._shape != self._shape:
            raise MXNetError(f"shape mismatch {self._shape} vs "
                             f"{other._shape}")

    def __add__(self, other):
        """csr + csr stays csr (reference elemwise_add csr,csr->csr);
        anything else densifies."""
        if isinstance(other, CSRNDArray):
            self._same_shape(other)
            dev = self._values.device
            (r1, c1, v1), (r2, c2, v2) = self._coo(), other._coo()
            return self._from_coo(torch.cat([r1, r2.to(dev)]),
                                  torch.cat([c1, c2.to(dev)]),
                                  torch.cat([v1, v2.to(dev)]), self._shape)
        return self.todense() + other

    def __sub__(self, other):
        if isinstance(other, CSRNDArray):
            return self + CSRNDArray(-other._values, other._indices,
                                     other._indptr, other._shape)
        return self.todense() - other

    def __mul__(self, other):
        """A scalar and a csr (the intersection of the two patterns) keep
        the result csr; a dense array of the same shape scales each stored
        value by its element (the pattern kept, zeros included)."""
        if np.isscalar(other):
            return CSRNDArray(self._values * other, self._indices,
                              self._indptr, self._shape)
        dev = self._values.device
        if isinstance(other, CSRNDArray):
            self._same_shape(other)
            # on (row, col) keys, each side canonicalized first so that
            # duplicate entries are summed before they multiply
            ncols = self._shape[1]
            r1, c1, v1 = self._merge_coo(*self._coo())
            r2, c2, v2 = self._merge_coo(*(t.to(dev) for t in other._coo()))
            k1, k2 = r1 * ncols + c1, r2 * ncols + c2
            if k2.numel() == 0:
                i1 = i2 = k1[:0]
            else:
                pos = torch.searchsorted(k2, k1).clamp_(0, k2.numel() - 1)
                hit = k2[pos] == k1
                i1, i2 = hit.nonzero().reshape(-1), pos[hit]
            common = k1[i1]
            return self._from_coo(common // ncols, common % ncols,
                                  v1[i1] * v2[i2], self._shape)
        dense = _tensor(other, dev)
        if tuple(dense.shape) != self._shape:
            raise MXNetError(f"shape mismatch {self._shape} vs "
                             f"{tuple(dense.shape)} (csr * dense requires "
                             "identical shapes)")
        rows, cols, vals = self._coo()
        return self._from_coo(rows, cols, vals * dense[rows, cols],
                              self._shape, prune_zeros=False)

    __rmul__ = __mul__

    def sum(self, axis=None) -> NDArray:
        """Sums over the stored values, without densifying (reference
        sum FComputeEx csr)."""
        rows, cols, vals = self._coo()
        if axis is None:
            return NDArray(vals.sum())
        if axis in (0, -2):
            return NDArray(vals.new_zeros(self._shape[1])
                           .index_add_(0, cols, vals))
        if axis in (1, -1):
            return NDArray(vals.new_zeros(self._shape[0])
                           .index_add_(0, rows, vals))
        raise MXNetError(f"bad axis {axis} for 2-D CSR")

    def mean(self, axis=None) -> NDArray:
        n = (np.prod(self._shape) if axis is None
             else self._shape[0] if axis in (0, -2) else self._shape[1])
        return self.sum(axis=axis) / float(n)


def add_n(*arrays):
    """The sum of a list of arrays (reference ElementwiseSum FComputeEx):
    all row_sparse stays row_sparse, all csr stays csr, a dense first
    array or mixed sparse storage densifies."""
    if not arrays:
        raise MXNetError("add_n needs at least one array")
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    out = arrays[0]
    for a in arrays[1:]:
        if isinstance(a, BaseSparseNDArray) and type(a) is not type(out):
            a = a.todense()
        out = out + a
    return out


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """From ``(values, indices)`` and ``shape`` (the values' dtype kept; a
    bare list is float32), or from a dense array (its nonzero rows)."""
    dev = _device(ctx, arg1[0] if isinstance(arg1, tuple) else arg1)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        values, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape")
        if dtype is None and not isinstance(values, (NDArray, torch.Tensor)):
            dtype = getattr(values, "dtype", "float32")
        return RowSparseNDArray(_tensor(values, dev, dtype),
                                _tensor(indices, dev), shape)
    dense = _tensor(arg1, dev, dtype or "float32")
    mag = dense.abs().reshape(dense.shape[0], -1).sum(1)
    nz_rows = (mag > 0).nonzero().reshape(-1)
    return RowSparseNDArray(dense[nz_rows], nz_rows, dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """From ``(data, indices, indptr)`` and ``shape`` (data as
    ``dtype``, default float32), or from a dense array through scipy."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix((data, indices, indptr)) needs "
                             "shape")
        dev = _device(ctx, data)
        return CSRNDArray(_tensor(data, dev, dtype or "float32"),
                          _tensor(indices, dev), _tensor(indptr, dev), shape)
    import scipy.sparse as sps
    dev = _device(ctx, arg1)
    dense = _tensor(arg1, torch.device("cpu"), dtype or "float32").numpy()
    m = sps.csr_matrix(dense)
    return CSRNDArray(_tensor(m.data.astype(dense.dtype), dev),
                      _tensor(m.indices, dev), _tensor(m.indptr, dev),
                      dense.shape)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of storage ``stype`` (nothing stored), or a dense
    one."""
    if stype in ("row_sparse", "csr"):
        dev = _device(ctx) or current_context().torch_device()
        dt = torch_dtype(dtype)
        if stype == "row_sparse":
            return RowSparseNDArray(
                torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev), shape)
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                          torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros(shape[0] + 1, dtype=torch.int32,
                                      device=dev), shape)
    from .utils import zeros as dense_zeros
    return dense_zeros(shape, ctx=ctx, dtype=dtype)


empty = zeros


def retain(data: RowSparseNDArray, indices) -> RowSparseNDArray:
    return data.retain(indices)


def dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    """``lhs · rhs``: a CSR ``lhs`` through :meth:`CSRNDArray.dot`, dense
    operands through the ``dot`` op."""
    if isinstance(lhs, CSRNDArray):
        if transpose_b:
            rhs = rhs.T
        return lhs.dot(rhs, transpose_a=transpose_a)
    from .._imperative import invoke
    return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})

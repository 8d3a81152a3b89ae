"""PyTorch port, the sparse arrays (``mx.nd.sparse``), the lazy row_sparse
SGD update and ``KVStore.row_sparse_pull``, against the JAX package.

Each case runs the same seeded numpy inputs through both packages' public
API (the cases of ``tests/test_sparse.py`` that belong to these parts, and
their edges). Every result is compared part by part: the class and
storage type, the structure (row ids, ``indices``, ``indptr``, shapes,
``nnz``) and every dtype exactly, the values within 1e-6 (absolute and
relative), and bitwise where no arithmetic happens; a case that raises
must raise in both. Each item loops over its cases and names the ones
that fail.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch import optimizer as popt
from mxnet_tpu_torch.ndarray import sparse as psp
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


class _Pkg:
    """One package's names, as the cases call them."""

    def __init__(self, mod, sp, opt):
        self.mx, self.nd, self.sp, self.opt = mod, mod.nd, sp, opt


JAX, PORT = _Pkg(jmx, jsp, jopt), _Pkg(mx, psp, popt)


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _parts(x):
    """A result as comparable parts: (kind, {name: value})."""
    stype = getattr(x, "stype", None)
    if stype == "row_sparse":
        return "row_sparse", {"data": x.data.asnumpy(),
                              "indices": x.indices.asnumpy(),
                              "shape": tuple(x.shape)}
    if stype == "csr":
        return "csr", {"data": x.data.asnumpy(),
                       "indices": x.indices.asnumpy(),
                       "indptr": x.indptr.asnumpy(),
                       "shape": tuple(x.shape), "nnz": x.nnz}
    if hasattr(x, "asnumpy"):
        return "dense", {"value": x.asnumpy()}
    return "plain", {"value": x}


def _run(case, pkg, seed):
    """{name: parts} of ``case``; a raise is a result of its own."""
    out = {}
    try:
        for name, value in case(pkg, np.random.RandomState(seed)).items():
            out[name] = _parts(value) if not (
                isinstance(value, tuple) and value[:1] == ("raises",)) \
                else ("raises", {"what": value[1]})
    except Exception as e:          # noqa: BLE001 — compared below
        out["<case>"] = ("raises", {"what": type(e).__name__})
    return out


def _raises(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001
        return ("raises", type(e).__name__)
    return ("raises", None)


def _compare(name, got, want, exact=()):
    """Failures of ``got`` (the port's) against ``want`` (the JAX
    package's) as strings."""
    bad = []
    if set(got) != set(want):
        return [f"{name}: results {sorted(got)} against {sorted(want)}"]
    for key, (kind, parts) in want.items():
        gkind, gparts = got[key]
        if gkind != kind:
            bad.append(f"{name}.{key}: {gkind} against {kind}")
            continue
        for p, w in parts.items():
            g = gparts[p]
            if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
                g, w = np.asarray(g), np.asarray(w)
                if g.dtype != w.dtype or g.shape != w.shape:
                    bad.append(f"{name}.{key}.{p}: {g.dtype}{g.shape} "
                               f"against {w.dtype}{w.shape}")
                elif p in ("indices", "indptr") or key in exact \
                        or not np.issubdtype(w.dtype, np.floating):
                    if not np.array_equal(g, w):
                        bad.append(f"{name}.{key}.{p}: not equal")
                elif not np.allclose(g, w, rtol=TOL, atol=TOL,
                                     equal_nan=True):
                    bad.append(f"{name}.{key}.{p}: max |d| "
                               f"{np.nanmax(np.abs(g - w)):.3e}")
            elif g != w:
                bad.append(f"{name}.{key}.{p}: {g!r} against {w!r}")
    return bad


def _check(cases, exact=()):
    failed = []
    for seed, case in enumerate(cases):
        failed += _compare(case.__name__, _run(case, PORT, seed),
                           _run(case, JAX, seed), exact)
    assert not failed, "\n".join(failed)


def _sparse_dense(rng, shape, p=0.4):
    return np.where(rng.rand(*shape) < p, rng.randn(*shape), 0).astype("f4")


def _mk_csr(P, dense):
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(dense.shape[0] + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return P.sp.csr_matrix((dense[rows, cols], cols.astype(np.int64),
                            np.cumsum(indptr)), shape=dense.shape)


# ------------------------------------------------------------------ cases
def row_sparse_constructors(P, rng):
    dense = np.zeros((6, 3), "f4")
    dense[[1, 4]] = rng.randn(2, 3)
    rs = P.sp.row_sparse_array(dense)
    vals = rng.randn(3, 2).astype("f4")
    return {
        "from_dense": rs, "todense": rs.tostype("default"),
        "same": rs.tostype("row_sparse"),
        "from_tuple_f64": P.sp.row_sparse_array((np.ones((2, 4)), [0, 3]),
                                                shape=(5, 4)),
        "from_list": P.sp.row_sparse_array(([[1, 2]], [2]), shape=(3, 2)),
        "from_nd": P.sp.row_sparse_array(
            (P.nd.array(vals), P.nd.array([0, 2, 5], dtype="int64")),
            shape=(7, 2)),
        "dtype_arg": P.sp.row_sparse_array((vals, [1, 2, 3]), shape=(4, 2),
                                           dtype="float64"),
        "copy": rs.copy(), "stype": rs.stype, "dense_stype":
            P.nd.zeros((2, 2)).stype,
        "needs_shape": _raises(lambda: P.sp.row_sparse_array((vals, [0]))),
        "bad_tostype": _raises(lambda: rs.tostype("csr")),
        "norm": rs.norm(), "dtype": str(rs.dtype),
    }


def row_sparse_retain(P, rng):
    vals = rng.randn(3, 2).astype("f4")
    rs = P.sp.row_sparse_array((vals, [4, 1, 7]), shape=(10, 2))
    dup = P.sp.row_sparse_array((vals, [1, 1, 3]), shape=(10, 2))
    empty = P.sp.row_sparse_array((P.nd.zeros((0, 2)), P.nd.zeros((0,))),
                                  shape=(10, 2))
    return {
        "kept": P.sp.retain(rs, P.nd.array([2, 4], dtype="int64")),
        "absent_and_order": rs.retain(P.nd.array([9, 7, 0, 4])),
        "duplicates_first": dup.retain(P.nd.array([1, 3])),
        "empty_source": empty.retain(P.nd.array([3])),
        "dense": rs.retain(P.nd.array([1, 7])).tostype("default"),
    }


def row_sparse_arithmetic(P, rng):
    a = P.sp.row_sparse_array((rng.randn(2, 3).astype("f4"), [1, 4]),
                              shape=(6, 3))
    b = P.sp.row_sparse_array((rng.randn(2, 3).astype("f4"), [4, 2]),
                              shape=(6, 3))
    pos = P.sp.row_sparse_array((rng.rand(2, 3).astype("f4") + 0.1, [0, 5]),
                                shape=(6, 3))
    return {
        "add": a + b, "sub": a - b, "self_sub": a - a, "mul": a * 2.5,
        "rmul": 0.5 * a, "div": a / 4.0, "square": a.square(),
        "sqrt": pos.sqrt(), "abs": a.abs(), "sign": a.sign(),
        "clip": a.clip(-0.5, 0.5), "norm": (a + b).norm(),
        "add_dense": a + P.nd.ones((6, 3)),
        "mul_dense": a * P.nd.array(rng.randn(6, 3).astype("f4")),
        "clip_excluding_zero": _raises(lambda: a.clip(0.5, 1.0)),
        "shape_mismatch": _raises(lambda: a + P.sp.row_sparse_array(
            (np.ones((1, 3), "f4"), [0]), shape=(7, 3))),
    }


def csr_constructors_and_dot(P, rng):
    dense = _sparse_dense(rng, (5, 7))
    c = P.sp.csr_matrix(dense)
    w = P.nd.array(rng.randn(7, 3).astype("f4"))
    e = P.nd.array(rng.randn(5, 2).astype("f4"))
    hand = P.sp.csr_matrix((np.array([1, 2, 3], "f8"), [1, 0, 2],
                            [0, 1, 1, 3]), shape=(3, 4))
    return {
        "from_dense": c, "todense": c.tostype("default"), "asnumpy":
            c.asnumpy(), "from_tuple_f64_data": hand, "int_dtype":
            P.sp.csr_matrix((np.array([4, 5]), [0, 1], [0, 1, 2]),
                            shape=(2, 2), dtype="int32"),
        "dot": P.sp.dot(c, w), "dot_t": P.sp.dot(c, e, transpose_a=True),
        "dot_vec": c.dot(P.nd.array(rng.randn(7).astype("f4"))),
        "dot_tb": P.sp.dot(c, P.nd.array(rng.randn(3, 7).astype("f4")),
                           transpose_b=True),
        "dense_dot": P.sp.dot(P.nd.array(dense), w),
        "needs_shape": _raises(lambda: P.sp.csr_matrix(([1.0], [0], [0, 1]))),
        "bad_tostype": _raises(lambda: c.tostype("row_sparse")),
        "norm": c.norm(), "stype": c.stype,
    }


def csr_slicing(P, rng):
    dense = _sparse_dense(rng, (6, 4), 0.5)
    c = _mk_csr(P, dense)
    out = {f"rows_{a}_{b}": c[a:b] for a, b in
           ((1, 4), (0, 6), (4, 1), (2, 2), (7, 9), (-3, None))}
    out["row_int"] = c[2]
    out["step"] = _raises(lambda: c[0:4:2])
    return out


def csr_add_sub(P, rng):
    a, b = _sparse_dense(rng, (5, 6), 0.3), _sparse_dense(rng, (5, 6), 0.3)
    ca, cb = _mk_csr(P, a), _mk_csr(P, b)
    dup = P.sp.csr_matrix((np.array([1.0, 2.0, 3.0]), [2, 0, 2],
                           [0, 3, 3]), shape=(2, 3))
    return {
        "add": ca + cb, "sub": ca - cb, "cancel": ca - ca,
        "dup_canonical": dup + P.sp.zeros("csr", (2, 3)),
        "add_dense": ca + P.nd.ones((5, 6)), "sub_dense": ca - P.nd.ones(
            (5, 6)),
        "shape_mismatch": _raises(lambda: ca + _mk_csr(P, np.eye(4, 6,
                                                             dtype="f4"))),
    }


def csr_mul_and_reductions(P, rng):
    a, b = _sparse_dense(rng, (4, 5)), _sparse_dense(rng, (4, 5))
    ca, cb = _mk_csr(P, a), _mk_csr(P, b)
    d = rng.randn(4, 5).astype("f4")
    d[np.nonzero(a)[0][:1], np.nonzero(a)[1][:1]] = 0.0   # a stored zero
    dup = P.sp.csr_matrix((np.array([1., 1.]), np.array([0, 0], np.int64),
                           np.array([0, 2, 2], np.int64)), shape=(2, 2))
    out = {"scalar": ca * 2.5, "rscalar": 3.0 * ca, "intersect": ca * cb,
           "empty_intersect": ca * P.sp.zeros("csr", (4, 5)),
           "dup_intersect": dup * dup, "dense": ca * P.nd.array(d),
           "numpy_dense": ca * d,
           "dense_shape": _raises(lambda: ca * np.ones((8, 8), "f4")),
           "nnz": ca.nnz, "bad_axis": _raises(lambda: ca.sum(axis=2))}
    for axis in (None, 0, 1, -1, -2):
        out[f"sum_{axis}"] = ca.sum(axis=axis)
        out[f"mean_{axis}"] = ca.mean(axis=axis)
    return out


def add_n_and_zeros(P, rng):
    dense = [_sparse_dense(rng, (3, 4), 0.5) for _ in range(3)]
    rs = [P.sp.row_sparse_array((rng.randn(2, 4).astype("f4"),
                                 np.array([0, 2])), shape=(5, 4))
          for _ in range(2)]
    one = P.sp.row_sparse_array((np.ones((1, 3), "f4"), np.array([0])),
                                shape=(2, 3))
    return {
        "csr": P.sp.add_n(*[_mk_csr(P, d) for d in dense]),
        "csr_list": P.sp.add_n([_mk_csr(P, d) for d in dense]),
        "row_sparse": P.sp.add_n(rs[0], rs[1]),
        "mixed": P.sp.add_n(one, _mk_csr(P, np.eye(2, 3, dtype="f4"))),
        "dense_first": P.sp.add_n(P.nd.array(dense[0]),
                                  _mk_csr(P, dense[1])),
        "none": _raises(lambda: P.sp.add_n()),
        "zeros_rs": P.sp.zeros("row_sparse", (4, 3)),
        "zeros_csr": P.sp.zeros("csr", (4, 3), dtype="float64"),
        "zeros_dense": P.sp.zeros("default", (2, 3)),
        "empty_rs": P.sp.empty("row_sparse", (2, 5)),
    }


def test_sparse_arrays_match_jax():
    """Every constructor, conversion, retain, the arithmetic that stays
    sparse and the one that densifies, CSR slicing, dot, the reductions,
    ``add_n`` and ``zeros`` (``tests/test_sparse.py``'s cases and their
    edges): structure and dtypes exact, values within 1e-6."""
    _check([row_sparse_constructors, row_sparse_retain,
            row_sparse_arithmetic, csr_constructors_and_dot, csr_slicing,
            csr_add_sub, csr_mul_and_reductions, add_n_and_zeros],
           exact=("from_dense", "todense", "same", "copy", "kept",
                  "absent_and_order", "duplicates_first", "empty_source",
                  "asnumpy"))


# ------------------------------------------------------------ lazy update
def _grad(P, vals, idx, shape):
    return P.sp.row_sparse_array((np.asarray(vals, "f4"), np.asarray(idx)),
                                 shape=shape)


def _lazy(opt_kwargs, grads, steps=1, rule="SGD", w0=None):
    def case(P, rng):
        w = P.nd.array(w0 if w0 is not None
                       else rng.randn(6, 3).astype("f4"))
        before = w.asnumpy()
        opt = getattr(P.opt, rule)(**opt_kwargs)
        upd = P.opt.get_updater(opt)
        for _ in range(steps):
            for g in grads(P, rng):
                upd(0, g, w)
        after = w.asnumpy()
        touched = set()
        for g in grads(P, np.random.RandomState(0)):
            touched |= set(g.indices.asnumpy().tolist())
        untouched = [r for r in range(after.shape[0]) if r not in touched]
        return {"weight": w, "num_update": opt.num_update,
                "untouched_unchanged": bool(np.array_equal(
                    after[untouched], before[untouched]))}
    return case


def lazy_touched_rows(P, rng):
    return _lazy({"learning_rate": 0.5}, lambda P, r: [_grad(
        P, np.ones((2, 3)), [1, 4], (6, 3))])(P, rng)


def lazy_duplicates_merged(P, rng):
    return _lazy({"learning_rate": 1.0}, lambda P, r: [_grad(
        P, [[1, 2, 3], [4, 5, 6], [7, 8, 9]], [3, 1, 3], (6, 3))])(P, rng)


def lazy_rescale_clip_wd(P, rng):
    return _lazy({"learning_rate": 0.3, "rescale_grad": 0.25,
                  "clip_gradient": 0.4, "wd": 0.1},
                 lambda P, r: [_grad(P, [[3, -1, 0.5], [-4, 2, 0.1]],
                                     [5, 0], (6, 3))], steps=2)(P, rng)


def lazy_schedule_advances(P, rng):
    sched = P.mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    return _lazy({"learning_rate": 1.0, "lr_scheduler": sched},
                 lambda P, r: [_grad(P, [[1, 1, 1]], [2], (6, 3))],
                 steps=3)(P, rng)


def lazy_update_off_decays_every_row(P, rng):
    return _lazy({"learning_rate": 0.5, "wd": 0.1, "lazy_update": False},
                 lambda P, r: [_grad(P, [[0, 0, 0]], [0], (6, 3))],
                 w0=np.ones((6, 3), "f4"))(P, rng)


def lazy_momentum_densifies(P, rng):
    return _lazy({"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01},
                 lambda P, r: [_grad(P, np.ones((2, 3)), [1, 4], (6, 3))],
                 steps=2)(P, rng)


def lazy_other_rules_densify(P, rng):
    out = {}
    for rule, kw in (("NAG", {"momentum": 0.0}), ("Adam", {}),
                     ("DCASGD", {}), ("SGD", {"multi_precision": True})):
        res = _lazy(dict(kw, learning_rate=0.1, wd=0.05),
                    lambda P, r: [_grad(P, np.ones((1, 3)), [2], (6, 3))],
                    rule=rule)(P, rng)
        out.update({f"{rule}_{k}": v for k, v in res.items()})
        w = P.nd.array(np.zeros((4, 2), "f4"))
        u = P.opt.Updater(getattr(P.opt, rule)(**kw))
        out[f"{rule}_lazy_taken"] = u._lazy_row_sparse_update(
            0, _grad(P, np.ones((1, 2)), [0], (4, 2)), w)
    return out


# --------------------------------------------------------- the store
def row_sparse_pull(P, rng):
    kv = P.mx.kv.create("local")
    w = rng.randn(8, 2).astype("f4")
    kv.init("w", P.nd.array(w))
    kv.init(3, P.nd.array(w * 2))
    out = P.nd.zeros((8, 2))
    kv.row_sparse_pull("w", out=out, row_ids=P.nd.array([0, 5],
                                                       dtype="int64"))
    # a queued push is applied before the rows are read
    kv.push(3, P.nd.ones((8, 2)))
    outs = [P.nd.zeros((8, 2)), P.nd.zeros((8, 2))]
    kv.row_sparse_pull([3, 3], out=[[outs[0]], [outs[1]]],
                       row_ids=[P.nd.array([7, 1]), P.nd.array([2])])
    dup = P.nd.zeros((8, 2))
    kv.row_sparse_pull("w", out=dup, row_ids=P.nd.array([4, 4, 6]))
    return {"out": out, "pushed_0": outs[0], "pushed_1": outs[1],
            "dup": dup,
            "needs_row_ids": _raises(lambda: kv.row_sparse_pull(
                "w", out=out)),
            # refused in both: the JAX package at the flush (a TypeError),
            # the port at the push (MXNetError)
            "sparse_push_refused": _raises(lambda: (kv.push(
                "w", P.sp.row_sparse_array((np.ones((1, 2), "f4"), [0]),
                                           shape=(8, 2))),
                kv.pull("w", out=P.nd.zeros((8, 2)))))[1] is not None}


def cast_storage_is_identity(P, rng):
    x = P.nd.array(_sparse_dense(rng, (3, 4)))
    return {f"to_{s}": P.nd.cast_storage(x, stype=s)
            for s in ("default", "row_sparse", "csr")}


def test_lazy_update_and_the_store_match_jax():
    """``Updater`` with a row_sparse gradient: the lazy path under plain
    SGD (only the touched rows move, duplicates summed first,
    ``rescale_grad`` and ``clip_gradient`` as the JAX package applies them,
    weight decay on the touched rows only, the count and the schedule
    advancing once a call); every other rule, and ``lazy_update=False``,
    densifies and takes the standard update (weight decay on every row).
    The port's untouched rows are bitwise unchanged. Then
    ``row_sparse_pull`` (the requested rows, every other row zero;
    ``row_ids`` required; queued pushes applied first), a sparse push
    refused, and ``cast_storage`` the identity (a dense array of every
    stype), in both packages."""
    _check([lazy_touched_rows, lazy_duplicates_merged, lazy_rescale_clip_wd,
            lazy_schedule_advances, lazy_update_off_decays_every_row,
            lazy_momentum_densifies, lazy_other_rules_densify,
            row_sparse_pull, cast_storage_is_identity])

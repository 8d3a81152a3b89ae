"""Test utilities (``mx.test_utils``).

Counterpart of ``mxnet_tpu/test_utils.py`` (reference
``python/mxnet/test_utils.py``): ``assert_almost_equal``, the finite-
difference ``check_numeric_gradient``, the cross-context
``check_consistency``, ``rand_ndarray`` and ``default_context``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import autograd
from . import ndarray as nd
from .context import Context, current_context
from .ndarray.ndarray import NDArray

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "rand_ndarray", "rand_shape_nd",
           "check_numeric_gradient", "check_consistency", "same"]

_default = [None]


def default_context() -> Context:
    return _default[0] or current_context()


def set_default_context(ctx: Context) -> None:
    _default[0] = ctx


def _host(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def same(a, b) -> bool:
    return np.array_equal(_host(a), _host(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-8) -> bool:
    return np.allclose(_host(a), _host(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")) -> None:
    np.testing.assert_allclose(_host(a), _host(b), rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} vs {names[1]}")


def rand_shape_nd(ndim: int, dim: int = 10) -> tuple:
    return tuple(np.random.randint(1, dim + 1, size=ndim).tolist())


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None) -> NDArray:
    """Uniform values in [-1, 1) from numpy's global stream, on ``ctx``
    (the default context)."""
    arr = np.random.uniform(-1.0, 1.0, size=shape).astype(dtype)
    return nd.array(arr, ctx=ctx or default_context())


def check_numeric_gradient(op_fn: Callable, inputs: Sequence[np.ndarray],
                           eps: float = 1e-3, rtol: float = 1e-2,
                           atol: float = 1e-3,
                           head_grad: Optional[np.ndarray] = None,
                           ctx=None):
    """The gradient of ``op_fn`` (NDArrays in, NDArray(s) out) through
    autograd against central finite differences, on ``ctx`` (the default
    context). Mode-dependent ops (BatchNorm, Dropout) see training mode in
    both."""
    ctx = ctx or default_context()
    arrays = [nd.array(x.astype("float32"), ctx=ctx) for x in inputs]
    for a in arrays:
        a.attach_grad()

    def total(outs):
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        if head_grad is None:
            return sum(o.sum() for o in outs)
        return sum((o * nd.array(head_grad, ctx=ctx)).sum() for o in outs)

    with autograd.record():
        loss = total(op_fn(*arrays))
    loss.backward()
    analytic = [a.grad.asnumpy() for a in arrays]

    def f(xs):
        with autograd.train_mode():
            return float(total(op_fn(*[nd.array(x, ctx=ctx)
                                        for x in xs])).asscalar())

    for i, x in enumerate(inputs):
        num = np.zeros(x.shape, dtype="float64")
        for j in range(x.size):
            xs_p = [a.copy() for a in inputs]
            xs_p[i].reshape(-1)[j] += eps
            xs_m = [a.copy() for a in inputs]
            xs_m[i].reshape(-1)[j] -= eps
            num.reshape(-1)[j] = (f(xs_p) - f(xs_m)) / (2 * eps)
        np.testing.assert_allclose(analytic[i], num, rtol=rtol, atol=atol,
                                   err_msg=f"gradient mismatch for input {i}")


# the per-dtype tolerance of check_consistency (the reference's ladder)
_CONSISTENCY_TOL = {"float16": 1e-1, "bfloat16": 5e-2, "float32": 1e-3,
                    "float64": 1e-5}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, tol=None, rng=None):
    """Cross-context consistency, the reference's CPU/GPU parity check
    (``tests/python/gpu/test_operator_gpu.py``): the same random inputs and
    head gradients go through ``sym`` bound on every context of
    ``ctx_list`` (dicts like ``{"ctx": mx.gpu(), "data": (2, 3),
    "type_dict": {"data": "float32"}}``); each context's outputs and input
    gradients must match the most precise context's within their dtypes'
    tolerance. Returns each context's outputs."""
    rng = rng or np.random.RandomState(17)
    shapes = {k: v for k, v in ctx_list[0].items()
              if k not in ("ctx", "type_dict")}
    arg_names = sym.list_arguments()
    sym_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    base_args = arg_params or {}
    shared = {name: (np.asarray(base_args[name], "float64")
                     if name in base_args
                     else rng.uniform(-1, 1, size=shp) * scale)
              for name, shp in zip(arg_names, sym_shapes)}
    head_grads = [rng.uniform(-1, 1, size=s) for s in out_shapes]
    results = []
    for spec in ctx_list:
        ctx = spec["ctx"]
        type_dict = spec.get("type_dict", {})
        default_dt = type_dict.get("__default__", "float32")
        exe = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
        for name in arg_names:
            dt = type_dict.get(name, default_dt)
            exe.arg_dict[name]._set_data(
                nd.array(shared[name].astype(dt), ctx=ctx)._data)
        exe.forward(is_train=grad_req != "null")
        outs = [o.asnumpy().astype("float64") for o in exe.outputs]
        grads = {}
        if grad_req != "null":
            exe.backward([nd.array(h.astype(default_dt), ctx=ctx)
                          for h in head_grads])
            grads = {n: g.asnumpy().astype("float64")
                     for n, g in exe.grad_dict.items() if g is not None}
        rank = max((np.dtype(type_dict.get(n, default_dt)).itemsize
                    for n in arg_names), default=4)
        results.append(dict(ctx=ctx, outs=outs, grads=grads,
                            dtype=default_dt, rank=rank))
    truth = max(results, key=lambda r: r["rank"])
    for r in results:
        if r is truth:
            continue
        t = tol if tol is not None else max(
            _CONSISTENCY_TOL.get(str(r["dtype"]), 1e-3),
            _CONSISTENCY_TOL.get(str(truth["dtype"]), 1e-3))
        for i, (a, b) in enumerate(zip(r["outs"], truth["outs"])):
            np.testing.assert_allclose(
                a, b, rtol=t, atol=t,
                err_msg=f"output {i}: {r['ctx']} vs {truth['ctx']}")
        for n in r["grads"]:
            if n in truth["grads"]:
                np.testing.assert_allclose(
                    r["grads"][n], truth["grads"][n], rtol=t, atol=t,
                    err_msg=f"grad {n}: {r['ctx']} vs {truth['ctx']}")
    return [r["outs"] for r in results]

"""Fixture results computed once per test session, across the suite's
worker processes, the JAX package's host stream seeded for a block, and
the JAX side of an op grid (helpers for the port's test files; no tests
of its own).

The suite runs under pytest-xdist with ``--dist load``, which hands a
file's tests to several workers, and each worker computes the file's
module-scoped fixtures again. :func:`once` runs an expensive fixture body
(the JAX package compiling its side of a comparison) in the first worker
that needs it and lets the others read its pickled result from the
session's shared temporary directory, under a file lock. Without xdist it
just calls the function.

    @pytest.fixture(scope="module")
    def exported(tmp_path_factory):
        return once(tmp_path_factory, "serving-exported", _export)
"""
import contextlib
import os
import pickle

from filelock import FileLock


def once(tmp_path_factory, key, compute):
    """``compute()``, evaluated once per session (its result must pickle);
    the workers share it through ``<session temp>/<key>.pkl``."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{key}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value


@contextlib.contextmanager
def jax_host_seed(seed):
    """The JAX package's host stream (``mxnet_tpu.random.host_rng()``, which
    its initializers and iterators draw from) seeded with ``seed`` for the
    block and restored after it. Otherwise the stream is seeded once a
    worker (from ``MXNET_SEED``) and advanced by every earlier test there,
    so what a test draws from it differs from worker to worker."""
    from mxnet_tpu import random as jrandom
    saved = dict(jrandom._global)
    host = saved.get("host")
    state = host.get_state() if host is not None else None
    jrandom.seed(seed)
    try:
        yield
    finally:
        if host is not None:
            host.set_state(state)
        jrandom._global.clear()
        jrandom._global.update(saved)


def jax_grid(cases, grad_inputs, cotangents):
    """The JAX registry's ops over a case table (rows ``(case id, op name,
    numpy inputs, attrs, how)``, as ``chip_smoke``'s op grids write them)
    in one ``jax.jit``: each case's forward and, for the inputs
    ``grad_inputs(inputs, how)`` names, ``jax.vjp`` under
    ``cotangents(outputs, seed)`` (seed: the case's index). Returns
    [(outputs, gradients)] as numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import mxnet_tpu as jmx
    from mxnet_tpu.ops.registry import get_op

    def run(all_inputs):
        results = []
        for seed, ((cid, name, arrays, attrs, how), inputs) in enumerate(
                zip(cases, all_inputs)):
            fn = get_op(name).fn
            gi = grad_inputs(arrays, how)

            def f(*diff, _inputs=inputs, _gi=gi, _fn=fn, _attrs=attrs):
                args = list(_inputs)
                for i, d in zip(_gi, diff):
                    args[i] = d
                out = _fn(*args, **_attrs)
                return tuple(out) if isinstance(out, (tuple, list)) \
                    else (out,)

            if not gi:
                results.append((f(), ()))
                continue
            outs, vjp = jax.vjp(f, *[inputs[i] for i in gi])
            cts = tuple(jnp.asarray(c, o.dtype) for c, o in zip(
                cotangents(outs, seed), outs))
            results.append((outs, vjp(cts)))
        return results

    inputs = [[jnp.asarray(a) for a in c[2]] for c in cases]
    with jmx.cpu():
        out = jax.jit(run)(inputs)
    return [([np.asarray(o) for o in outs], [np.asarray(g) for g in grads])
            for outs, grads in out]

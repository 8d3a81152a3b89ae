"""Fixture results computed once per test session, across the suite's
worker processes (a helper for the port's test files; no tests of its own).

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

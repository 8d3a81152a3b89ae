"""One intra-op thread for torch in the port's test files, and XLA's
least optimization for the JAX side of their comparisons (a fixture, no
tests of its own).

The suite runs in several worker processes on one machine; each torch
would otherwise start a thread per core, and the workers' threads would
contend for the cores with each other and with the JAX side's compiles.
Compiling is most of the port files' time (about three quarters of it,
sampled in one process): while a port test module runs, JAX compiles at
``jax_optimization_level="O0"``, which computes the same functions with
less optimized code, sooner; the level is restored after the module, so
that the JAX package's own tests compile as they would alone. Each file
imports the fixture, which does both for its module:

    from test_torch_threads import one_torch_thread  # noqa: F401
"""
import contextlib
import sys

import pytest
import torch


@contextlib.contextmanager
def _jax_optimization_level(level):
    if "jax" not in sys.modules:          # a file that runs no JAX
        yield
        return
    import jax
    old = jax.config.jax_optimization_level
    jax.config.update("jax_optimization_level", level)
    try:
        yield
    finally:
        jax.config.update("jax_optimization_level", old)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with _jax_optimization_level("O0"):
        yield
    torch.set_num_threads(n)

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
import os
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


@contextlib.contextmanager
def _jax_compilation_cache(directory):
    """JAX's persistent compilation cache in ``directory`` for the block,
    every compile cached whatever its time or size, then the cache as it
    was. The suite's workers share the session's directory, so a program
    one worker compiled (the JAX side's op-by-op programs, the same in
    every worker) is loaded, not compiled again, by the next."""
    if "jax" not in sys.modules:
        yield
        return
    import jax
    from jax._src import compilation_cache
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    for k, v in zip(keys, (str(directory), 0.0, 0)):
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    shared = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        shared = shared.parent
    with _jax_optimization_level("O0"), \
            _jax_compilation_cache(shared / "jax-compilation-cache"):
        yield
    torch.set_num_threads(n)

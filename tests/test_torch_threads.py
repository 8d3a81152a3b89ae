"""One intra-op thread for torch in the port's test files (a fixture, no
tests of its own).

The suite runs in several worker processes on one machine; each torch
would otherwise start a thread per core, and the workers' threads would
contend for the cores with each other and with the JAX side's compiles.
Each file imports the fixture, which sets one thread for its module and
restores the count after:

    from test_torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

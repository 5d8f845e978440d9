"""Shared fixture for the torch parity tests: a small intra-op thread pool.

The suite runs several pytest workers side by side, each with JAX's own
thread pool; torch's default of one thread per core on top of that
oversubscribes the machine and slows every worker.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)

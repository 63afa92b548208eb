"""A fixture for the port's CPU tests: two PyTorch intra-op threads while a
module's tests run. The tier-1 run puts several pytest workers on one host;
PyTorch's default, one thread per core in every worker, oversubscribes the
cores several times over and slows the small ops of these tests several
fold (six of these files at -n 6 on an 8-core host: 144 s, and 60 s with
two threads a worker)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

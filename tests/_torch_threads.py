"""An autouse fixture for the port's CPU test modules: their PyTorch work
runs on two intra-op threads, and the count is restored after the module.
The suite runs in several worker processes at once; at PyTorch's default
of one thread per core in each, its threads and XLA's contend for the
same cores, and every worker slows down."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

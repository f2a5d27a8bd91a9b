"""One intra-op thread for the port's CPU tests.

The tier-1 run puts six pytest workers on the machine's cores, and each
PyTorch process otherwise starts a thread pool as wide as the machine;
on the small tensors of these tests the oversubscribed pools spend far
more time synchronising than computing (the port's new test files took
315 s of wall time under six workers with the default pools and 55 s
with one thread each).  A test module uses it by importing the fixture:
``from torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

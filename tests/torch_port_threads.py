"""One intra-op thread for the port's tests.

The tests run under pytest-xdist, several processes to the machine, and
each PyTorch process starts as many OpenMP threads as there are cores.
The port's tests run thousands of tiny operators, and at every one of them
the surplus threads spin and then wait for the slowest, so the processes
starve one another (a 2 s CLI test takes minutes).  A test module imports
:func:`one_torch_thread` to run on one thread and restores the count
after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

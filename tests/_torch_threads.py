"""One torch intra-op thread for each test module of the port's CPU tests.

The repository's test command runs the suite in six pytest-xdist worker
processes on one host (``--dist loadfile``). Each torch process otherwise
opens an OpenMP pool as wide as the host, so the workers' pools
oversubscribe the cores and spin against each other; the port's tests run
small tensors, which one thread computes about as fast. Import
``one_torch_thread`` into a test module: it is autouse and module-scoped,
so it also covers the module's other module-scoped fixtures, and it
restores the thread count afterwards.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

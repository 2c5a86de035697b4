"""One intra-op thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` module that runs the port on the CPU imports
``one_thread``; an imported fixture is the importing module's own, so each
such module runs on one torch thread and gets its thread count back after
its last test:

    from tests.torch_threads import one_thread  # noqa: F401

The port's eager CPU path launches many small ops, which one thread runs
no slower than several (several only contend, more so beside JAX's own
thread pool in the same process), and the suite's parallel workers then do
not oversubscribe the cores.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""One intra-op thread for the port's CPU runs in its tests.

The tier-1 run puts six pytest workers on the host, and torch's default of
one intra-op thread per core then oversubscribes it: the port's many small
tensor operations spend their time in OpenMP barriers (on an 8-core host
with seven busy processes, tests/test_torch_subsub.py's cache test took
121 s with the default and 13 s with one thread).  Each port test module
imports ``one_torch_thread``, an autouse module-scoped fixture that runs
the module on one thread and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""`one_thread`: an autouse module fixture for the port's tests whose many
small ops run on the CPU.  Under the test run's several workers on shared
cores, torch's default of one intra-op thread a core oversubscribes them,
and such a test ran up to 90 times slower than alone; with one thread it
does not.  A module imports it to use it; the thread count is restored
after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

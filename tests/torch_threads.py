"""One torch thread for a port test module's tests.

The suite runs in several worker processes at once (pytest-xdist); each
torch process would otherwise start one intra-op thread per core, and the
workers' threads then outnumber the cores many times over and spin against
each other.  Every `tests/test_torch_*.py` imports `one_torch_thread`, an
autouse module fixture that sets torch to one intra-op thread for the
module's tests and restores the previous count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

"""torch on one thread while a port test module runs.

Under the tier-1 run's `-n 6` every worker process would start a torch
thread pool as wide as the machine, and six of them oversubscribe its
cores: seven of the port's test files took 1498.6 worker-seconds beside
each other so, and 492.6 with torch on one thread (an 8-core CPU).  Each
tests/test_torch_*.py file imports `torch_one_thread`, which pytest then
uses for every test of the module; rows and counters do not depend on
the thread count (the port adds floats in a fixed order).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

"""A module fixture that runs the port's CPU tests on one torch thread.

Under pytest-xdist every worker process would otherwise start one intra-op
thread per core, and the port's tests, made of many small ops, then spend
their time waiting at each op's thread barrier while the other workers hold
the cores. Import `one_torch_thread` into a test module to use it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

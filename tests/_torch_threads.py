"""One intra-op torch thread for each test of a module that imports it.

    from _torch_threads import one_thread  # noqa: F401

The port's CPU tests run thousands of small torch ops. Under pytest-xdist
each worker would start as many intra-op threads as the machine has
cores, and the workers then slow one another down several times over
(jamba's loss: 16 s alone against 103 s beside five busy workers). The
fixture is autouse: importing it into a test module applies it to every
test there, and it restores the count after each test.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

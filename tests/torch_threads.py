"""One torch thread while a port test module runs.

The test workers (pytest-xdist, six of them on a host of eight cores) each
start torch's intra-op pool, sized to every core; six such pools on eight
cores spend most of their time waiting at one another's barriers.  torch's
pool is OpenMP, and OpenMP's thread count is one setting in a process,
shared with the port's host engine and with the JAX package's (the process
loads one libgomp).  So the cap holds while a port module's tests run, and
the count is restored after them: the reference modules that share the
worker run as they did.  Each port test module imports the fixture.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""torch on one intra-op thread for the port's test modules.

The tier-1 run shares the CPU among its workers (6 on 8 cores), and each
worker's torch would take every core for its OpenMP regions: their
threads then wait on one another's busy cores.  On an 8-core host, six
concurrent copies of one CLI test ran 18-20 s each on one thread, and
more than 6 minutes each (stopped unfinished) on torch's default 8.  Each port test module imports
`torch_one_thread`, an autouse fixture, so its tests run on one thread
and the worker's setting comes back after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

"""A fixture for the port's test files: torch on one intra-op thread.

The suite runs its files in several pytest-xdist workers at once. Each
worker's torch would start a thread per core, so the host runs several
times more busy threads than it has cores, and torch's CPU ops, which
wait for all of their threads, slow down tens of times (a ``test_main``
case: 2 s alone, 50 s beside seven busy processes). Import
``one_torch_thread`` into a test module to run its tests on one thread and
restore the count after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

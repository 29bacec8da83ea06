"""A fixture for the port's tests: torch's ops on one thread.

The test runner spreads the files over several worker processes on the
same cores. With torch's default of one intra-op thread a core in every
worker, the threads of one parallel region wait for each other while the
workers take the cores in turns, and a test of many small ops slows by an
order of magnitude: ``test_torch_dqn_train.py``'s rollback case took 82 s
on 8 busy cores against 6 s with one thread (5 s on idle cores either
way). A test file imports ``one_torch_thread`` to apply it to its tests.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

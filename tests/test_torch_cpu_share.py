"""Each pytest-xdist worker runs torch on its share of the CPU.

The root ``conftest.py`` sets ``OMP_NUM_THREADS`` in every worker before a
test module imports torch. A plugin or module that imports torch earlier
leaves the pool at every core, and this test fails.
"""
import os

import torch


def test_xdist_worker_torch_pool_takes_its_share():
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ:
        return      # one process: nothing sets the share
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])

"""The thread count the port's CPU tests run with.

The suite runs in six pytest-xdist workers on a machine of eight cores.
Each worker's torch would start one intra-op thread a core, and the
oversubscribed threads spend the machine's time waiting on each other.
The module-scoped autouse fixture :func:`port_test_env`, imported into a
port test module, gives torch two threads while that module's tests run
(and ``OMP_NUM_THREADS`` to the subprocesses they start that do not set
their own), then puts back what was there, so the other tests in the same
worker run as they always did. That cut the wall time of the port's
tests by about a quarter on such a machine.
"""
import os

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def port_test_env():
    saved_env = os.environ.get("OMP_NUM_THREADS")
    saved_threads = torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    torch.set_num_threads(TORCH_THREADS)
    try:
        yield
    finally:
        if saved_env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved_env
        torch.set_num_threads(saved_threads)

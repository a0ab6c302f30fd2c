"""torch on one intra-op thread for the port's tests.

The suite's test workers share the cores, and each parallel region of
torch's CPU ops waits until all its threads are scheduled, so eight threads
a process slow the runs down by orders of magnitude (no check depends on the
thread count).  A test module imports ``one_thread_module`` to run all its
tests so."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

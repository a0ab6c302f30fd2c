"""torch on one intra-op thread for the port's tests.

The suite's test workers share the cores, and each parallel region of
torch's CPU ops waits until all its threads are scheduled, so eight threads
a process slow the runs down by orders of magnitude (no check depends on the
thread count).  A test module imports ``one_thread_module`` to run all its
tests so; a test that alone needs it asks for ``one_thread``."""

import pytest
import torch


def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


one_thread = pytest.fixture(_one_thread, name="one_thread")
one_thread_module = pytest.fixture(_one_thread, scope="module",
                                   autouse=True, name="one_thread_module")

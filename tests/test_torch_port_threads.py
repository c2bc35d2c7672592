"""The thread-count fixture of the port's model-scale test files.

A file imports it to switch it on for all of its tests:

    from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
"""
import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """TEST_THREADS intra-op threads for each module that imports this
    fixture: with several test workers on the machine, each process's
    default thread pool makes the many small ops of these test-scale models
    tens of times slower (a loop of FPS steps, the keep-scans)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)

"""``one_torch_thread``: torch on one thread while a test module's models
step. The tests run in several processes at once, and a process's torch
threads, one a core, would wait on each other's. A test module imports the
fixture to use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need an NVIDIA card; they skip inside the ``card``
fixture without one, and run on the card's machine with the same
command."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs the port's CUDA "
                    "kernels, which have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    """One process of the test run keeps to a few threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)

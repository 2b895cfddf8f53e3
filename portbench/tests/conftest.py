"""The benchmark's tests. Those that need a CUDA card take the ``card``
fixture, which skips without one; the rest run on the CPU at tiny
sizes."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips through the card fixture "
        "without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)

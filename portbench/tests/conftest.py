"""The benchmark's tests: CPU tests, and tests marked ``card`` that need an
NVIDIA card and skip without one (decided inside each test, never while a
module is imported). Run them with ``python -m pytest portbench/tests``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    return torch.device("cuda")

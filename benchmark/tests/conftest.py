"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA device and skip without one; they run on
the card with ``python -m pytest benchmark/tests -q -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs in TF32 on the card")
    return torch.device("cuda", 0)

"""Tests of the benchmark harness.  CPU tests run anywhere; tests marked
``card`` need a CUDA device and skip without one (decided in the
``cuda`` fixture, never at import):

    python -m pytest portbench -q              # CPU
    python -m pytest portbench -q -m card -s   # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

"""pytest settings of the benchmark's own tests (``pytest benchmark/tests``).

Tests that need the card take the ``card`` fixture: it skips the test where
no CUDA device is visible. Whether there is a card is decided in the fixture,
never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest benchmark/tests -m card`")
    return torch.device("cuda")

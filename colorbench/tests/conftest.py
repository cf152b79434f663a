"""The benchmark's tests.  ``pytest colorbench/tests -q`` runs them on the
CPU, where the tests marked ``card`` skip; on a machine with an NVIDIA
card, ``pytest colorbench/tests -q -m card`` runs those."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.device("cuda", 0)

"""pytest settings of the benchmark's own tests: the marker ``card`` for
tests that need a CUDA card.  Whether there is one is decided inside the
``card`` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python3 -m pytest "
                    "portbench/tests -m card)")
    return torch.device("cuda")

"""Settings of the benchmark's own tests: the ``gpu`` marker and the card.
Each mode cuts its cells to a size the CPU runs in seconds (its
``tiny(cell, conf)``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest -m gpu benchmark/tests)")
    return torch.device("cuda")

"""Tests of the benchmark itself. They import neither JAX nor the JAX
package. Tests marked ``card`` need an NVIDIA card and skip without one;
whether there is one is decided in the ``card`` fixture, never at import.
Run them on the card with ``python3 -m pytest benchmark/tests -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's program runs its kernel there")
    return torch.cuda.get_device_name(0)

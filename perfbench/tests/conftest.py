"""Run from the repository's root, without the JAX package's test plugin
that the root pytest settings load:

    python -m pytest -o addopts= perfbench/tests -q

Tests marked `card` need a CUDA card; on a machine without one they skip,
decided inside the test (the `card` fixture), never at import or
collection."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card (skips '
                            'without one)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda:0'

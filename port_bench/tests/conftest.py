"""The benchmark's tests: ``python -m pytest port_bench/tests`` from the
root of the repository. Tests marked ``cuda`` need the card and skip
without it (decided in the ``cuda_device`` fixture); on the card run them
with ``python -m pytest port_bench/tests -m cuda``."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

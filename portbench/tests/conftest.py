"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` on the
CPU (the cells rehearsed at tiny sizes through the program's plain paths);
the tests marked ``gpu`` run only where a CUDA device is, and skip here."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (run on the card)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")

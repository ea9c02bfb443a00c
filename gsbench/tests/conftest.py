import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skip the test unless a CUDA card is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")

"""The benchmark's own tests (``python -m pytest skybench/tests``, from
the root of the repo; the repo's pytest collects only ``tests/``).  A
test that needs the CUDA card is marked ``chip`` and skips elsewhere,
deciding inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card (run on the chip)")
    return "cuda"

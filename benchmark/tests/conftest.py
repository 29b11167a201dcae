"""CPU tests of the benchmark (``python -m pytest benchmark/tests``). Tests
that need a CUDA card carry the ``cuda`` marker and decide inside the test
whether to skip."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the benchmark's own runs)")

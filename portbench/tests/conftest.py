"""Tests of the benchmark harness: on the CPU at small sizes, except the
ones marked ``gpu``, which decide inside the test whether a card is
there."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skipped without one")

"""The benchmark's tests. Tests marked ``card`` need a CUDA card and skip
without one; they decide inside the test, never while a module is
imported."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skips where there is none")

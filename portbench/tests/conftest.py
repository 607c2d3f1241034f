"""Tests of the benchmark itself: ``python -m pytest portbench/tests`` from
the checkout's root. Tests marked ``card`` need a CUDA device and skip
without one (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")

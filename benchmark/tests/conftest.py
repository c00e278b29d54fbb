"""Tests of the benchmark (run on the CPU at a tiny size, except those
marked `card`, which skip where no CUDA device is found).

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (the test "
        "decides inside itself)")

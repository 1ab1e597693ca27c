"""The benchmark's own pytest settings: the ``card`` marker of tests that
need a CUDA card (they skip elsewhere), and the checkout's root on the
import path so that ``port_bench`` imports as a package."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: python3 -m "
        "pytest port_bench/tests -m card -o addopts='' -s)")

"""The benchmark's own tests, on the CPU. Run from the repository root:

    python -m pytest h100bench/tests -q

Tests that need the card carry the `chip` marker and skip without one;
on the card's machine `python -m pytest h100bench/tests -q -m chip`
runs them.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")

"""The benchmark's tests. CPU tests run the harness at tiny sizes against
the plain reference; tests marked `cuda` need an NVIDIA card (skipped
without one) and run the cells at the cells' widths. On the card's
machine:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped without one)")

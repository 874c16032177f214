"""The benchmark's own tests: ``python -m pytest bench_h100/tests -q`` from
the root of the repository. Tests marked ``card`` need a CUDA card and skip
inside the test without one; on the card: ``python -m pytest
bench_h100/tests -q -m card``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips inside the test without one")

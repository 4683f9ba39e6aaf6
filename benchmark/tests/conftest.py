"""Tests of the benchmark: ``python -m pytest benchmark/tests`` from the
checkout's root. CPU tests drive the harness's dry path at small sizes;
tests marked ``gpu`` need a CUDA card and skip themselves without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one"
    )

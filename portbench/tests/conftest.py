"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`gpu` that skip without a CUDA card.

    python3 -m pytest portbench/tests
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell cut to a size the CPU runs in seconds (the plain versions of
# the port's kernels): 20,000 intents over 20 x 20 cells hold the
# cell's density of intents a cell; the corridors, the batch and the
# check are the cell's own
TINY = {"data": {"intents": 20000, "metro_side_cells": 20},
        "traffic": {"pool": 4, "check_sample": 2000}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")

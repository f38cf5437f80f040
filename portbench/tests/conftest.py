"""The benchmark's own tests: they run on the CPU at tiny sizes; those
marked ``card`` need a CUDA card and skip without one.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


def tiny(cell_name: str, uniques: int = 4, lanes: int = 8, depth: int = 40,
         max_events: int = 64):
    """The cell resolved from BENCHMARK.json, cut to a size the CPU's
    plain route replays in a second."""
    import run

    cell = run.resolve(cell_name)
    cell.config = dict(cell.config, unique_histories=uniques,
                       generator_args={"depth": depth},
                       caps=dict(cell.config["caps"], max_events=max_events))
    cell.size = {"lanes": lanes}
    return cell


# the tiny sizes of each cell: (depth, max_events); the resumed tail of a
# 110-event history holds activity schedules (hash-valued columns)
TINY = {
    "retry_deep.storm_resident": (40, 64),
    "ndc_storm.storm_resident": (40, 64),
    "retry_deep.resume_tail": (110, 128),
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch

"""Each cell's CUDA path at a tiny size, and the device trace's readers,
on a card.  Marked `gpu`; skips without a card (decided inside the
test):

    python3 -m pytest -m gpu portbench/tests/test_portbench_card.py
"""

import json

import pytest
from conftest import ROOT, TINY

from portbench import run

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(cell):
    need_card()
    result, info, _ = run.run_cell(cell, 2**31 + 3, 1.0, True, dev="cuda",
                                   overrides=TINY)
    assert result["correct"] is True
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)

"""The harness: cells, mixes and metrics found by name, the contract's
names and units, each cell end to end on the CPU through the port's
plain paths, and no JAX in the measuring process."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import ROOT, TINY

from portbench import run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_config_mix_and_metric_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for kind, key in (("entries", "entry"), ("recipes", "recipe"),
                          ("reference", "reference")):
            assert (ROOT / "portbench" / kind / f"{cfg[key]}.py").exists()
    for w in BENCH["workloads"]:
        t = json.loads((ROOT / "portbench" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers" / f"{t['driver']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert len(set(names[:len(BENCH["configs"]) + len(CELLS)])) == len(
        BENCH["configs"]) + len(CELLS)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for text in [w["why"] for w in BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]] + [
            c[k] for c in BENCH["configs"] for k in ("source", "why")]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_on_the_cpu(cell, trace):
    result, info, lines = run.run_cell(cell, 2**31 + 7, 1.0, bool(trace),
                                       dev="cpu", overrides=TINY)
    assert result["correct"] is True
    assert info["compared"] > 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert lines[-1] == "check correct true"
    loaded = run.load_cell(cell)
    want = loaded["per_layer"] if trace else loaded["end_to_end"]
    got = set(result["metrics"])
    # the device readers find nothing to read on the CPU
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {m["name"] for m in want
                       if m["source"] != "device_trace"}


def test_no_jax_in_the_measuring_process():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "from conftest import TINY\n"
        "for c in %r:\n"
        "    run.run_cell(c, 1, 0.5, False, dev='cpu', overrides=TINY)\n"
        "print(run.forbidden_modules())\n" % (str(ROOT), CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "dss_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dss_tpu.ops", sys)
    assert run.forbidden_modules() == ["dss_tpu"]


def test_no_card_no_result(capsys):
    # this sandbox has no CUDA card: the run refuses and prints nothing
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""

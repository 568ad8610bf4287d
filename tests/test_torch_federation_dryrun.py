"""The port's federation dryrun (dss_tpu_torch/cmds/federation_dryrun.py)
against the reference's.

- The in-process faultplan leg, with its stores `cuda` on the CPU,
  gives the reference's verdict for the same seed: the injected counts
  per fault site, the stale serves and the shed writes.
- The sigkill leg runs as the module's own process with `--device
  cpu`, under a deadline of its own: two port region log servers and
  two port DSS servers in region mode federated over real sockets, one
  whole region SIGKILLed and restarted.  Its verdict must be clean.
- Without a card, the default `--device cuda` refuses to run on the
  CPU instead of carrying on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dss_tpu.cmds import federation_dryrun as r_dryrun
from dss_tpu_torch.cmds import federation_dryrun as p_dryrun

ROOT = Path(__file__).resolve().parents[1]
SIGKILL_DEADLINE_S = 240


def _run(*args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "dss_tpu_torch.cmds.federation_dryrun",
         *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("seed", [13, 29])
def test_faultplan_leg_gives_the_reference_verdict(seed):
    want = r_dryrun.run_faultplan_leg(seed=seed)
    got = p_dryrun.run_faultplan_leg(seed=seed, device="cpu")
    assert want["ok"] and got["ok"]
    keys = ("ok", "seed", "injected", "stale_served", "shed_writes")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["injected"] == {"region.federation.sync": 4,
                               "region.federation.request": 4}


def test_sigkill_leg_over_four_processes():
    res = _run("--run", "--leg", "sigkill", "--device", "cpu",
               timeout=SIGKILL_DEADLINE_S)
    assert res.returncode == 0, res.stderr[-4000:]
    verdict = json.loads(res.stdout)
    assert verdict["ok"] and verdict["bit_identical"]
    assert verdict["partition"] == {
        "local_5xx": 0, "stale_marked": True, "write_shed_503": True,
        "overbound_shed_503": True,
    }
    assert verdict["unexpected_statuses"] == 0
    assert verdict["requests_total"] > 40
    assert verdict["recovery_s"] > 0 and verdict["partition_dwell_s"] > 0


def test_default_device_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _run("--run", "--leg", "faultplan", timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert '"ok": true' not in res.stdout
    # no --run: the help, exit 2
    assert _run(timeout=60).returncode == 2

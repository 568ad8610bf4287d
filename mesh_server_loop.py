#!/usr/bin/env python3
"""chip_smoke.py's mesh-server phase alone, N times in a row, on the
card.

    python3 mesh_server_loop.py [N]        (N defaults to 12)

Each run is chip_smoke.mesh_server: the server binary with
`--sharded_replica 1,2 --virtual_devices 2` booted from a fresh copy of
the http phase's WAL (chip_smoke.store_columns(HTTP_OPS, seed=9),
written once), its replica surfaces held to the store's routes, a few
writes read back, then SIGTERM, which must exit 0.  The server arms
faulthandler, so an abort at exit prints every thread's stack.  One
JSON line a run (exit code, whether the fault handler printed, the
phase's failures, its surfaces' mismatches and the running total),
then {"runs", "clean_exits", "card"}; the server log of a run that did
not exit 0, or whose fault handler printed, is copied to
chiprun_out/mesh_server_run<i>.log.  Exits 1 without a card or when a
run was not clean (a mismatch counts).  Work files go under
build/mesh_loop/.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from dss_tpu_torch import native  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    if not cs.torch.cuda.is_available():
        print("mesh_server_loop: no CUDA card", file=sys.stderr)
        return 1
    cs.cuda_build.build()
    if not native.ensure_built():
        print("mesh_server_loop: the native library did not build",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    work = HERE / "build" / "mesh_loop"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    pristine, wal = work / "pristine.wal", work / "dss.wal"
    now = time.time_ns() // 1_000_000_000 * 1_000_000_000
    cols = cs.store_columns(cs.HTTP_OPS, seed=9, now=now + cs.HOUR // 2)
    cs.write_store_wal(str(pristine), cols, now=now)
    state = {"work": str(work), "wal": str(wal), "cols": cols, "now": now,
             "aois": cs.svc_aois(71, cs.HTTP_SEARCHES, now + cs.HOUR // 2)}
    # the server's process, for its exit code when a check raised
    servers = []
    popen = subprocess.Popen

    def recording_popen(*a, **k):
        servers.append(popen(*a, **k))
        return servers[-1]

    subprocess.Popen = recording_popen
    clean = bad = 0
    for i in range(n):
        shutil.copy(pristine, wal)
        t = time.time()
        try:
            line, failures = cs.mesh_server(smi, state)
        except Exception as e:  # noqa: BLE001 — a check of the phase
            line, failures = {"exit_code": servers[-1].returncode}, [repr(e)]
        rc = line.get("exit_code")
        printed = line.get("fault_handler_output")
        clean += (rc == 0 and not printed and not failures
                  and cs.MESH_TALLY.mismatches == bad)
        bad = cs.MESH_TALLY.mismatches
        print(json.dumps({
            "run": i, "exit_code": rc, "fault_handler_output": printed,
            "sigterm_exit_s": line.get("sigterm_exit_s"),
            "boot_s": line.get("boot_s"), "seconds": time.time() - t,
            "surface_mismatches": line.get("mismatches"),
            "failures": [f[:3000] for f in failures],
            "mismatches": cs.MESH_TALLY.mismatches}), flush=True)
        if rc != 0 or printed:
            shutil.copy(work / "mesh_server.log",
                        out / f"mesh_server_run{i}.log")
    subprocess.Popen = popen
    print(json.dumps({"runs": n, "clean_exits": clean, "card": smi}),
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0 if clean == n else 1


if __name__ == "__main__":
    sys.exit(main())

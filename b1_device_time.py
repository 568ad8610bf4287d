#!/usr/bin/env python3
"""B1's device time for one copy of dss_tpu_torch, on chip_smoke.py's
headline batch and on an L2-resident batch of the same shape, and with
--main-path that copy's main-path batch time.

    python3 b1_device_time.py [--root DIR] [--main-path]

DIR holds the `dss_tpu_torch` package to time (default: this checkout).
Its wrapper `ops.fused_filter.fused_window_filter` is called as every
version of it has been called, so its own kernels are built (under
DIR) and launched as its own wrapper launches them.  To hold one B1
against another, unpack the other's package where git does not look
and run both in turns in one call on the card:

    mkdir -p build/parent
    git archive <commit> dss_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 b1_device_time.py --root "$r"; done

Each run loads chip_smoke.py's 1M-intent table on the card, holds B1
against its plain version on both batches, and prints one JSON line:
per batch, the device time of one call with the L2 flushed and warm
(chip_smoke.device_ms), how each was taken, and the device kernels a
call launches; with --main-path, the p50 of 8 batches of 8192 queries
through that copy's DarTable.query_many_submit/collect on the same
records (chip_smoke.card_batch, after one unmeasured batch) and of
their stages; then the package's path and the card.  Exits 1 without a
card or when B1 disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (label, cells the batch's queries are drawn from): the second batch's
# blocks, about 2 MB of columns, stay in the L2
BATCHES = (("headline", None), ("l2_resident", 2_000))


def load_smoke(root: Path):
    """chip_smoke.py of this checkout, importing dss_tpu_torch from
    root."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not Path(cs.ff.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"dss_tpu_torch came from {cs.ff.__file__}, "
                           f"not from {root}")
    return cs


def main_path(cs, dev, recs) -> dict:
    """p50 batch and stage times of 8 main-path batches on dev."""
    idx = cs.CudaSpatialIndex(device=dev, idle_fold_s=0,
                              delta_capacity=1 << 30)
    idx.table.bulk_load(recs)
    cs.card_batch(idx, cs.make_batch(199, cs.BATCH, cs.N_CELLS, cs.WIDTH))
    stages = [cs.card_batch(idx, cs.make_batch(200 + i, cs.BATCH,
                                               cs.N_CELLS, cs.WIDTH))[0]
              for i in range(8)]
    idx.close()
    return {
        "batches": len(stages),
        "p50_batch_ms": statistics.median(sum(st.values())
                                          for st in stages) * 1e3,
        "p50_stage_ms": {k: statistics.median(st[k] for st in stages) * 1e3
                         for k in stages[0]},
    }


def measure(cs, dev, recs) -> tuple:
    """B1 on both batches over the 1M-intent table on dev.  -> ({batch:
    times}, number of batches on which B1 disagreed with its plain
    version)."""
    import torch

    ft = cs.tiers.build_snapshot(recs, device=dev).fast
    flush = cs.Flush(dev)
    rows, bad = {}, 0
    for label, n_cells in BATCHES:
        q = cs.make_batch(100, cs.BATCH, n_cells or cs.N_CELLS, cs.WIDTH)
        args, nw, _ = cs.kernel_args(ft, q)
        mw = cs.pow2_bucket(nw, lo=1 << 16)

        def b1():
            return cs.ff.fused_window_filter(*args, max_words=mw)

        bad += not torch.equal(
            b1(), cs.ff.fused_window_filter_torch(*args, max_words=mw))
        cold, cold_by, cold_src = cs.device_ms(b1, flush)
        warm, _, warm_src = cs.device_ms(b1)
        rows[label] = {
            "windows": nw, "cold_ms": cold, "warm_ms": warm,
            "ms_source": {"cold_ms": cold_src, "warm_ms": warm_src},
            "launches_per_call": {k: v[1] for k, v in cold_by.items()},
        }
    return rows, bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the dss_tpu_torch to time")
    ap.add_argument("--main-path", action="store_true",
                    help="also time 8 main-path batches of that copy")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_smoke(root)
    if not cs.torch.cuda.is_available():
        print("b1_device_time: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = cs.torch.device("cuda")
    recs, _ = cs.make_records(cs.N_ENTITIES, cs.N_CELLS, cs.KPE)
    rows, bad = measure(cs, dev, recs)
    out = {"package": str(Path(cs.ff.__file__).resolve().parents[1]),
           "batches": rows, "card": smi}
    if args.main_path:
        out["main_path"] = main_path(cs, dev, recs)
    print(json.dumps({"b1_device_time": out}), flush=True)
    if bad:
        print(f"b1_device_time: B1 != its plain version on {bad} batches",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

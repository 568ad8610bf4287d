#!/usr/bin/env python3
"""B1's device time for one copy of dss_tpu_torch, on chip_smoke.py's
headline batch and on an L2-resident batch of the same shape, with
--main-path that copy's main-path batch time, and with --masks the
times of its mask kernels B2, B3 and B4 and of the card's launch floor.

    python3 b1_device_time.py [--root DIR] [--main-path] [--masks]

DIR holds the `dss_tpu_torch` package to time (default: this checkout).
Its wrapper `ops.fused_filter.fused_window_filter` is called as every
version of it has been called, so its own kernels are built (under
DIR) and launched as its own wrapper launches them.  To hold one B1
against another, unpack the other's package where git does not look
and run both in turns in one call on the card:

    mkdir -p build/parent
    git archive <commit> dss_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 b1_device_time.py --root "$r" --masks; done

Each run loads chip_smoke.py's 1M-intent table on the card, holds B1
against its plain version on both batches, and prints one JSON line:
per batch, the device time of one call with the L2 flushed and warm
(chip_smoke.device_ms), how each was taken, and the device kernels a
call launches; with --main-path, the p50 of 8 batches of 8192 queries
through that copy's DarTable.query_many_submit/collect on the same
records (chip_smoke.card_batch, after one unmeasured batch) and of
their stages; then the package's path and the card.

With --masks, on the same table (the 1M records as one compacted L0
snapshot) and the headline batch: B2 on the legacy path's padded
bucket, B3 and B4 on their first 512 windows (chip_smoke.gridless_args),
each held against its plain version, its device time cold and warm
(chip_smoke.device_ms), its call time (chip_smoke.call_ms) and its
bound (chip_smoke's window_mask_bound_ms / exact_mask_bound_ms); the
launch floor, the device time of a kernel that does no work (the fill
of a one-element torch.zeros) by the same device_ms.
Exits 1 without a card or when a kernel disagrees with its plain
version.
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


def measure(cs, ft, flush) -> tuple:
    """B1 on both batches over the 1M-intent table `ft`.  -> ({batch:
    times}, number of batches on which B1 disagreed with its plain
    version)."""
    import torch

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


def mask_timings(cs, fn, plain, flush) -> dict:
    """One mask kernel's device time cold and warm and its call time."""
    cold, cold_by, cold_src = cs.device_ms(fn, flush)
    warm, _, warm_src = cs.device_ms(fn)
    return {"cold_ms": cold, "warm_ms": warm, "call_ms": cs.call_ms(fn),
            "plain_cold_ms": cs.device_ms(plain, flush)[0],
            "ms_source": {"cold_ms": cold_src, "warm_ms": warm_src},
            "launches_per_call": {k: v[1] for k, v in cold_by.items()}}


def masks(cs, ft, flush) -> tuple:
    """B2, B3 and B4 at the headline, each against its plain version,
    and the launch floor.  -> (the masks part of the line,
    mismatches)."""
    import torch

    fc = cs.fc
    hq = cs.make_batch(100, cs.BATCH, cs.N_CELLS, cs.WIDTH)
    _, _, b2 = ft._legacy_inputs(*hq)
    b3, b4, _ = cs.gridless_args(ft, hq)
    cols4 = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1)
    kernels = {  # name -> (kernel, plain version, its windows, bound)
        "filter_windows": (
            lambda: fc.filter_windows(ft.p3, *b2),
            lambda: fc.filter_windows_torch(ft.p3, *b2), b2[0],
            cs.window_mask_bound_ms(b2[0].cpu().numpy())),
        "filter_windows_gridless": (
            lambda: fc.filter_windows_gridless(ft.p3, *b3),
            lambda: fc.filter_windows_torch(ft.p3, *b3), b3[0],
            cs.window_mask_bound_ms(b3[0].cpu().numpy())),
        "fused_filter_gridless": (
            lambda: fc.fused_filter_gridless(*cols4, *b4),
            lambda: fc.fused_filter_mask_torch(*cols4, *b4), b4[0],
            cs.exact_mask_bound_ms(b4[0].cpu().numpy(),
                                   b4[1].cpu().numpy())),
    }
    out, bad = {}, 0
    for name, (fn, plain, blk, (b_ms, b_bytes)) in kernels.items():
        bad += not torch.equal(fn(), plain())
        t = mask_timings(cs, fn, plain, flush)
        out[name] = {**t, "windows": int(blk.shape[0]), "bound_ms": b_ms,
                     "bound_bytes": b_bytes,
                     "share_of_bound": b_ms / t["cold_ms"]}
    dev = ft.p3.device

    def zero():
        return torch.zeros(1, device=dev)

    floor_cold, _, src_cold = cs.device_ms(zero, flush)
    floor_warm, by, src_warm = cs.device_ms(zero)
    out["launch_floor"] = {
        "what": "torch.zeros(1) on the card: one fill kernel",
        "cold_ms": floor_cold, "warm_ms": floor_warm,
        "device_kernels": list(by),
        "ms_source": {"cold_ms": src_cold, "warm_ms": src_warm}}
    for name in kernels:
        out[name]["share_of_launch_floor"] = (floor_warm
                                              / out[name]["cold_ms"])
    return out, bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the dss_tpu_torch to time")
    ap.add_argument("--main-path", action="store_true",
                    help="also time 8 main-path batches of that copy")
    ap.add_argument("--masks", action="store_true",
                    help="also time B2, B3, B4 and the launch floor")
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
    cs.cuda_build.build()
    recs, _ = cs.make_records(cs.N_ENTITIES, cs.N_CELLS, cs.KPE)
    ft = cs.tiers.build_snapshot(recs, device=dev).fast
    flush = cs.Flush(dev)
    rows, bad = measure(cs, ft, flush)
    out = {"package": str(Path(cs.ff.__file__).resolve().parents[1]),
           "batches": rows}
    if args.masks:
        out["masks"], bad_masks = masks(cs, ft, flush)
        bad += bad_masks
    del ft
    if args.main_path:
        out["main_path"] = main_path(cs, dev, recs)
    out["card"] = smi
    print(json.dumps({"b1_device_time": out}), flush=True)
    if bad:
        print(f"b1_device_time: {bad} kernel outputs differ from their "
              f"plain versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

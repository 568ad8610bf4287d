"""Offline mapping-space autotune: measured seeds for the planner.

The port of the reference's `dss_tpu/plan/autotune.py`.  Every sweep
runs on the device the caller names (`device=`, default `cuda`, which
raises on a machine without a card): the fixture is the port's
DarTable, the device measurements launch B1 (csrc/fused_filter.cu)
eagerly through FastTable.submit/collect/query_fused, and the resident
measurement replays CUDA graphs of B1 through ResidentKernel.  A
profile is the reference's format: the same keys, knobs and
precedence, so a profile measured by either package seeds the other.

The cost models converge online, but a fresh process pays the
winsorized-EWMA learning window under live traffic: until enough
batches have been observed, the router runs on the compiled-in
defaults (a 20 ms dispatch floor, dar/coalesce.py), which can be far
off on a given host.  The mapper papers in PAPERS.md (GOMA; data-placement
evaluation of spatial accelerators) frame route x tile x batch choice
as a *searched mapping* over an analytical cost model — and a
searchable mapping can be tuned offline.

This module runs measured microbenchmarks on the ACTUAL host — the
same kernels the serving path runs, no synthetic proxies — and emits a
machine-readable profile:

    deploy/autotune/<host-class>.json

that `cmds/server.py --autotune_profile` (or DSS_AUTOTUNE_PROFILE)
loads at boot.  Knob precedence is env > profile > defaults: the
profile seeds only knobs the operator has not explicitly set
(os.environ.setdefault), so a deliberate override always wins.

Measured quantities -> knobs:

  host chunk scan cost        -> DSS_CO_EST_CHUNK_MS
  cold dispatch floor + slope -> DSS_CO_EST_FLOOR_MS, DSS_CO_EST_ITEM_MS
  resident stream gap/latency -> DSS_CO_EST_RES_FLOOR_MS, DSS_CO_EST_RES_LAT_MS
  stream-depth knee           -> DSS_CO_RES_INFLIGHT, DSS_CO_RES_RING
  graph bucket grids          -> DSS_RES_BATCH_BUCKETS, DSS_RES_WINDOW_BUCKETS
  per-query hit concentration -> DSS_SHARD_RESULTS (per-shard result
                                 capacity base for the sharded replica)

plus `capacity_weight`, this host's measured serving capacity scalar —
the per-member capacity vector for `weighted_boundaries` is assembled
from the member hosts' profiles (docs/OPERATIONS.md).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

PROFILE_FORMAT = 1
PROFILE_DIR = os.path.join("deploy", "autotune")

# every knob a profile may seed — apply_profile refuses to touch
# anything else, so a stray profile cannot smuggle arbitrary env
KNOB_KEYS = (
    "DSS_CO_EST_FLOOR_MS",
    "DSS_CO_EST_ITEM_MS",
    "DSS_CO_EST_CHUNK_MS",
    "DSS_CO_EST_RES_FLOOR_MS",
    "DSS_CO_EST_RES_LAT_MS",
    "DSS_CO_RES_INFLIGHT",
    "DSS_CO_RES_RING",
    "DSS_RES_BATCH_BUCKETS",
    "DSS_RES_WINDOW_BUCKETS",
    "DSS_SHARD_RESULTS",
    # shared-memory serving front geometry + the worker cost-model
    # seed (parallel/shmring.py / plan/shmroute.py), measured by
    # measure_shm's ring sweep
    "DSS_SHM_DEPTH",
    "DSS_SHM_SLOT_BYTES",
    "DSS_SHM_RTT_MS",
)

HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000


def host_class(device="cuda") -> str:
    """Stable-ish identity of the machine class this profile was
    measured on: accelerator platform + device kind + host core
    count.  Two pods of the same shape share a profile; a laptop and
    a card host never collide.

    The device measured names it: on a card `gpu-<the card's name>`
    (what the reference's JAX names a CUDA device: platform `gpu`,
    kind the card's name), on the CPU `cpu-cpu` (the reference's on
    JAX's CPU), so a profile names the same host class whichever
    package measured it.  `cuda` without a card raises."""
    from dss_tpu_torch.ops.fastpath import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        plat, kind = "gpu", torch.cuda.get_device_name(dev)
    else:
        plat = kind = dev.type
    kind = "".join(
        c if (c.isalnum() or c in "-_") else "-" for c in str(kind)
    ).strip("-")
    return f"{plat}-{kind}-c{os.cpu_count() or 1}"


def default_profile_path(base: Optional[str] = None,
                         device="cuda") -> str:
    return os.path.join(
        base or PROFILE_DIR, f"{host_class(device=device)}.json"
    )


# -- fixture -------------------------------------------------------------------


def _fixture(n_entities: int, n_cells: int, kpe: int = 8, seed: int = 0,
             device="cuda"):
    """A small dense synthetic DAR (same generator shape as bench.py's
    build_table) — big enough that chunk scans and kernel costs are
    representative, small enough to build in well under a second —
    on `device`."""
    from dss_tpu_torch.dar.oracle import Record
    from dss_tpu_torch.dar.snapshot import DarTable

    rng = np.random.default_rng(seed)
    keys = np.sort(
        rng.integers(0, n_cells, (n_entities, kpe)).astype(np.int32),
        axis=1,
    )
    alt_lo = rng.uniform(0, 3000, n_entities).astype(np.float32)
    alt_hi = alt_lo + rng.uniform(10, 600, n_entities).astype(np.float32)
    t0 = NOW + rng.integers(-4, 4, n_entities) * HOUR
    t1 = t0 + rng.integers(1, 6, n_entities) * HOUR
    records = [
        Record(
            entity_id=f"e{i}",
            keys=keys[i],
            alt_lo=float(alt_lo[i]),
            alt_hi=float(alt_hi[i]),
            t_start=int(t0[i]),
            t_end=int(t1[i]),
            owner_id=i & 0xFFFF,
        )
        for i in range(n_entities)
    ]
    table = DarTable(device=device, delta_capacity=4096)
    table.bulk_load(records)
    return table


def _query_batch(seed: int, batch: int, n_cells: int, width: int = 8):
    r = np.random.default_rng(seed)
    start = r.integers(0, max(1, n_cells - width), batch)
    qkeys = (start[:, None] + np.arange(width)[None, :]).astype(np.int32)
    alo = r.uniform(0, 3000, batch).astype(np.float32)
    t0 = NOW + r.integers(-2, 2, batch) * HOUR
    return (
        qkeys,
        alo,
        (alo + 300.0).astype(np.float32),
        t0.astype(np.int64),
        (t0 + HOUR).astype(np.int64),
    )


def _median_ms(samples: List[float]) -> float:
    return sorted(samples)[len(samples) // 2] * 1000.0


# -- measurements --------------------------------------------------------------


def measure_chunk_ms(ft, n_cells: int, *, reps: int = 5,
                     batch: int = 256) -> float:
    """One warmed-bucket exact host scan (the hostchunk route's unit
    cost): a `batch`-query forced chunked scan, divided by its chunk
    count.  Median over reps."""
    qb = _query_batch(11, batch, n_cells)
    chunks = -(-batch // ft.HOST_MAX_BATCH)
    ft.query_host_chunked(*qb, now=NOW)  # warm the scan path
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        ft.query_host_chunked(
            qb[0], qb[1], qb[2], qb[3] + i, qb[4] + i, now=NOW
        )
        ts.append(time.perf_counter() - t0)
    return _median_ms(ts) / chunks


def measure_device(ft, n_cells: int, *, reps: int = 4,
                   sizes=(128, 1024)) -> Dict[str, float]:
    """Cold fused-kernel dispatch floor + per-item slope: synchronous
    submit+collect at two batch sizes, two-point fit (the same model
    the online EWMA converges to — floor = t1 - item*n1).  Each submit
    launches B1 eagerly; collect waits on its event, so the wall time
    spans the device work."""
    med = {}
    for n in sizes:
        qb = _query_batch(13 + n, n, n_cells)
        ft.collect(ft.submit(*qb, now=NOW))  # warm the jit bucket
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            ft.collect(
                ft.submit(
                    qb[0], qb[1], qb[2], qb[3] + i, qb[4] + i, now=NOW
                )
            )
            ts.append(time.perf_counter() - t0)
        med[n] = _median_ms(ts)
    n1, n2 = min(sizes), max(sizes)
    item = max(0.0, (med[n2] - med[n1]) / max(1, n2 - n1))
    floor = max(0.05, med[n1] - item * n1)
    return {
        "floor_ms": floor,
        "item_ms": item,
        "batch_ms": {str(k): round(v, 3) for k, v in med.items()},
    }


def measure_resident(ft, n_cells: int, *, depths=(2, 4, 8),
                     batch: int = 128,
                     window_bucket: int = 256) -> Dict[str, object]:
    """Resident stream: amortized per-batch gap at each stream depth
    (submits issued back-to-back before any collect — the feeder
    loop's steady state) + the single-batch submit->delivered latency.
    The chosen DSS_CO_RES_INFLIGHT is the KNEE: the smallest depth
    within 10% of the best amortized gap (a deeper stream buys nothing
    but queue wait).

    On the port the resident executable is a CUDA graph of B1
    (ops/resident.py).  A graph is keyed by the submit's own window
    bucket, so the warm captures the bucket this batch lands in (at
    least `window_bucket`), with one replay unit per batch of the
    deepest rung: every submit of the ladder replays a graph, none
    falls back to an eager launch on a busy entry.  The warm's keys
    are reserved, so the cache's bound never evicts them mid-ladder.
    `aot_compile_ms` (the profile's key) is the capture time."""
    from dss_tpu_torch.ops.fastpath import pow2_bucket
    from dss_tpu_torch.ops.resident import ResidentKernel

    qb = _query_batch(17, batch, n_cells)
    wins = ft._pack_windows(qb[0])[0]
    wb = max(int(window_bucket), 0 if wins is None else wins.shape[1])
    kern = ResidentKernel(autocompile=False, instances=max(depths))
    compile_t0 = time.perf_counter()
    kern.warm(
        ft, batch_buckets=(pow2_bucket(batch, lo=16),),
        window_buckets=(wb,),
    )
    compile_ms = (time.perf_counter() - compile_t0) * 1000.0
    ft.collect(ft.submit(*qb, now=NOW, kernel=kern))  # warm

    # single-batch latency through the resident executable
    lat = []
    for i in range(4):
        t0 = time.perf_counter()
        ft.collect(
            ft.submit(
                qb[0], qb[1], qb[2], qb[3] + i, qb[4] + i,
                now=NOW, kernel=kern,
            )
        )
        lat.append(time.perf_counter() - t0)
    lat_ms = _median_ms(lat)

    gaps = {}
    for d in depths:
        t0 = time.perf_counter()
        pend = [
            ft.submit(
                qb[0], qb[1], qb[2], qb[3] + i, qb[4] + i,
                now=NOW, kernel=kern,
            )
            for i in range(d)
        ]
        for p in pend:
            ft.collect(p)
        gaps[d] = (time.perf_counter() - t0) / d * 1000.0
    best = min(gaps.values())
    knee = next(d for d in sorted(gaps) if gaps[d] <= 1.1 * best)
    return {
        "gap_ms_by_depth": {str(d): round(g, 3) for d, g in gaps.items()},
        "lat_ms": lat_ms,
        "floor_ms": max(0.02, min(gaps.values())),
        "inflight": int(knee),
        "ring": int(min(128, max(16, 8 * knee))),
        "aot_compile_ms": round(compile_ms, 1),
    }


def measure_shm(*, depths=(16, 64, 256),
                slot_bytes=(16384, 32768, 65536),
                calls: int = 200, threads: int = 4,
                covering: int = 128, hits: int = 32) -> Dict[str, object]:
    """Shared-memory ring sweep (parallel/shmring.py): measured round
    trips through a REAL region file + owner drain with a trivial
    serve_fn, so the number is the IPC mechanics (slot codec, publish,
    scan, wake) and nothing else.

    DSS_SHM_DEPTH is the knee of the concurrent-throughput ladder (the
    smallest depth within 5% of the best aggregate qps — deeper rings
    buy nothing but memory and reclaim scans).  DSS_SHM_SLOT_BYTES is
    the smallest slot within 10% of the best serial RTT that still
    fits 4x the representative covering (headroom for bulk searches
    before the proxy fallback).  DSS_SHM_RTT_MS seeds the worker
    front's shm-vs-proxy cost model (plan/shmroute.WorkerCostModel)."""
    import tempfile
    import threading as _threading

    from dss_tpu_torch.parallel import shmring

    ids = [f"00000000-0000-4000-8000-{i:012d}" for i in range(hits)]
    t1s = list(range(hits))
    cells = np.arange(covering, dtype=np.uint64)

    def serve(req):
        return ids, t1s, 1

    def _run(depth: int, slot: int):
        d = tempfile.mkdtemp(prefix="dss-shm-sweep-")
        path = os.path.join(d, "ring.shm")
        region = shmring.ShmRegion.create(
            path, nworkers=1, depth=depth, slot_bytes=slot,
            fence_slots=1 << 12,
        )
        owner = shmring.ShmOwner(region, serve, threads=2)
        owner.start()
        wregion = shmring.ShmRegion.open_existing(path)
        client = shmring.ShmWorkerClient(wregion, 0, wait_s=10.0)
        try:
            for _ in range(10):  # page-fault + path warm
                client.call(cls="isa", cells=cells, now_ns=NOW)
            lat = []
            for _ in range(calls // 4):
                t0 = time.perf_counter()
                client.call(cls="isa", cells=cells, now_ns=NOW)
                lat.append(time.perf_counter() - t0)
            rtt_ms = _median_ms(lat)

            per_thread = max(1, calls // threads)

            def worker():
                for _ in range(per_thread):
                    try:
                        client.call(
                            cls="isa", cells=cells, now_ns=NOW
                        )
                    except shmring.RingFull:
                        pass

            t0 = time.perf_counter()
            ths = [
                _threading.Thread(target=worker)
                for _ in range(threads)
            ]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            qps = (threads * per_thread) / max(
                time.perf_counter() - t0, 1e-9
            )
            return rtt_ms, qps
        finally:
            client.close()
            owner.close()
            wregion.close()
            region.close()
            try:
                os.unlink(path)
                os.rmdir(d)
            except OSError:
                pass

    mid_slot = slot_bytes[len(slot_bytes) // 2]
    by_depth = {d: _run(d, mid_slot) for d in depths}
    best_qps = max(q for _, q in by_depth.values())
    knee_depth = next(
        d for d in sorted(by_depth)
        if by_depth[d][1] >= 0.95 * best_qps
    )
    by_slot = {s: _run(knee_depth, s)[0] for s in slot_bytes}
    fits = [
        s for s in sorted(by_slot)
        if s >= 4 * covering * 8 + 256
    ] or [max(slot_bytes)]
    best_rtt = min(by_slot[s] for s in fits)
    slot_pick = next(
        s for s in sorted(fits) if by_slot[s] <= 1.1 * best_rtt
    )
    return {
        "rtt_ms_by_depth": {
            str(d): round(r, 4) for d, (r, _) in by_depth.items()
        },
        "qps_by_depth": {
            str(d): round(q, 1) for d, (_, q) in by_depth.items()
        },
        "rtt_ms_by_slot": {
            str(s): round(r, 4) for s, r in by_slot.items()
        },
        "depth": int(knee_depth),
        "slot_bytes": int(slot_pick),
        "rtt_ms": round(by_depth[knee_depth][0], 4),
    }


def measure_hit_concentration(ft, n_cells: int, *, batch: int = 256,
                              max_results: int = 512) -> Dict[str, int]:
    """Per-query unique-hit distribution of the synthetic workload:
    the base for the sharded replica's per-shard result capacity
    (DSS_SHARD_RESULTS).  p99.9 x 2 headroom, clamped to
    [16, max_results] — the boundary-aware autotune in
    parallel/replica.py then raises it toward max_results whenever the
    predicted per-shard load share concentrates (a hot move must not
    re-open the overflow->exact-scan risk)."""
    qb = _query_batch(19, batch, n_cells)
    qidx, _slots = ft.query_fused(*qb, now=NOW)
    per_q = np.bincount(np.asarray(qidx, np.int64), minlength=batch)
    p999 = int(np.percentile(per_q, 99.9)) if len(per_q) else 0
    rec = int(min(max_results, max(16, 2 * p999)))
    return {
        "hits_p50": int(np.percentile(per_q, 50)),
        "hits_p999": p999,
        "shard_results": rec,
    }


# -- the sweep -----------------------------------------------------------------


def scenario_shapes(*, seed: int = 7, scale: float = 0.05,
                    duration_s: float = 8.0, names=None) -> dict:
    """Derive the city-scale mixed-workload SHAPE SET from the
    scenario generator (dss_tpu_torch/scenario): per-tag request mix
    (read/write split) and the covering-size distribution of the
    query volumes the scenarios actually poll.  These are the shapes
    the measured sweep below costs — so the emitted profile (and the
    region-level capacity_weight the federation map planner consumes)
    reflects city-scale traffic, not just the synthetic width-8
    microbench queries."""
    from dss_tpu_torch.geo import covering as geo_covering
    from dss_tpu_torch.scenario import generator as scen

    names = list(names or scen.SCENARIOS)

    def polygon_cells(node) -> Optional[int]:
        """Covering size of the first polygon found in a request
        body (outline_polygon / footprint vertices)."""
        if isinstance(node, dict):
            verts = node.get("vertices")
            if isinstance(verts, list) and len(verts) >= 3 and all(
                isinstance(v, dict) and "lat" in v for v in verts
            ):
                area = ",".join(
                    f"{v['lat']},{v['lng']}" for v in verts
                )
                try:
                    return int(
                        len(geo_covering.area_to_cell_ids(area))
                    )
                except Exception:  # noqa: BLE001 — oversized/degenerate
                    return None
            for v in node.values():
                got = polygon_cells(v)
                if got is not None:
                    return got
        elif isinstance(node, list):
            for v in node:
                got = polygon_cells(v)
                if got is not None:
                    return got
        return None

    mix: Dict[str, int] = {}
    reads = writes = 0
    widths: List[int] = []
    for name in names:
        sc = scen.build_scenario(name, seed=seed, scale=scale,
                                 duration_s=duration_s)
        for phase in sc.phases:
            for r in phase.requests:
                mix[r.tag] = mix.get(r.tag, 0) + 1
                is_read = r.method == "GET" or r.path.endswith("/query")
                if is_read:
                    reads += 1
                    n = None
                    if r.body is not None:
                        n = polygon_cells(r.body)
                    elif "area=" in r.path:
                        try:
                            n = len(geo_covering.area_to_cell_ids(
                                r.path.split("area=", 1)[1]
                            ))
                        except Exception:  # noqa: BLE001
                            n = None
                    if n:
                        widths.append(n)
                else:
                    writes += 1
    if not widths:
        widths = [8]
    w = np.sort(np.asarray(widths))
    total = max(1, reads + writes)
    return {
        "scenarios": names,
        "seed": seed,
        "scale": scale,
        "requests": int(total),
        "read_frac": round(reads / total, 4),
        "mix": dict(sorted(mix.items())),
        "covering_cells": {
            "p50": int(w[len(w) // 2]),
            "p90": int(w[int(len(w) * 0.9)]),
            "max": int(w[-1]),
        },
    }


def measure_scenario_ms(ft, n_cells: int, shapes: dict, *,
                        reps: int = 3, batch: int = 64) -> dict:
    """Cost the scenario shape set on the MEASURED host kernel: forced
    chunked exact scans at the scenario's covering-width percentiles
    (p50 / p90 weighted 80/20 — the poll-heavy body and the heavy
    tail), yielding a scenario-weighted per-request service time and
    its qps scalar.  This is what capacity_weight is computed from
    when the scenario sweep runs: a host's relative capacity under
    city-scale traffic, measured, not assumed."""
    cc = shapes["covering_cells"]
    per_width: Dict[str, float] = {}
    for label, width in (("p50", cc["p50"]), ("p90", cc["p90"])):
        width = max(1, min(int(width), 512))
        r = np.random.default_rng(17)
        start = r.integers(0, max(1, n_cells - width), batch)
        qkeys = (
            start[:, None] + np.arange(width)[None, :]
        ).astype(np.int32)
        alo = r.uniform(0, 3000, batch).astype(np.float32)
        t0 = NOW + r.integers(-2, 2, batch) * HOUR
        args = (qkeys, alo, (alo + 300.0).astype(np.float32),
                t0.astype(np.int64), (t0 + HOUR).astype(np.int64))
        ft.query_host_chunked(*args, now=NOW)  # warm
        ts = []
        for i in range(reps):
            t0c = time.perf_counter()
            ft.query_host_chunked(
                args[0], args[1], args[2], args[3] + i, args[4] + i,
                now=NOW,
            )
            ts.append(time.perf_counter() - t0c)
        per_width[label] = _median_ms(ts) / batch
    weighted_ms = 0.8 * per_width["p50"] + 0.2 * per_width["p90"]
    return {
        "per_query_ms": {k: round(v, 5) for k, v in per_width.items()},
        "weighted_ms": round(weighted_ms, 5),
        "scenario_qps": round(1000.0 / max(weighted_ms, 1e-4), 2),
    }


def autotune(*, quick: bool = False, entities: Optional[int] = None,
             cells: Optional[int] = None,
             scenario: bool = True, device="cuda") -> dict:
    """Run the measured sweep on this host and return a profile dict.

    quick=True is the CI smoke grid: a tiny fixture, two stream
    depths, minimal reps — deterministic shape, seconds of wall
    clock.  The full sweep uses a denser fixture and deeper stream
    ladder.  The device measurements run on `device` (the card unless
    the caller names the CPU, where B1's plain version answers and
    the numbers describe nothing but the CPU)."""
    from dss_tpu_torch.ops.fastpath import resolve_device

    device = resolve_device(device)
    n_ent = entities or (2_000 if quick else 50_000)
    n_cel = cells or (2_000 if quick else 20_000)
    depths = (2, 4) if quick else (2, 4, 8, 16)
    reps = 3 if quick else 6

    t_all = time.perf_counter()
    table = _fixture(n_ent, n_cel, device=device)
    scen_shapes = scen_ms = None
    try:
        ft = table._state.snap.fast
        chunk_ms = measure_chunk_ms(ft, n_cel, reps=reps)
        dev = measure_device(ft, n_cel, reps=max(3, reps - 2))
        res = measure_resident(
            ft, n_cel, depths=depths,
            batch=128, window_bucket=256,
        )
        conc = measure_hit_concentration(ft, n_cel)
        shm = measure_shm(
            depths=(16, 64) if quick else (16, 64, 256),
            slot_bytes=(16384, 32768) if quick
            else (16384, 32768, 65536),
            calls=60 if quick else 200,
        )
        if scenario:
            # city-scale load shapes from the scenario generator: the
            # mixed-workload sweep that grounds capacity_weight in
            # measured scenario traffic
            scen_shapes = scenario_shapes(
                scale=0.02 if quick else 0.05,
                duration_s=4.0 if quick else 8.0,
            )
            scen_ms = measure_scenario_ms(
                ft, n_cel, scen_shapes, reps=reps,
            )
    finally:
        table.close()

    # AOT bucket grids: resident batches land in pow2 buckets between
    # the host cutoff and the AIMD max drain; window buckets cover the
    # candidate windows the fixture actually produced, extended upward
    # (bigger tables only grow the window).  The quick grid stays tiny
    # so the smoke's warm pass is deterministic seconds, not minutes.
    if quick:
        batch_buckets = "128,512"
        window_buckets = "256,4096"
    else:
        batch_buckets = "128,512,2048,4096"
        window_buckets = "256,1024,4096,16384,65536"

    knobs = {
        "DSS_CO_EST_CHUNK_MS": round(chunk_ms, 4),
        "DSS_CO_EST_FLOOR_MS": round(dev["floor_ms"], 3),
        "DSS_CO_EST_ITEM_MS": round(dev["item_ms"], 5),
        "DSS_CO_EST_RES_FLOOR_MS": round(res["floor_ms"], 3),
        "DSS_CO_EST_RES_LAT_MS": round(res["lat_ms"], 3),
        "DSS_CO_RES_INFLIGHT": res["inflight"],
        "DSS_CO_RES_RING": res["ring"],
        "DSS_RES_BATCH_BUCKETS": batch_buckets,
        "DSS_RES_WINDOW_BUCKETS": window_buckets,
        "DSS_SHARD_RESULTS": conc["shard_results"],
        "DSS_SHM_DEPTH": shm["depth"],
        "DSS_SHM_SLOT_BYTES": shm["slot_bytes"],
        "DSS_SHM_RTT_MS": shm["rtt_ms"],
    }
    # this host's relative serving capacity: with the scenario sweep,
    # the measured city-scale mixed-workload qps scalar (the same
    # number the federation map planner weighs region key runs by);
    # without it, the legacy synthetic chunk-qps scalar.  The basis is
    # recorded so mixed fleets can tell profiles apart.
    if scen_ms is not None:
        capacity = scen_ms["scenario_qps"]
        capacity_basis = "scenario-mix"
    else:
        capacity = round(64.0 / max(chunk_ms, 1e-3), 2)
        capacity_basis = "chunk-qps"
    measurements = {
        "chunk_ms": round(chunk_ms, 4),
        "device": dev,
        "resident": res,
        "hit_concentration": conc,
        "shm_ring": shm,
    }
    if scen_ms is not None:
        measurements["scenario"] = dict(scen_ms, shapes=scen_shapes)
    return {
        "format": PROFILE_FORMAT,
        "host_class": host_class(device=device),
        # wall-clock provenance: boot warns when a profile is stale or
        # from another host class, and exports the age as the
        # dss_autotune_profile_age_s gauge (DssAutotuneStale material)
        "measured_at": time.time(),
        "quick": bool(quick),
        "fixture": {"entities": n_ent, "cells": n_cel},
        "sweep_s": round(time.perf_counter() - t_all, 2),
        "capacity_weight": capacity,
        "capacity_basis": capacity_basis,
        "knobs": knobs,
        "measurements": measurements,
    }


# -- persistence / boot application --------------------------------------------


def capacity_vector(profiles: List[dict]) -> np.ndarray:
    """Assemble the member-capacity vector (weighted_boundaries
    `member_capacity` / FederationMap region capacity_weights) from
    per-host profiles, refusing MIXED capacity bases: a scenario-mix
    qps scalar next to a legacy chunk-qps scalar differs by orders of
    magnitude and would silently skew placement.  Re-run autotune on
    the stragglers instead."""
    if not profiles:
        raise ValueError("no profiles")
    bases = {
        str(p.get("capacity_basis", "chunk-qps")) for p in profiles
    }
    if len(bases) > 1:
        raise ValueError(
            f"mixed capacity_basis across member profiles "
            f"({sorted(bases)}): re-run autotune so every member "
            f"measures the same basis"
        )
    return np.asarray(
        [float(p["capacity_weight"]) for p in profiles], np.float64
    )


def save_profile(profile: dict, path: Optional[str] = None,
                 device="cuda") -> str:
    path = path or default_profile_path(device=device)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(profile, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_profile(path: str) -> dict:
    with open(path) as f:
        profile = json.load(f)
    if not isinstance(profile, dict) or "knobs" not in profile:
        raise ValueError(f"{path}: not an autotune profile (no knobs)")
    fmt = int(profile.get("format", 0))
    if fmt > PROFILE_FORMAT:
        raise ValueError(
            f"{path}: profile format {fmt} is newer than this binary "
            f"({PROFILE_FORMAT})"
        )
    return profile


def profile_staleness(profile: dict, *,
                      now: Optional[float] = None,
                      device="cuda") -> dict:
    """How much to trust a loaded profile: its age in seconds (0.0
    for pre-provenance profiles that never recorded measured_at — age
    unknown, treated as fresh rather than infinitely stale so old
    profiles keep booting) and whether it was measured on THIS host
    class.  The server logs a loud warning on either mismatch and
    exports the age as dss_autotune_profile_age_s.  The host class
    compared is that of `device`."""
    now = time.time() if now is None else float(now)
    here = host_class(device=device)
    measured_at = profile.get("measured_at")
    age_s = 0.0
    if measured_at is not None:
        try:
            age_s = max(0.0, now - float(measured_at))
        except (TypeError, ValueError):
            age_s = 0.0
    prof_hc = str(profile.get("host_class", ""))
    return {
        "age_s": age_s,
        "has_timestamp": measured_at is not None,
        "profile_host_class": prof_hc,
        "host_class": here,
        "host_class_match": (not prof_hc) or prof_hc == here,
    }


def apply_profile(profile: dict, env=None) -> Dict[str, str]:
    """Seed serving knobs from a profile with env-over-profile
    precedence: only UNSET variables are written (setdefault), so an
    operator's explicit DSS_* override always wins, and only the
    known KNOB_KEYS are ever touched.  Returns what was applied."""
    env = os.environ if env is None else env
    applied: Dict[str, str] = {}
    for k, v in profile.get("knobs", {}).items():
        if k not in KNOB_KEYS or k in env:
            continue
        env[k] = str(v)
        applied[k] = str(v)
    return applied

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check every answer.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card identity (nvidia-smi name and power limit);
  2. build every kernel of dss_tpu_torch/csrc, one nvcc per source, all
     at once;
  3. load 1M operational intents (8 level-13 cells each over a 200k-cell
     metro region, 8M postings) into a CudaSpatialIndex on the card and
     into a device="cpu" twin that runs the plain versions; every table
     carries the exact block columns and the quantized p3 columns;
  4. B1, the fused window filter, against its plain version on the card:
     edge cases (lane 31, empty windows, pad windows, overflow, max_words
     at 0, 1 and around the true word count), an output handed back
     dirty by the allocator, 40 launches back to back, and one
     8192-query batch at the main path's shapes, with its times and the
     bound;
  5. the main path with launch counts reset: batches of 8192 conflict
     queries through DarTable.query_many, two of them run once plain and
     once under torch.profiler (the device's busy time over the plain
     run's wall time, and its time by kernel),
     single CudaSpatialIndex requests, >= 1k upserts and removes, a
     minor fold, a compaction and more batches — every answer held
     exactly against the CPU twin, a sample against the oracle;
  6. the legacy quantized-mask path on the compacted 1M-intent L0 table:
     B2 against its plain version (edge cases + the headline batch);
     4 batches of 8192 queries through FastTable.query_batch on both
     routes (B2 kernel and the matmul words) and exact_filter, held
     against each other, the CPU twin, the fused path's pair set and the
     oracle; B3 and B4 against their plain versions
     over a fixed list of edge cases (mask_cases(): NW = 1, 31, 32, 33
     and 512, every window on one block, block indices of -1 and NB,
     pad keys of -2, start == end, [0, 128) and a range inside one
     four-lane group, i64 times at +-2^63), on outputs handed back dirty
     and over 40 launches back to back; B3's and B4's own entries driven
     on each batch's first 512 windows against the twin; then B3 and B4
     against their plain versions at the headline, with times and
     bounds;
  7. the serving path on the compacted 1M-intent index: the resident
     loop's CUDA graph grid (batch buckets 128/1024/4096 x window
     buckets 4096/16384/65536, bench.py:375-379) captured and timed;
     at every warmed bucket one batch three ways (graph replay, eager
     B1, plain version) equal word for word, two units in flight, and
     a replay's call and device time beside the eager call's; then
     closed-loop clients through CudaSpatialIndex.query_ids with a
     50 ms SLO (bench.py:433-470): 4 threads, then 32, each leg with
     the launch counts from zero, one `serving` line per leg, and a
     seeded sample of 4,096 answers per leg held against the CPU twin;
     then the reference's bulk stale drain (bench.py:1157-1186), 16
     bursts of 128 bounded-staleness callers, every answer held against
     the twin, one `bulk_burst` line;
  8. the store: a WAL of 60k SCD operational intents (8 contiguous
     level-13 cells each, 10-600 m bands, 1-5 h windows), the RID poll
     recipe's 4,000 ISAs over 512 areas, and a few hundred RID
     subscriptions, SCD subscriptions and constraints, written with
     the port's codec and WriteAheadLog; DSSStore(storage="cuda")
     booted from it (`store_boot`: records, seconds, records/s, each
     class's tiers and live records, MiB on the card once the
     background folds settle, and when the constructor returned); the
     resident graph grid warmed (`store_graph_warm`: entries beside
     the cache's bound, reservations and capture failures, and the
     entries the reference would build for the same tables);
     with B1's counts from zero, 512 seeded search_operations held
     against the oracle at the store clock (`store_oracle`), the bulk
     stale drain through the store (8 bursts of 128 allow_stale
     callers, `store_burst`), 1,200 writes (OVN-keyed upserts keyed
     from a prior search, a third of the new ones one OVN short and
     refused, fenced updates, deletes, subscriptions; `store_writes`),
     a reboot from the same WAL compared with the live store
     (`store_reboot`: the time to recover), and the RID poll recipe
     through store.rid.search_isas, cache on then off, against a
     memory twin that takes the same writes (`store_poll`); B1's eager
     launches and graph replays in the phase, per entity class
     (`store_b1_by_class`);
  9. the services over the same store: RIDService and SCDService, 256
     ISA searches held against the memory twin and 256 operational-
     intent queries (the service's own request dicts) against the
     oracle, one caller at a time, then the bulk stale drain through
     SCDService.search_operations (allow_stale=True), 8 bursts of 128
     callers; the `services` line (searches/s, p50/p99, the bursts'
     route mix, B1's launches and replays from zero, mismatches);
 10. the tuner (scenario/, plan/autotune.py, tune/): in the store phase,
     before its store closes, the live loop (the store reseeded to the
     coalescer's default 20 ms floor, a TuneController attached through
     attach_tuner on a fake clock ticked by hand as bench.py's
     tune_smoke_leg does: windows of 8 bulk stale drains of 128, every
     answer against the oracle, until the first committed proposal or
     14 windows) and the leg's three drills (a seeded FaultPlan at
     tune.apply, a bad estimate the shadow rejects, a plausible lie the
     guard window rolls back while a seeded FaultPlan delays every cold
     dispatch); after the store phase, autotune(quick=False) on the
     card at its 50,000 x 20,000 fixture, saved and loaded back, its
     batches through B1 against a CPU twin and the oracle, then
     bench.py autotune_leg's cold start (100,000 x 40,000, 8 threads,
     8 s, default against profiled seeds in turns); after the http
     phase, the server with --autotune_profile <the sweep's file>
     --self_tune on its WAL (/healthy, the profile's age, the armed
     tuner and its knobs in /metrics, 32 queries against the oracle,
     SIGTERM); B1's eager launches and replays of each part from zero;
     the `tuner` line;
 11. the server entry as a process on the card, `python3 -m
     dss_tpu_torch.cmds.server --storage cuda`, booted from a WAL of
     50,000 operational intents and the poll recipe's 4,000 ISAs and
     driven over HTTP with urllib: an ISA's PUT/GET/search/DELETE, an
     operational intent PUT with its key, queried, updated, DELETEd,
     256 queries held against the oracle, /metrics and /status, a 3 s
     closed loop of 8 clients, then SIGTERM within --shutdown_grace;
     the `http` line (boot, the boot warm's end, entries and capture
     failures from /metrics, the loop's rate and p50/p99, the route
     mix); it does not run, and says so, where aiohttp is missing;
 12. the shared-memory serving front, `python3 -m dss_tpu_torch.cmds.server
     --storage cuda --workers 4`, booted from the http phase's WAL: the
     leader owns the card, its four read workers run `--device cpu`;
     the reference's shm-smoke drill (bench.py:3339-3590) over
     keep-alive connections pinned to each worker and to the leader's
     loopback port (a burst through the ring equal to the leader and
     the oracle, worker cache hits, a write fencing exactly its cells,
     read-your-writes, a SIGKILLed worker with 0 5xx from the
     survivors, reclaimed, respawned and revived, the ladder HEALTHY,
     SIGTERM with searches in flight), closed loops of 8 and 32 client
     processes beside the http phase's `--workers 0` loops of the same
     clients, the leader's account of the front from /metrics, and
     nvidia-smi's compute apps with each process's /dev/nvidia
     descriptors (the leader alone on the card); the `shm_front` line;
 13. the mesh route (parallel/{mesh, sharded, replica} over K1
     `mesh_query` and K2 `mesh_merge`, csrc/mesh_query.cu; no B1): after
     the legacy path, K1 and K2 against their plain versions on the card
     over a fixed list of edge cases (mesh_cases(): P = 0 and all-pad
     keys, n_unique at R-1, R and R+1, a slot in several cells and in
     base and delta, the owner filter on and off, now past t_end, the
     count mode, K*cap and n_sp*sr past a block's shared memory), on
     outputs handed back dirty and over 40 launches back to back; then
     ShardedDar over the main path's 1M live records on a 1x1 mesh and
     on a virtual 2x4 mesh of the card (eight positions on one H100),
     four headline batches each with the launch counts from zero, held
     to each other slot for slot, to B1's answers as id sets and to
     oracle.search on 256 queries, and every batch's dp rows through K1
     and K2 and through their plain versions on the same tensors; build
     s, MiB, batch p50, device time by op beside the bound (the real
     candidates of the batch, the padded formula beside it), overflow
     fallbacks, shard_hits; K1's and K2's own times at both meshes; the
     module's conflict_query_batch and max_count_per_cell on the same
     tensors; then the reference's skew leg (bench.py:2424-2600: 3,000
     cold and 120 hot records, 64 areas, 250 serial queries per Zipf
     alpha 0, 0.8, 1.2, a virtual 1x8 mesh, shard_results 48) with
     rebalancing off and on, answers equal, and its 64 areas at once
     through K1 and K2 against their plain versions; in the store phase, a
     replica on a virtual 1x2 mesh tailing the store's WAL attached to
     its coalescers, and 16 bulk stale drains of 128 that must ride it
     (mesh_offloads) with the local path's answers; after the shm
     front, the server binary with `--sharded_replica 1,2
     --virtual_devices 2` on the http phase's WAL: every
     /aux/v1/replica/<surface> against its store route once synced, 8
     ops and three subscriptions written and read back, K1's and K2's
     launches from its /metrics, SIGTERM exit 0, and whether the
     server's fault handler printed any stacks; the `mesh` line;
 14. the DSS Region (region/, cmds/region_server, the store's region
     mode), after the mesh server, on the http phase's 24,800 records:
     a region log seeded offline through the port's RegionLog (one
     entry a record, the snapshot 800 entries before the head); the
     port's region_server as a primary with two --mirror_of mirrors at
     --quorum 2 and a shared token (tests/e2e/test_failover.py:69);
     two server processes with --region_url <primary>,<mirror>,<mirror>
     (deploy/k8s/dss.yaml's two replicas) and an in-process
     DSSStore(storage="cuda", region_url=...) booting at once from
     snapshot + tail; a write on A read on B, a conflicting op refused
     across instances, concurrent writers converging; 200 writes on A
     each polled on B (write-to-visible p50/p99); 256 op queries per
     instance against the oracle and the in-process store's 8 x 128
     bulk stale drains (B1 from zero); a fenced append and a forced
     resync while a graph warm captures (0 capture failures); the
     snapshot's serialisation and upload; a SIGKILL of the primary
     with writers running, `region_server --promote` of the most
     caught-up mirror, every acknowledged write read back on A and B;
     a late joiner from snapshot + tail; nvidia-smi's compute apps (A,
     B, the joiner and the smoke; no region server); SIGTERM of every
     process, exit 0; the `region` line;
 15. the federation (region/federation.py), after the region phase, on
     the http phase's live state split at its median DAR key into two
     WALs (a record straddling the boundary left out): regions a and b,
     each a DSSStore(storage="cuda") on the card booted from its WAL,
     federated in-process through serve_query/serve_sync with the
     reference dryrun's fault seam; against the merged state, 64 local
     and 256 cross-region op queries, 32 ISA and 32 constraint queries
     over both regions, 8 bulk stale drains of 128 through each
     region's federated store (B1 from zero, per region), a write into
     the other region's airspace (400 with the owner's URLs), the
     mirror's full-state sync timed (serve_sync s and MiB, apply_sync
     s), a seeded FaultPlan partition of b (FEDERATION_DEGRADED, stale
     answers exact against the mirror's synced state, a lag bound below
     the mirror's lag shed with a Retry-After, a remote write 503,
     local queries served), the heal (the ladder back to healthy, b's
     write in the partition seen); then the dryrun's sigkill leg
     (cmds/federation_dryrun) with its two DSS servers on the card:
     0 local 5xx, 0 lost acknowledged writes, bit-identical to the
     merged oracle, the card's memory.used around the servers; the
     `federation` line;
 16. multihost (parallel/multihost.py, cmds/multihost_dryrun), after the
     federation, on the card: the dryrun's legs (run_dryrun with two
     positions a process on the card: one process, two processes
     bit-identical to it, peer loss, a third process joining and
     leaving, capacity weights; placements {0: [0, 1], 1: [2, 3]} and
     after the join {.., 2: [4, 5]}); the serving leg: two processes on a
     global 1x4 mesh (two positions each on the card, gloo on
     host-staged shards) over copies of the http phase's WAL answer 16
     batches of 64 searches per entity class, each answer held against
     a single-process 1x4 ShardedReplica on the card (MULTIHOST_TALLY),
     then the follower is SIGKILLed mid-serve and the leader must report
     dss_multihost_degraded 1 and answer equal from its host map (8
     searches a class: each scans every record in Python) and from a
     local mesh; then two server processes `--storage cuda
     --sharded_replica 1,4 --jax_coordinator ... --multihost_dryrun 2`
     over the same WAL (/healthy, the replica surface against the store
     route, the dss_multihost_* gauges, SIGTERM exit 0); the `multihost`
     line (verdicts, placements, batch p50/p99 two processes against
     one, the cross-process bytes and ms per batch, the kill to
     degraded, each process's card memory, K1's and K2's launches in the
     single process, each worker and the leader server);
 17. the device time of each kernel by device kernel name, the kernels
     line (six kernels; B1's entry with its graph replays, its
     store-phase and its tuner counts; K1's and K2's with their launches
     in each leg: mesh, skew, store drains, server, multihost), with each
     kernel's count of comparisons made
     and of those that disagreed; then the ok line, or exit 1 if any
     comparison disagreed, a kernel of a path never launched, or a
     serving, store, tuner, services or http phase failed (a caller error other than
     OverloadedError or DEADLINE_EXCEEDED, an absorbed device loss, no
     resident batch at 32 threads, no graph replay in the bulk bursts,
     a refused write that should have passed, no B1 launch or replay
     in the store phase or through the services, a graph capture that
     failed, any error, non-2xx answer or unclean exit of the server or
     of the shm front, a mesh function, K1 or K2 that never ran on the
     card, a B1 launch on the mesh route, no mesh offload in the drains, no
     boundary move at the hottest Zipf alpha, or in the region phase a
     lost acknowledged write, no B1 launch on the region store, a
     capture failure, an instance off the card or an unclean exit, or
     in the federation phase no B1 launch on either region's store, a
     ladder that never entered or left FEDERATION_DEGRADED, a local 5xx
     or a lost acknowledged write in the sigkill leg, or in the tuner
     phase no B1 launch or no graph replay in the sweep, no B1 launch
     in the live loop, a profile that does not load back, a drill with
     another verdict than the leg's or a knob not back at its value, a
     cold start pass with an error, or a tuned server without the
     profile's knobs, its age or an armed tuner, or in the multihost
     phase a dryrun leg not ok, another placement, a serving batch
     without a cross-process gather, a leader that never degraded, or
     an unclean exit of a worker or server).
Times: `ms` is a kernel's device time per wrapper call with the L2
flushed (a real batch finds its blocks cold): the kernels, memsets and
copies that 30 calls launched, summed from torch.profiler, over 30;
`warm_ms` the same without the flush; `call_ms` the median of 25 calls
as the caller sees them (CUDA events around each call, a sync after
each), so it holds the wrapper's host work too.  Where the profiler
loses every window of a measure, CUDA events behind a sleep kernel take
it, and the entry's `ms_source` names how each device time was taken.
B1 of another copy of the package is timed by b1_device_time.py.
Runs the port only: imports neither jax nor the reference package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from dss_tpu_torch.dar import oracle
from dss_tpu_torch.dar import tiers
from dss_tpu_torch.dar.index import CudaSpatialIndex
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.pack import pack_records
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.ops import cuda_build
from dss_tpu_torch.ops import fastpath_cuda as fc
from dss_tpu_torch.ops import fused_filter as ff
from dss_tpu_torch.ops import mesh_cuda as mc
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu_torch.ops.fastpath import FastTable, pow2_bucket

HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000
N_ENTITIES = 1_000_000
N_CELLS = 200_000
KPE = 8  # level-13 cells per intent
BATCH = 8192
WIDTH = 8  # cells per conflict query
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FLUSH_BYTES = 128 << 20
LEGACY_BATCHES = 4
GRIDLESS = fc.GRIDLESS_MAX_WINDOWS
# the serving recipe (bench.py:343-379, :433-470, :5392-5429): the SLO,
# the warmed graph grid, and the closed-loop legs as (name, threads,
# warm-up s, timed s).  The recipe's two legs never reach B1: a closed
# loop of 32 callers drains at most 32 queries, and FastTable answers
# any batch of <= 64 from the exact host scan, in the reference too.
SLO_MS = 50.0
GRID_BATCH = (128, 1024, 4096)
GRID_WINDOW = (4096, 16384, 65536)
LEGS = (("light", 4, 2.0, 5.0), ("loaded", 32, 3.0, 8.0))
# the reference's bulk stale drain (bench.py:1157-1186, burst B of the
# curve smoke): 128 bounded-staleness callers, min_batch 128, the
# table's submit held until 80 of them queue, so they drain as one
# batch past the host cutoff and reach B1.  Run BURSTS times, so the
# buckets the first bursts miss are captured and replayed by the next.
# It checks the device routes; it is no serving rate.
BURST_CALLERS = 128
BURST_MIN_BATCH = 128
BURST_QUEUED = 80
BURSTS = 16
QUERIES_PER_CLIENT = 2048  # pregenerated per client thread, cycled
SERVING_SAMPLE = 4096  # answers per leg held against the CPU twin
# the store phase: a WAL of SCD operational intents in the headline
# recipe's geometry (bench.py:61-105, each intent's KPE cells
# contiguous), the RID poll recipe's ISAs (bench.py:796-840, :928-931)
# and a few hundred SCD subscriptions and constraints, booted into
# DSSStore(storage="cuda").  Cut from the north star's 1M
# (BASELINE.json): the boot and the reboot replay one record at a time
# on the host, at 1,800-2,800 records/s on the H100's hosts, and at 1M
# the whole smoke took 1,471 s, past its 1,200 s limit; at 500k it took
# 923 s once the native and push phases came, at 300k up to 890 s once
# the mesh came, so the region phase's room came from here (200k), and
# the multihost phase's (100k): at 200k the smoke took 1,116 s of
# phases with it; at 100k 1,029 and 1,264 s on two H100 hosts, so
# 60k, with the http phase's WAL cut too (PERF.md §4).
STORE_OPS = 60_000
STORE_SUBS = 300  # SCD subscriptions; as many RID subscriptions
STORE_CSTS = 200
POLL_ISAS, POLL_AREAS, POLL_CELLS = 4000, 512, 64
POLL_RATIO, POLL_ZIPF, POLL_THREADS, POLL_SECS = 100, 1.1, 8, 3.0
ORACLE_SAMPLE = 512  # store searches held against the oracle
STORE_BURSTS = 8
STORE_WRITES = 1200
REBOOT_SAMPLE = 256  # searches compared between the live and rebooted store
# the services over the store phase's store, and the server binary as
# a process booted from a WAL of HTTP_OPS intents (cut from the store's
# size so that both phases stay within 120 s; the state of every later
# phase that boots processes from it, each at about 2,000-4,000
# records/s, so cut from 50,000 to keep the smoke inside its limit)
SVC_SAMPLE = 256  # ISA searches, and as many op queries, per phase
HTTP_OPS = 20_000  # the HTTP server's WAL: ops besides the poll ISAs
HTTP_SEARCHES = 256
HTTP_LOOP_CLIENTS, HTTP_LOOP_S = 8, 3.0
HTTP_GRACE_S = 10.0
HTTP_DEVICE = "cuda"  # the server's --device
# closed loops of client PROCESSES (bench.py:689-790: out-of-process
# clients, so client CPU is not billed to the smoke's GIL), each
# thread on one keep-alive connection: HTTP_LOOP_CLIENTS clients, then
# 4x as many, over LOOP_PROCS processes, LOOP_WARM_S + HTTP_LOOP_S
LOOP_PROCS, LOOP_WARM_S = 4, 1.0
LOOP_CLIENTS = (HTTP_LOOP_CLIENTS, 4 * HTTP_LOOP_CLIENTS)
# the shm front (`--workers SHM_WORKERS`) booted from the http phase's
# WAL: the reference's shm-smoke drill (bench.py:3339-3590) and the
# loops above against the front
SHM_WORKERS = 4
SHM_BURST = 64  # op queries, and as many ISA areas, per process
SHM_KILL_BURST_S = 3.0
SHM_RESPAWN_S = 120.0
# the native phase: the main path's batches (seeds 200-207 and the
# three after the fold and the compaction) once with the native host
# halves and once with numpy forced; the host scan at these batch sizes
NATIVE_SEEDS = tuple(range(200, 208)) + (401, 402, 403)
HOST_BATCHES = (1, 16, 64)
HOST_REPS = 30
# the push phase, the reference's fan-out recipe (bench.py:1514-1665):
# PUSH_SUBS RID subscriptions of 8 cells each over one PUSH_CELLS-cell
# area, PUSH_USS webhooks, one warm and PUSH_WRITES timed writes, each
# matching every subscription; then its fan-out smoke (bench.py:
# 1691-1760) with PUSH_SMOKE_SUBS subscriptions over real HTTP
PUSH_SUBS, PUSH_USS, PUSH_CELLS, PUSH_WRITES = 10_240, 32, 256, 8
PUSH_SMOKE_SUBS, PUSH_SMOKE_USS, PUSH_SMOKE_CELLS = 64, 8, 64
PUSH_CRASH_EVENTS = 200
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "fused_window_filter": ("dss_tpu_torch/csrc/fused_filter.cu",
                            "dss_tpu/ops/fastpath_pallas.py:120"),
    "filter_windows": ("dss_tpu_torch/csrc/window_mask.cu",
                       "dss_tpu/ops/fastpath_pallas.py:36"),
    "filter_windows_gridless": ("dss_tpu_torch/csrc/window_mask.cu",
                                "dss_tpu/ops/fastpath_pallas.py:251"),
    "fused_filter_gridless": ("dss_tpu_torch/csrc/fused_filter.cu",
                              "dss_tpu/ops/fastpath_pallas.py:300"),
    # the mesh route's XLA device program (not Pallas): K1 and K2
    "mesh_query": ("dss_tpu_torch/csrc/mesh_query.cu",
                   "dss_tpu/ops/conflict.py:78"),
    "mesh_merge": ("dss_tpu_torch/csrc/mesh_query.cu",
                   "dss_tpu/parallel/sharded.py:368"),
    # K1 with a block of warps an item, for calls of few items
    "mesh_query_spread": ("dss_tpu_torch/csrc/mesh_query.cu",
                          "dss_tpu/ops/conflict.py:78"),
}
MESH_KERNELS = ("mesh_query", "mesh_merge")
SPREAD_KERNEL = "mesh_query_spread"
# the mesh kernels whose launches are counted apart: K1 a warp an item,
# K2, and K1 a block an item
MESH_COUNTED = MESH_KERNELS + (SPREAD_KERNEL,)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_records(n, n_cells, kpe, seed=0):
    """Synthetic dense-urban DAR: n intents, kpe level-13 cells each
    over an n_cells metro region, ~300 m bands, 1-5 h windows.
    -> (records, keys matrix (n, kpe))."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_cells, (n, kpe)).astype(np.int32), axis=1)
    alt_lo = rng.uniform(0, 3000, n).astype(np.float32)
    alt_hi = alt_lo + rng.uniform(10, 600, n).astype(np.float32)
    t0 = NOW + rng.integers(-4, 4, n) * HOUR
    t1 = t0 + rng.integers(1, 6, n) * HOUR
    recs = [
        Record(f"e{i}", keys[i], float(alt_lo[i]), float(alt_hi[i]),
               int(t0[i]), int(t1[i]), i & 0xFFFF)
        for i in range(n)
    ]
    return recs, keys


def make_batch(seed, batch, n_cells, width):
    """An op-intent conflict check: the intent's covering (~width
    contiguous level-13 cells), a 300 m band, a 1 h window."""
    r = np.random.default_rng(seed)
    start = r.integers(0, n_cells - width, batch)
    keys = (start[:, None] + np.arange(width)[None, :]).astype(np.int32)
    alo = r.uniform(0, 3000, batch).astype(np.float32)
    t0 = NOW + r.integers(-2, 2, batch) * HOUR
    return (keys, alo, (alo + 300.0).astype(np.float32),
            t0.astype(np.int64), (t0 + HOUR).astype(np.int64))


def call_ms(fn, reps=25, warm=3):
    """Median ms of one call of fn() as its caller sees it: CUDA events
    around each call, with a sync after each, so the interval holds the
    host work of the wrapper (checks, allocations, the launch) and any
    device time it waits on."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Flush:
    """Copies one 128 MiB scratch over another (256 MB of traffic, five
    times the H100's 50 MB L2) so that the next call finds its inputs
    cold, as a real batch finds the blocks it touches.  The copy shows
    in a profile as a device-to-device memcpy, which no timed call
    makes."""

    EVENT = "Memcpy DtoD"

    def __init__(self, dev):
        self.src = torch.ones(FLUSH_BYTES // 8, dtype=torch.float64,
                              device=dev)
        self.dst = torch.empty_like(self.src)

    def __call__(self):
        self.dst.copy_(self.src)


def device_events(prof):
    """(name, start us, end us) of each device activity in a profile:
    kernels, memsets and copies (not the ranges of record_function)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiled(fn, n, warm=8, tries=5):
    """The device activities of n calls of fn() under torch.profiler ->
    [(name, start us, end us)], or None.  The profiler can miss the
    first device events of a window, or a whole window, so `warm` calls
    run first in the same window, each device kernel launched c times
    per call keeps its last n*c events (c from its count over all
    warm + n calls), and a window that lost more is taken again."""
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + n):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for name, a, b in device_events(prof):
            spans.setdefault(name, []).append((a, b))
        events = []
        for name, ab in spans.items():
            c = round(len(ab) / (warm + n))
            if c == 0 or len(ab) < n * c:
                break
            events += [(name, a, b) for a, b in sorted(ab)[-n * c:]]
        else:
            if events:
                return events
    return None


def event_ms(fn, flush=None, n=30):
    """Device time of one call of fn() from CUDA events recorded around
    each call, while a sleep kernel holds the stream until the host has
    queued every call.  The sleep is sized at twice what n calls took
    the host once, at 2 GHz.  -> (ms, source): source is "events" when
    the sleep outlasted the queueing, so the intervals hold device work
    only, and "events+host" when it did not (fn waits on the card, or
    the host was slower this time), so they hold host time too."""
    t = time.perf_counter()
    for _ in range(2):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t) / 2
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    held = torch.cuda.Event()
    torch.cuda._sleep(int(min(2e9, max(4e7, 2 * n * host_s * 2e9))))
    held.record()
    for a, b in zip(starts, ends):
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    covered = not held.query()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / n
    return ms, "events" if covered else "events+host"


def device_ms(fn, flush=None, n=30):
    """Device time of one call of fn(): the durations of the kernels,
    memsets and copies that n calls launched, from torch.profiler,
    summed and divided by n.  With `flush`, the L2 is overwritten
    before each call and the flush's copies are left out.  Where the
    profiler loses every window, event_ms() measures it instead.
    -> (ms, {device kernel: [ms per call, launches per call]}, source:
    "profiler" or event_ms()'s)."""
    fn()
    torch.cuda.synchronize()

    def call():
        if flush is not None:
            flush()
        fn()

    events = profiled(call, n)
    if events is None:
        ms, source = event_ms(fn, flush, n)
        return ms, {}, source
    by_name = {}
    for name, a, b in events:
        if flush is not None and name.startswith(Flush.EVENT):
            continue
        ms, k = by_name.get(name, (0.0, 0))
        by_name[name] = [ms + (b - a) / 1e3 / n, k + 1]
    for v in by_name.values():
        v[1] //= n
    return sum(ms for ms, _ in by_name.values()), by_name, "profiler"


DEVICE_BY_NAME = {}  # kernel -> its device kernels, cold and warm


def timings(name, fn, plain, flush) -> dict:
    """Kernel `name`'s times, all measured here: the device time of one
    wrapper call with the L2 flushed (`ms`, the headline: a real batch
    finds its blocks cold) and warm, the call time, and the plain
    version's device time (flushed) and call time, with how each device
    time was taken (`ms_source`: "profiler", or event_ms()'s source
    where the profiler lost every window).  The device kernels behind
    each call go to DEVICE_BY_NAME."""
    warm, warm_by, warm_src = device_ms(fn)
    if any(k.startswith(Flush.EVENT) for k in warm_by):
        raise RuntimeError(f"{name} makes the flush's device copies")
    cold, cold_by, cold_src = device_ms(fn, flush)
    plain_cold, plain_by, plain_src = device_ms(plain, flush)
    DEVICE_BY_NAME[name] = {"cold": cold_by, "warm": warm_by,
                            "plain_device_kernels": len(plain_by)}
    return {"ms": cold, "warm_ms": warm, "call_ms": call_ms(fn),
            "plain_ms": plain_cold, "plain_call_ms": call_ms(plain),
            "ms_source": {"ms": cold_src, "warm_ms": warm_src,
                          "plain_ms": plain_src}}


def kernel_args(ft, q):
    """The wrapper's inputs for one batch on FastTable ft, as the
    table's submit() builds them.  -> (args, nw, wins)."""
    qkeys, alo, ahi, ts, te = q
    wins, _, _, nw = ft._pack_windows(qkeys)
    if nw == 0:
        raise RuntimeError("kernel case has no windows")
    dev = ft.device

    def up(a):
        return torch.from_numpy(np.array(a)).to(dev)

    args = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1, up(wins), up(alo),
            up(ahi), up(np.maximum(ts, np.int64(NOW))), up(te))
    return args, nw, wins


class Tally:
    """Counts the comparisons made on one kernel's behalf (its kernel
    against its plain version, and its path's answers against the twin
    and the oracle) and the ones that disagree; main() fails the run
    when any did."""

    def __init__(self, name):
        self.name = name
        self.compared = 0
        self.mismatches = 0

    def check(self, equal: bool, what: str) -> None:
        self.compared += 1
        if not equal:
            self.mismatches += 1
            print(f"MISMATCH ({self.name}): {what}", file=sys.stderr,
                  flush=True)


TALLY = {name: Tally(name) for name in KERNELS}
STORE_TALLY = Tally("store")  # the store phase's answers and state
NATIVE_TALLY = Tally("native")  # native host halves against numpy
PUSH_TALLY = Tally("push")  # matched ids and deliveries


def resolve_max_words(args, nw, spec) -> int:
    """A case's max_words: None for the main path's bucket, an int, or
    "count-1" / "count" / "count+1" around the batch's true word count
    (from the plain version)."""
    if spec is None:
        return pow2_bucket(nw, lo=1 << 16)
    if isinstance(spec, str):
        n = int(ff.fused_window_filter_torch(*args, max_words=0)[0])
        return n + {"count-1": -1, "count": 0, "count+1": 1}[spec]
    return spec


def check_kernel(ft, q, name, max_words=None):
    """Kernel vs plain version on the card, same inputs, tallied: ->
    (max abs error, true word count)."""
    args, nw, _ = kernel_args(ft, q)
    mw = resolve_max_words(args, nw, max_words)
    got = ff.fused_window_filter(*args, max_words=mw)
    want = ff.fused_window_filter_torch(*args, max_words=mw)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    TALLY["fused_window_filter"].check(
        err == 0 and torch.equal(got, want),
        f"kernel case {name}: max abs err {err}")
    return err, int(want[0])


def compaction_checks(cases) -> None:
    """B1's single pass where its own state shows, against its plain
    version, tallied: an output block that the caching allocator hands
    back full of -1 (the kernel must write the zero tail itself), and
    40 launches over the cases on one stream with no sync between them
    (each launch must leave the tile counter and epoch right for the
    next)."""
    tally = TALLY["fused_window_filter"]
    runs = []
    for _, case_ft, q, spec in cases:
        args, nw, _ = kernel_args(case_ft, q)
        mw = resolve_max_words(args, nw, spec)
        runs.append((args, mw, ff.fused_window_filter_torch(*args,
                                                            max_words=mw)))
    args, mw, want = next(r for r in runs if 0 < int(r[2][0]) < r[1])
    ff.fused_window_filter(*args, max_words=mw)
    torch.cuda.synchronize()
    dirty = torch.full((1 + 2 * mw,), -1, dtype=torch.int32,
                       device=args[0].device)
    ptr = dirty.data_ptr()
    del dirty
    got = ff.fused_window_filter(*args, max_words=mw)
    torch.cuda.synchronize()
    n = int(want[0])
    tally.check(got.data_ptr() == ptr, "dirty output: the -1 block was "
                "not handed back, so the case tested nothing")
    tally.check(torch.equal(got, want) and not got[1 + n:1 + mw].any()
                and not got[1 + mw + n:].any(),
                "dirty output: the kernel left -1 in the tail")
    outs = [ff.fused_window_filter(*runs[i % len(runs)][0],
                                   max_words=runs[i % len(runs)][1])
            for i in range(40)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        tally.check(torch.equal(got, runs[i % len(runs)][2]),
                    f"back-to-back launch {i} != plain")


def edge_cases(dev):
    """Small tables for the edge cases -> list of (name, ft, q, mw)."""
    full = [Record(f"f{i}", np.asarray([5], np.int32), 0.0, 100.0,
                   NOW - HOUR, NOW + HOUR, 0) for i in range(300)]
    full_ft = tiers.build_snapshot(full, device=dev).fast

    def one(key, alo, ahi):
        qk = np.full((1, 16), -1, np.int32)
        qk[0, 0] = key
        return (qk, np.asarray([alo], np.float32), np.asarray([ahi], np.float32),
                np.asarray([NOW - HOUR], np.int64), np.asarray([NOW], np.int64))

    recs, _ = make_records(20_000, 3_000, 6, seed=3)
    p = pack_records(recs, pad_postings=False)
    pe = p.post_ent
    live = p.active[pe].copy()
    live[::13] = False  # dead postings: t1 = -(2**62) on the card
    rand_ft = FastTable(
        p.post_key, pe, p.alt_lo[pe], p.alt_hi[pe], p.t_start[pe],
        p.t_end[pe], live, device=dev,
        slot_exact={"alt_lo": p.alt_lo, "alt_hi": p.alt_hi,
                    "t0": p.t_start, "t1": p.t_end, "live": p.active.copy()},
    )
    rq = make_batch(7, 500, 3_000, 8)
    return [
        ("lane31_full_words", full_ft, one(5, -np.inf, np.inf), None),
        ("all_empty_windows", full_ft, one(5, 500.0, 900.0), None),
        ("pad_windows", rand_ft, make_batch(8, 3, 3_000, 2), None),
        ("random_table", rand_ft, rq, None),
        ("overflow", rand_ft, rq, 17),
        ("max_words_0", rand_ft, rq, 0),
        ("max_words_1", rand_ft, rq, 1),
        ("max_words_count-1", rand_ft, rq, "count-1"),
        ("max_words_count", rand_ft, rq, "count"),
        ("max_words_count+1", rand_ft, rq, "count+1"),
    ]


def distinct_lanes(blk, meta) -> int:
    """Distinct (block, lane) pairs that the windows' [start, end)
    ranges cover: queries that share a cell read the same lanes, which
    count once."""
    blk = np.asarray(blk, np.int64)
    meta = np.asarray(meta, np.int64)
    start = meta & 0xFF
    n = np.maximum(((meta >> 8) & 0xFF) - start, 0)
    first = np.repeat(blk * 128 + start, n)
    within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return len(np.unique(first + within))


def bound_ms(q, nw, wins, max_words):
    """B1's least time on the card for this batch: the bytes it must
    move over the memory rate.  Those are 24 B of columns for each
    distinct (block, lane) of the windows, the window list, the query
    bounds and the flat output.  -> (ms, bytes)."""
    lanes = distinct_lanes(wins[0, :nw], wins[1, :nw])
    nbytes = (lanes * 24 + wins.nbytes + len(q[0]) * 24
              + (1 + 2 * max_words) * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def window_mask_bound_ms(win_blk):
    """B2's and B3's least time: 2,560 B of p3 for each distinct block,
    then 24 B of scalars in and 128 B of mask out per window.
    -> (ms, bytes)."""
    nbytes = len(np.unique(win_blk)) * 2560 + len(win_blk) * (24 + 128)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def exact_mask_bound_ms(win_blk, meta):
    """B4's least time: 24 B of columns for each distinct (block, lane)
    of the windows' ranges, then 32 B of scalars in and 128 B of mask
    out per window.  -> (ms, bytes)."""
    nbytes = (distinct_lanes(win_blk, meta) * 24
              + len(win_blk) * (32 + 128))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


class Oracle:
    """oracle.search over the records that share a cell with the query:
    the original rows (keys matrix) minus those rewritten since, plus
    the rewritten ones still present."""

    def __init__(self, recs, keys):
        self.recs, self.keys = recs, keys
        self.changed = {}  # id -> Record, or None when removed

    def cands(self, keys_row) -> list:
        """The live records that may share a cell with keys_row."""
        rows = np.flatnonzero(np.isin(self.keys, keys_row).any(axis=1))
        out = [self.recs[r] for r in rows
               if self.recs[r].entity_id not in self.changed]
        return out + [r for r in self.changed.values() if r is not None]

    def ids(self, keys_row, alo, ahi, ts, te):
        recs = dict(enumerate(self.cands(keys_row)))
        slots = oracle.search(recs, keys_row, float(alo), float(ahi),
                              int(ts), int(te), NOW)
        return sorted(recs[s].entity_id for s in slots)


def card_batch(idx, q):
    """One batch on the card through DarTable.query_many's two halves,
    timed apart: submit (host pack + launch), the wait for the kernel
    and the D2H copy, and collect (decode, tier/overlay merge, id
    lists).  -> (seconds per stage, answers)."""
    keys, alo, ahi, ts, te = q
    t0 = time.perf_counter()
    pq = idx.table.query_many_submit(list(keys), alo, ahi, ts, te, now=NOW)
    t1 = time.perf_counter()
    pq.wait_device()
    t2 = time.perf_counter()
    got = idx.table.query_many_collect(pq)
    t3 = time.perf_counter()
    return {"submit": t1 - t0, "device_wait": t2 - t1, "collect": t3 - t2}, got


def check_batch(twin, q, got, orc=None, sample=0) -> None:
    """The card's answers must equal the twin's exactly, and a sample
    the oracle's."""
    keys, alo, ahi, ts, te = q
    want = twin.table.query_many(list(keys), alo, ahi, ts, te, now=NOW)
    tally = TALLY["fused_window_filter"]
    tally.check(len(got) == len(want), "batch length: card != twin")
    for i, (g, w) in enumerate(zip(got, want)):
        tally.check(g == w, f"card != twin at query {i}")
    for i in range(sample):
        tally.check(got[i] == orc.ids(keys[i], alo[i], ahi[i], ts[i], te[i]),
                    f"card != oracle at query {i}")


def run_batch(idx, twin, q, orc=None, sample=0):
    """One batch on the card, checked (card_batch + check_batch).  ->
    (seconds per stage, hits)."""
    stages, got = card_batch(idx, q)
    check_batch(twin, q, got, orc, sample)
    return stages, sum(len(g) for g in got)


def busy_window(idx, twin, qs, smi) -> dict:
    """One torch.profiler window over the main-path batches qs on the
    card: the device's busy time (the union of its kernels, memsets and
    copies in the window) and its time by device kernel name.  The
    profiler's own host cost is inside the window, so the same batches
    run first without it, and the busy share is the busy time over that
    unprofiled wall time (`device_busy_share`); the share of the
    profiled window is kept beside it.  The answers of both runs are
    held against the twin."""
    t = time.perf_counter()
    plain_run = [card_batch(idx, q)[1] for q in qs]
    wall = time.perf_counter() - t
    for q, got in zip(qs, plain_run):
        check_batch(twin, q, got)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("main_path_batches"):
            answers = [card_batch(idx, q)[1] for q in qs]
    win = next(e for e in prof.events() if e.name == "main_path_batches"
               and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    busy, end, by_name = 0.0, lo, {}
    for name, a, b in sorted(device_events(prof), key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    for q, got in zip(qs, answers):
        check_batch(twin, q, got)
    return {"batches": len(qs), "unprofiled_ms": wall * 1e3,
            "window_ms": (hi - lo) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
            "device_busy_share_of_window": busy / (hi - lo),
            "device_ms_by_name": by_name, "card": smi}


def native_phase(idx, smi) -> tuple:
    """The native host halves at the main path's configuration: the
    NATIVE_SEEDS batches of BATCH queries through DarTable.query_many's
    two halves, each once with dss_tpu_torch.native and once with the
    numpy paths forced (fastpath._NATIVE = (None,)), in turns; every
    answer, and the L0 table's packed windows and decoded (qidx, slot)
    pairs, equal bit for bit.  Then the exact host scan (query_host_auto) on batches of
    HOST_BATCHES queries, and the coverings of the services phase's 256
    polygons (numpy forced through covering._native = None), both ways.
    B1's counts are set to 0 just before and read just after.  ->
    (the `native` line, B1's counts in the phase)."""
    from dss_tpu_torch.geo import covering
    from dss_tpu_torch.ops import fastpath as fp

    ft = idx.table._state.snap.fast
    qs = [make_batch(s, BATCH, N_CELLS, WIDTH) for s in NATIVE_SEEDS]
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    t_all = time.perf_counter()
    runs = {mode: {"stages": [], "answers": [], "packs": [], "pairs": [],
                   "pack_ms": [], "decode_ms": []}
            for mode in ("native", "numpy")}

    def one(mode, q, keep=True):
        fp._NATIVE = None if mode == "native" else (None,)
        try:
            st, got = card_batch(idx, q)
            t = time.perf_counter()
            pack = ft._pack_windows(q[0])
            pack_ms = (time.perf_counter() - t) * 1e3
            pending = ft.submit(*q, now=NOW)
            pending.ready()
            t = time.perf_counter()
            pairs = ft.collect(pending)
            decode_ms = (time.perf_counter() - t) * 1e3
        finally:
            fp._NATIVE = None
        if keep:
            r = runs[mode]
            for k, v in (("stages", st), ("answers", got), ("packs", pack),
                         ("pairs", pairs), ("pack_ms", pack_ms),
                         ("decode_ms", decode_ms)):
                r[k].append(v)

    one("native", qs[0], keep=False)  # warm-up, both ways
    one("numpy", qs[0], keep=False)
    # the two ways in turns, batch by batch, each first on every other
    # batch: the host's drift falls on both alike
    for i, q in enumerate(qs):
        for mode in (("native", "numpy") if i % 2 == 0
                     else ("numpy", "native")):
            one(mode, q)
    for r in runs.values():
        stages = r["stages"]
        r["line"] = {
            "p50_submit_ms": statistics.median(
                st["submit"] for st in stages) * 1e3,
            "p50_device_wait_ms": statistics.median(
                st["device_wait"] for st in stages) * 1e3,
            "p50_collect_ms": statistics.median(
                st["collect"] for st in stages) * 1e3,
            "p50_batch_ms": statistics.median(
                sum(st.values()) for st in stages) * 1e3,
            "p50_l0_pack_ms": statistics.median(r["pack_ms"]),
            "p50_l0_decode_ms": statistics.median(r["decode_ms"]),
        }
    nat, num = runs["native"], runs["numpy"]
    for i in range(len(qs)):
        NATIVE_TALLY.check(nat["answers"][i] == num["answers"][i],
                           f"native: batch {i} answers != numpy")
        a, b = nat["packs"][i], num["packs"][i]
        NATIVE_TALLY.check(
            a[3] == b[3] and all(np.array_equal(x, y)
                                 for x, y in zip(a[:3], b[:3])),
            f"native: batch {i} packed windows != numpy")
        NATIVE_TALLY.check(
            all(np.array_equal(x, y) and x.dtype == y.dtype
                for x, y in zip(nat["pairs"][i], num["pairs"][i])),
            f"native: batch {i} decoded pairs != numpy")
    hits = sum(len(p[0]) for p in nat["pairs"])
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays

    host = {}
    for b in HOST_BATCHES:
        q = make_batch(500 + b, b, N_CELLS, WIDTH)
        row = {}
        got = {}
        for mode in ("native", "numpy"):
            fp._NATIVE = None if mode == "native" else (None,)
            try:
                res = ft.query_host_auto(*q, now=NOW)
                times = []
                for _ in range(HOST_REPS):
                    t = time.perf_counter()
                    ft.query_host_auto(*q, now=NOW)
                    times.append((time.perf_counter() - t) * 1e3)
            finally:
                fp._NATIVE = None
            got[mode] = None if res is None else sorted(
                zip(res[0].tolist(), res[1].tolist()))
            row[f"{mode}_p50_ms"] = statistics.median(times)
        NATIVE_TALLY.check(got["native"] is not None
                           and got["native"] == got["numpy"],
                           f"native: host scan of {b} != numpy")
        row["pairs"] = len(got["native"] or ())
        host[str(b)] = row

    polys = [[(v["lat"], v["lng"]) for v in p["area_of_interest"]["volume"]
              ["outline_polygon"]["vertices"]]
             for p, _ in svc_aois(80_001, SVC_SAMPLE, NOW)]
    cov = {}
    for mode in ("native", "numpy"):
        saved = covering._native
        if mode == "numpy":
            covering._native = None
        try:
            t = time.perf_counter()
            cells = [covering.covering_polygon(p) for p in polys]
            cov[mode] = ((time.perf_counter() - t) * 1e3 / len(polys), cells)
        finally:
            covering._native = saved
    NATIVE_TALLY.check(
        all(np.array_equal(a, b) for a, b in zip(cov["native"][1],
                                                 cov["numpy"][1])),
        "native: coverings != numpy")
    line = {
        "native_available": True,
        "batches": len(qs), "batch": BATCH, "hits_l0": hits,
        "native": nat["line"], "numpy": num["line"],
        "collect_speedup": num["line"]["p50_collect_ms"]
        / nat["line"]["p50_collect_ms"],
        # paired: batches whose native batch time beat numpy's
        "batches_native_faster": sum(
            sum(a.values()) < sum(b.values())
            for a, b in zip(nat["stages"], num["stages"])),
        "host_scan": host,
        "covering": {"polygons": len(polys),
                     "native_ms_per_polygon": cov["native"][0],
                     "numpy_ms_per_polygon": cov["numpy"][0],
                     "cells": int(sum(len(c) for c in cov["native"][1]))},
        "b1_launches": launches, "b1_graph_replays": replays,
        "compared": NATIVE_TALLY.compared,
        "mismatches": NATIVE_TALLY.mismatches,
        "seconds": time.perf_counter() - t_all, "card": smi,
    }
    return {"native": line}, {"native_phase_launches": launches,
                              "native_phase_graph_replays": replays}


def entry(name, launches, max_err, t, b_ms) -> dict:
    """One kernel's entry of the kernels line; t from timings()."""
    source, replaces = KERNELS[name]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        **t,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "compared": TALLY[name].compared,
        "mismatches": TALLY[name].mismatches,
    }


def check_mask(name, got, want, what) -> int:
    """A mask kernel's output against its reference, tallied on the
    kernel's behalf.  -> max abs error."""
    if got.is_cuda or want.is_cuda:
        torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    TALLY[name].check(
        got.shape == want.shape and err == 0 and torch.equal(got, want),
        f"{what}: max abs err {err}")
    return err


def same_arrays(name, a, b, what) -> None:
    TALLY[name].check(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)),
        what)


def pair_set(qidx, slots) -> set:
    return set(zip(np.asarray(qidx).tolist(), np.asarray(slots).tolist()))


def gridless_args(ft, q):
    """B3's and B4's inputs for batch q on ft: the first <= 512 windows
    of the legacy window list (B3), and of the fused path's window list
    with qidx masked off and the bounds gathered per window (B4).  ->
    (B3 args, B4 args, B1's plain filter args on B4's windows)."""
    qkeys, alo, ahi, ts, te = q
    _, _, args = ft._legacy_inputs(*q)
    b3 = tuple(a[:GRIDLESS] for a in args)
    wins, win_q, _, nw = ft._pack_windows(qkeys)
    k = min(nw, GRIDLESS)
    wq = win_q[:k]
    dev = ft.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b4 = (up(wins[0, :k]), up(wins[1, :k] & 0xFFFF), up(alo[wq]),
          up(ahi[wq]), up(np.maximum(ts, np.int64(NOW))[wq]), up(te[wq]))
    full = (up(wins[:, :k]), up(alo), up(ahi),
            up(np.maximum(ts, np.int64(NOW))), up(te))
    return b3, b4, full


def unpacked_words(words: torch.Tensor) -> torch.Tensor:
    """(NW, 4) i32 hit words -> (NW, 128) int8 lane mask."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(len(words), 128).to(torch.int8)


MASK_CASE_NAMES = (
    "nw_1", "nw_31", "nw_32", "nw_33", "nw_512", "one_block",
    "block_-1_and_nb", "key_-2", "start_eq_end", "start_0_end_128",
    "range_in_one_group", "time_edges",
)
MASK_NB = 24  # blocks of the mask cases' table
I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)


def mask_case(seed, nw, *, blk=None, key=None, start=None, end=None,
              edges=False) -> dict:
    """One case of B3 and B4 as numpy inputs, from a seed: a table of
    MASK_NB blocks, its quantized `p3` (keys 0..5, every 7th lane a pad
    lane of INT32_MAX, every 11th a dead posting with t1 INT32_MIN) and
    its exact columns (f32 altitudes with infinities, i64 times), and
    `nw` windows over it; `blk`, `key`, `start` and `end` (arrays or
    scalars) replace the random ones, and `edges` draws every time and
    quantized bound from the extremes of its type and their neighbours.
    -> {"p3", "cols", "b3": B3's six vectors, "b4": B4's six}."""
    r = np.random.default_rng(seed)
    nb = MASK_NB
    if edges:
        q_vals = np.asarray([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                             I32.max], np.int32)
        t_vals = np.asarray(
            [I64.min, I64.min + 1, -(2**62), -(2**32) - 1, -1, 0, 1,
             2**32, 2**62, I64.max - 1, I64.max], np.int64)
        p_lo = r.choice(q_vals, (nb, 128))
        p_hi = r.choice(q_vals, (nb, 128))
        p_t0 = r.choice(q_vals, (nb, 128))
        p_t1 = r.choice(q_vals, (nb, 128))
        b_t0 = r.choice(t_vals, (nb, 128))
        b_t1 = r.choice(t_vals, (nb, 128))
    else:
        p_lo = r.integers(0, 1000, (nb, 128))
        p_hi = p_lo + r.integers(0, 500, (nb, 128))
        p_t0 = r.integers(0, 1000, (nb, 128))
        p_t1 = p_t0 + r.integers(0, 500, (nb, 128))
        b_t0 = NOW + r.integers(-4, 4, (nb, 128)) * HOUR
        b_t1 = b_t0 + r.integers(1, 4, (nb, 128)) * HOUR
    p3 = np.stack([r.integers(0, 6, (nb, 128)), p_lo, p_hi, p_t0, p_t1],
                  axis=1).astype(np.int32)
    p3[:, :, ::7] = I32.max
    p3[:, 4, 3::11] = I32.min
    alts = np.asarray([-np.inf, -1.5, 0.0, 250.0, 700.0, 1500.0, np.inf],
                      np.float32)
    cols = (r.choice(alts, (nb, 128)), r.choice(alts, (nb, 128)),
            b_t0.astype(np.int64), b_t1.astype(np.int64))

    def pick(given, draw):
        return np.broadcast_to(np.asarray(given if given is not None
                                          else draw), (nw,)).astype(np.int32)

    win_blk = pick(blk, r.integers(0, nb, nw))
    if edges:
        q = [r.choice(q_vals, nw) for _ in range(4)]
        t = [r.choice(t_vals, nw) for _ in range(2)]
    else:
        lo = r.integers(0, 1200, nw)
        t0 = r.integers(0, 1200, nw)
        q = [lo, lo + r.integers(0, 400, nw), t0, t0 + r.integers(0, 400, nw)]
        w0 = NOW + r.integers(-3, 3, nw) * HOUR
        t = [w0, w0 + HOUR]
    s = pick(start, r.integers(0, 129, nw))
    e = pick(end, np.where(r.random(nw) < 0.3, 128, r.integers(0, 129, nw)))
    b3 = (win_blk, pick(key, r.integers(0, 6, nw)),
          *(np.asarray(x, np.int32) for x in q))
    b4 = (win_blk, (s | (e << 8)).astype(np.int32),
          r.choice(alts, nw), r.choice(alts, nw),
          np.asarray(t[0], np.int64), np.asarray(t[1], np.int64))
    return {"p3": p3, "cols": cols, "b3": b3, "b4": b4}


def mask_cases() -> list:
    """B3's and B4's fixed edge cases (numpy, from seeds) ->
    [(name, case)]: NW = 1, 31, 32, 33 and 512 (one window, a warp's
    worth and its neighbours, the reference's cap); 512 windows on one
    block; block indices of -1 and NB (they match nothing); pad windows
    of key -2 (B3); start == end, the whole row [0, 128) and a range
    inside one four-lane group (B4); every time and quantized bound at
    the extremes of its type (i64 to +-2^63 for B4, i32 for B3)."""
    nw = 97
    out_of_range = np.where(np.arange(nw) % 3 == 0, -1, np.where(
        np.arange(nw) % 5 == 0, MASK_NB, np.arange(nw) % MASK_NB))
    group = np.arange(nw) % 32
    return [
        *((f"nw_{k}", mask_case(k + 1, k)) for k in (1, 31, 32, 33, 512)),
        ("one_block", mask_case(40, GRIDLESS, blk=5)),
        ("block_-1_and_nb", mask_case(41, nw, blk=out_of_range)),
        ("key_-2", mask_case(42, nw, key=np.where(np.arange(nw) % 2, -2,
                                                  np.arange(nw) % 6))),
        ("start_eq_end", mask_case(43, nw, start=np.arange(nw) % 129,
                                   end=np.arange(nw) % 129)),
        ("start_0_end_128", mask_case(44, nw, start=0, end=128)),
        ("range_in_one_group", mask_case(45, nw, start=4 * group + 1,
                                         end=4 * group + 3)),
        ("time_edges", mask_case(46, GRIDLESS, edges=True)),
    ]


def mask_case_args(c, dev) -> tuple:
    """A case's tensors on `dev` -> (B3's args, B4's args), each the
    table's then the windows'."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ((t(c["p3"]), *map(t, c["b3"])),
            (*map(t, c["cols"]), *map(t, c["b4"])))


def mask_plain(plain, n_table, args) -> torch.Tensor:
    """A mask kernel's plain version on `args` (its `n_table` table
    tensors, then the windows'), where a window whose block lies outside
    [0, NB) matches nothing, as the kernels document: such a window is
    compared on block 0 and its row cleared."""
    table, (blk, *rest) = args[:n_table], args[n_table:]
    bad = (blk < 0) | (blk >= table[0].shape[0])
    want = plain(*table, blk.masked_fill(bad, 0), *rest)
    want[bad] = 0
    return want


def mask_kernel_checks(dev) -> tuple:
    """B3 and B4 against their plain versions on the card over
    mask_cases(), then on outputs the allocator hands back full of -1
    (the kernels write every byte of every row), then 40 launches over
    the cases, B3 and B4 in turn, with no sync between them; tallied.
    -> (B3's, B4's largest absolute error)."""
    kernels = (("filter_windows_gridless", fc.filter_windows_gridless,
                fc.filter_windows_torch, 1),
               ("fused_filter_gridless", fc.fused_filter_gridless,
                fc.fused_filter_mask_torch, 4))
    cases = [(n, mask_case_args(c, dev)) for n, c in mask_cases()]
    err = {name: 0 for name, *_ in kernels}
    want = {}
    for case, args in cases:
        for k, (name, fn, plain, n_table) in enumerate(kernels):
            want[case, k] = mask_plain(plain, n_table, args[k])
            err[name] = max(err[name], check_mask(
                name, fn(*args[k]), want[case, k], f"mask case {case}"))
    for k, (name, fn, _, _) in enumerate(kernels):
        case, args = cases[4]  # nw_512
        torch.cuda.synchronize()
        dirty = torch.full((args[k][-1].shape[0], 128), -1,
                           dtype=torch.int8, device=dev)
        ptr = dirty.data_ptr()
        del dirty
        got = fn(*args[k])
        TALLY[name].check(got.data_ptr() == ptr, "dirty output: the -1 "
                          "block was not handed back, so it tested nothing")
        err[name] = max(err[name], check_mask(name, got, want[case, k],
                                              "dirty output"))
    outs = []
    for i in range(40):
        case, args = cases[i % len(cases)]
        k = (i // len(cases)) % 2
        outs.append((kernels[k][0], kernels[k][1](*args[k]), want[case, k]))
    for i, (name, got, ref) in enumerate(outs):
        err[name] = max(err[name], check_mask(name, got, ref,
                                              f"back-to-back launch {i}"))
    return err["filter_windows_gridless"], err["fused_filter_gridless"]


def legacy_phase(idx, twin, cases, orc, smi, flush) -> list:
    """Phase 6 on the compacted L0 table; -> the kernels line entries
    of B2, B3 and B4."""
    ft = idx.table._state.snap.fast
    twin_ft = twin.table._state.snap.fast
    snap = idx.table._state.snap
    TALLY["filter_windows"].check(
        torch.equal(ft.p3.cpu(), twin_ft.p3), "p3: card != twin")

    # -- B2 against its plain version -----------------------------------
    b2_err = 0
    hq = make_batch(100, BATCH, N_CELLS, WIDTH)
    for name, case_ft, q in cases + [("headline", ft, hq)]:
        _, _, args = case_ft._legacy_inputs(*q)
        b2_err = max(b2_err, check_mask(
            "filter_windows", fc.filter_windows(case_ft.p3, *args),
            fc.filter_windows_torch(case_ft.p3, *args), f"B2 case {name}"))
    win_q, win_blk, args = ft._legacy_inputs(*hq)
    b2_t = timings("filter_windows",
                   lambda: fc.filter_windows(ft.p3, *args),
                   lambda: fc.filter_windows_torch(ft.p3, *args), flush)
    b2_bound, nbytes = window_mask_bound_ms(args[0].cpu().numpy())
    log(f"B2 headline: {len(win_blk)} windows (bucket {args[0].shape[0]}), "
        f"{json.dumps(b2_t)}, bound {b2_bound:.6f} ms ({nbytes} B) [{smi}]")

    # -- the legacy path at full scale, launch counts from zero -----------
    tally = TALLY["filter_windows"]
    se = ft.slot_exact
    cols = (se["alt_lo"], se["alt_hi"], se["t0"], se["t1"], se["live"])
    batches = [make_batch(500 + i, BATCH, N_CELLS, WIDTH)
               for i in range(LEGACY_BATCHES)]
    fc.filter_windows.launches = 0
    batch_s, answers, hits = [], [], 0
    for i, q in enumerate(batches):
        keys, alo, ahi, ts, te = q
        t0 = time.perf_counter()
        kq = ft.query_batch(*q, now=NOW, use_kernel=True)
        exact = ft.exact_filter(*kq, *cols, alo, ahi, ts, te, now=NOW)
        batch_s.append(time.perf_counter() - t0)
        answers.append(kq)
        hits += len(exact[0])
        same_arrays("filter_windows", kq,
                    ft.query_batch(*q, now=NOW, use_kernel=False),
                    f"legacy batch {i}: kernel route != words route")
        same_arrays("filter_windows", kq,
                    twin_ft.query_batch(*q, now=NOW, use_kernel=bool(i % 2)),
                    f"legacy batch {i}: card != twin")
        tally.check(pair_set(*exact) == pair_set(*ft.query_fused(*q, now=NOW)),
                    f"legacy batch {i}: exact pairs != fused pairs")
        for j in range(64 if i == 0 else 0):
            got = sorted({snap.ids[s] for s in exact[1][exact[0] == j]})
            tally.check(got == orc.ids(keys[j], alo[j], ahi[j], ts[j], te[j]),
                        f"legacy batch {i}: card != oracle at query {j}")
    b2_launches = fc.filter_windows.launches

    # the kernel route's stages, timed apart (launches not counted)
    stages = []
    for q, kq in zip(batches, answers):
        _, alo, ahi, ts, te = q
        t0 = time.perf_counter()
        wq, wb, a = ft._legacy_inputs(*q)
        t1 = time.perf_counter()
        out = ft._legacy_filter(a, len(wb), True)
        t2 = time.perf_counter()
        pairs = ft._legacy_pairs(wq, wb, out, True)
        t3 = time.perf_counter()
        ft.exact_filter(*pairs, *cols, alo, ahi, ts, te, now=NOW)
        t4 = time.perf_counter()
        stages.append({"expand": t1 - t0, "launch_d2h": t2 - t1,
                       "decode": t3 - t2, "exact_filter": t4 - t3})
        same_arrays("filter_windows", pairs, kq, "staged run != query_batch")
    log(json.dumps({"legacy_path": {
        "entities": N_ENTITIES, "batch": BATCH, "batches": len(batch_s),
        "hits_after_exact_filter": hits,
        "batches_per_s": len(batch_s) / sum(batch_s),
        "p50_batch_ms": statistics.median(batch_s) * 1e3,
        "p50_stage_ms": {k: statistics.median(st[k] for st in stages) * 1e3
                         for k in stages[0]},
        "b2_launches": b2_launches,
        "card": smi,
    }}))

    # -- B3 and B4 on their edge cases, dirty outputs, back to back --------
    case_err = mask_kernel_checks(ft.p3.device)
    log(f"mask cases: {len(MASK_CASE_NAMES)} cases, dirty outputs and 40 "
        f"back-to-back launches; max abs err B3 {case_err[0]}, B4 "
        f"{case_err[1]}")

    # -- B3's and B4's own entries, launch counts from zero ----------------
    fc.filter_windows_gridless.launches = 0
    fc.fused_filter_gridless.launches = 0
    cols4 = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1)
    twin_cols4 = (twin_ft.b_alo, twin_ft.b_ahi, twin_ft.b_t0, twin_ft.b_t1)
    for i, q in enumerate(batches + [hq]):
        b3, b4, _ = gridless_args(ft, q)
        tb3, tb4, _ = gridless_args(twin_ft, q)
        check_mask("filter_windows_gridless",
                   fc.filter_windows_gridless(ft.p3, *b3),
                   fc.filter_windows_gridless(twin_ft.p3, *tb3),
                   f"B3 batch {i}: card != twin")
        check_mask("fused_filter_gridless",
                   fc.fused_filter_gridless(*cols4, *b4),
                   fc.fused_filter_gridless(*twin_cols4, *tb4),
                   f"B4 batch {i}: card != twin")
    b3_launches = fc.filter_windows_gridless.launches
    b4_launches = fc.fused_filter_gridless.launches

    # -- B3 and B4 against their plain versions ----------------------------
    b3, b4, full = gridless_args(ft, hq)
    b3_err = max(case_err[0], check_mask(
        "filter_windows_gridless", fc.filter_windows_gridless(ft.p3, *b3),
        fc.filter_windows_torch(ft.p3, *b3), "B3 headline"))
    mask4 = fc.fused_filter_gridless(*cols4, *b4)
    b4_err = max(
        case_err[1],
        check_mask("fused_filter_gridless", mask4,
                   fc.fused_filter_mask_torch(*cols4, *b4), "B4 headline"),
        check_mask("fused_filter_gridless", mask4,
                   unpacked_words(ff.filter_pack_torch(*cols4, *full)),
                   "B4 headline != B1's plain filter"),
    )
    b3_t = timings("filter_windows_gridless",
                   lambda: fc.filter_windows_gridless(ft.p3, *b3),
                   lambda: fc.filter_windows_torch(ft.p3, *b3), flush)
    b3_bound, b3_bytes = window_mask_bound_ms(b3[0].cpu().numpy())
    b4_t = timings("fused_filter_gridless",
                   lambda: fc.fused_filter_gridless(*cols4, *b4),
                   lambda: fc.fused_filter_mask_torch(*cols4, *b4), flush)
    b4_bound, b4_bytes = exact_mask_bound_ms(b4[0].cpu().numpy(),
                                             b4[1].cpu().numpy())
    log(f"B3 headline: {b3[0].shape[0]} windows, {json.dumps(b3_t)}, "
        f"bound {b3_bound:.6f} ms ({b3_bytes} B); B4: {b4[0].shape[0]} "
        f"windows, {json.dumps(b4_t)}, bound {b4_bound:.6f} ms "
        f"({b4_bytes} B) [{smi}]")
    return [
        entry("filter_windows", b2_launches, b2_err, b2_t, b2_bound),
        entry("filter_windows_gridless", b3_launches, b3_err, b3_t,
              b3_bound),
        entry("fused_filter_gridless", b4_launches, b4_err, b4_t, b4_bound),
    ]


def bucket_batch(ft, wb, bb, seed):
    """A batch of contiguous-cell queries whose windows fill bucket wb
    and whose size lands in batch bucket bb: the width is searched by
    bisection, at bb queries and then at bb/2 + 1."""
    for b in (bb, bb // 2 + 1):
        lo, hi = 1, 4096
        while lo <= hi:
            w = (lo + hi) // 2
            q = make_batch(seed, b, N_CELLS, w)
            bucket = pow2_bucket(ft._pack_windows(q[0])[3])
            if bucket == wb:
                return q
            lo, hi = (w + 1, hi) if bucket < wb else (lo, w - 1)
    raise RuntimeError(f"no batch lands in bucket ({wb}, {bb})")


def padded_args(ft, q):
    """B1's card inputs for batch q as FastTable.submit builds them
    (queries padded to the batch bucket) -> (args, wins, padded bounds
    in numpy, window bucket, batch bucket)."""
    keys, alo, ahi, ts, te = q
    wins = ft._pack_windows(keys)[0]
    b = len(keys)
    bb = pow2_bucket(b, lo=16)
    qp = []
    for a, dt in ((alo, np.float32), (ahi, np.float32),
                  (np.maximum(ts, np.int64(NOW)), np.int64), (te, np.int64)):
        p = np.zeros(bb, dt)
        p[:b] = a
        qp.append(p)
    dev = ft.device
    args = ((ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1,
             torch.from_numpy(wins).to(dev))
            + tuple(torch.from_numpy(p).to(dev) for p in qp))
    return args, wins, qp, wins.shape[1], bb


def eager_io(ft, wins, qp, mw):
    """What a cold submit does around B1: upload the window list and
    the bounds, launch, copy the output to pinned memory, wait."""
    dev = ft.device
    out = ff.fused_window_filter(
        ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1, torch.from_numpy(wins).to(dev),
        *(torch.from_numpy(p).to(dev) for p in qp), max_words=mw)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return host


def graph_phase(ft, kern, smi) -> dict:
    """Every warmed (window, batch) bucket of ft: one batch through the
    captured graph, eager B1 and the plain version, word for word; two
    units of one bucket in flight at once; then the largest bucket's
    replay timed beside the eager call.  -> B1's graph numbers."""
    # imported here, as in serving_leg: b1_device_time.py loads this
    # file against copies of the package that predate the resident loop
    from dss_tpu_torch.ops.resident import max_words_for

    tally = TALLY["fused_window_filter"]
    checked = []
    for bb in GRID_BATCH:
        for wb in GRID_WINDOW:
            q = bucket_batch(ft, wb, bb, seed=700 + wb // 1024 + bb)
            args, _, _, wb_q, bb_q = padded_args(ft, q)
            mw = max_words_for(wb)
            pend = ft.submit(*q, now=NOW, kernel=kern)
            tally.check(pend.instance is not None and (wb_q, bb_q) == (wb, bb),
                        f"graph ({wb}, {bb}): no captured unit was taken")
            pend.ready()
            got = pend.host.clone()
            hits = ft.collect(pend)
            eager = ff.fused_window_filter(*args, max_words=mw)
            plain = ff.fused_window_filter_torch(*args, max_words=mw)
            torch.cuda.synchronize()
            tally.check(torch.equal(got, eager.cpu()),
                        f"graph ({wb}, {bb}): replay != eager B1")
            tally.check(torch.equal(got, plain.cpu()),
                        f"graph ({wb}, {bb}): replay != plain version")
            want = ft.query_fused(*q, now=NOW)
            tally.check(all(np.array_equal(x, y) for x, y in zip(hits, want)),
                        f"graph ({wb}, {bb}): decoded replay != fused path")
            checked.append([wb, bb, len(q[0]), int(plain[0])])
    log(f"graph replay == eager B1 == plain at {len(checked)} buckets "
        f"[wb, bb, queries, words]: {checked}")
    # two units of the largest bucket in flight at once
    wb, bb = GRID_WINDOW[-1], GRID_BATCH[-1]
    qa = bucket_batch(ft, wb, bb, seed=801)
    qb = bucket_batch(ft, wb, bb, seed=802)
    pa = ft.submit(*qa, now=NOW, kernel=kern)
    pb = ft.submit(*qb, now=NOW, kernel=kern)
    tally.check(pa.instance is not None and pb.instance is not None
                and pa.instance is not pb.instance,
                "two in flight: not two distinct units")
    for pend, q in ((pb, qb), (pa, qa)):
        args = padded_args(ft, q)[0]
        pend.ready()
        got = pend.host.clone()
        want = ff.fused_window_filter_torch(*args, max_words=max_words_for(wb))
        tally.check(torch.equal(got, want.cpu()), "two in flight: != plain")
        ft.collect(pend)
    # the replay's call and device time beside the eager call's
    args, wins, qp, _, _ = padded_args(ft, qa)
    mw = max_words_for(wb)
    unit = kern.lookup(ft, wb, bb, mw)

    def replay():
        unit.replay(wins, *qp)[1].synchronize()

    try:
        replay_call = call_ms(replay)
        replay_dev, replay_by, replay_src = device_ms(replay)
    finally:
        unit.release()
    DEVICE_BY_NAME["fused_window_filter (graph replay)"] = {"warm": replay_by}
    out = {
        "graph_buckets_checked": len(checked),
        "replay_bucket": [wb, bb],
        "replay_call_ms": replay_call,
        "replay_ms": replay_dev,
        "replay_ms_source": replay_src,
        "eager_call_ms_same_bucket": call_ms(
            lambda: ff.fused_window_filter(*args, max_words=mw)),
        "eager_io_call_ms_same_bucket": call_ms(
            lambda: eager_io(ft, wins, qp, mw)),
    }
    log(f"replay vs eager at ({wb}, {bb}): {json.dumps(out)} [{smi}]")
    return out


def serving_leg(idx, twin, name, threads, warm_s, run_s, seed,
                smi) -> tuple:
    """Closed-loop clients through CudaSpatialIndex.query_ids for warm_s
    + run_s, every query and answer kept; latencies from the timed
    window; B1's counts set to 0 just before the clients start and read
    just after they stop.  -> (serving line, failures)."""
    from dss_tpu_torch import errors

    co = idx.coalescer
    loop = co.resident_loop()
    kern = loop.kernel
    streams = []
    for i in range(threads):
        keys, alo, ahi, ts, te = make_batch(seed + i, QUERIES_PER_CLIENT,
                                            N_CELLS, WIDTH)
        cells = s2cell.dar_key_to_cell(keys.ravel()).reshape(keys.shape)
        streams.append((keys, cells, alo, ahi, ts, te))
    lats = [[] for _ in range(threads)]
    answers = [[] for _ in range(threads)]
    sheds, dl_sheds, client_errors = [0] * threads, [0] * threads, []
    stop = threading.Event()
    k0 = (kern.hits, kern.misses, kern.busy, kern.cache.captures)
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    t_start = time.perf_counter()
    warm_until = t_start + warm_s

    def client(i):
        _, cells, alo, ahi, ts, te = streams[i]
        j = 0
        while not stop.is_set():
            qi = j % QUERIES_PER_CLIENT
            j += 1
            t_req = time.perf_counter()
            try:
                got = idx.query_ids(cells[qi], float(alo[qi]), float(ahi[qi]),
                                    int(ts[qi]), int(te[qi]), now=NOW)
            except errors.OverloadedError:
                sheds[i] += 1
                continue
            except errors.StatusError as e:
                if e.code != errors.Code.DEADLINE_EXCEEDED:
                    client_errors.append(repr(e))
                    return
                dl_sheds[i] += 1
                continue
            except Exception as e:  # noqa: BLE001 — fails the leg below
                client_errors.append(repr(e))
                return
            t_done = time.perf_counter()
            answers[i].append((qi, got))
            if t_req >= warm_until:
                lats[i].append(t_done - t_req)

    ths = [threading.Thread(target=client, args=(i,)) for i in range(threads)]
    for th in ths:
        th.start()
    time.sleep(warm_s)
    st0 = co.stats()
    time.sleep(run_s)
    st1 = co.stats()
    stop.set()
    for th in ths:
        th.join(60)
    stuck = sum(th.is_alive() for th in ths)
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays
    # every answer of a seeded sample against the CPU twin
    flat = [(i, qi, got) for i in range(threads) for qi, got in answers[i]]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(flat), min(SERVING_SAMPLE, len(flat)), replace=False)
    tally = TALLY["fused_window_filter"]
    before = tally.mismatches
    for lo in range(0, len(pick), BATCH):
        part = [flat[k] for k in pick[lo:lo + BATCH]]
        rows = [(streams[i], qi) for i, qi, _ in part]
        want = twin.table.query_many(
            [s[0][qi] for s, qi in rows],
            np.asarray([s[2][qi] for s, qi in rows], np.float32),
            np.asarray([s[3][qi] for s, qi in rows], np.float32),
            np.asarray([s[4][qi] for s, qi in rows], np.int64),
            np.asarray([s[5][qi] for s, qi in rows], np.int64), now=NOW)
        for (i, qi, got), w in zip(part, want):
            tally.check(got == w, f"serving {name}: client {i} query {qi} "
                        "!= twin")
    all_lats = np.sort(np.concatenate([np.asarray(x) for x in lats]))
    n = len(all_lats)
    d = max(1, st1["co_batches"] - st0["co_batches"])

    def delta(k):
        return st1[k] - st0[k]

    line = {
        "leg": name, "threads": threads, "slo_ms": SLO_MS, "warm_s": warm_s, "run_s": run_s,
        "queries_per_s": n / run_s, "samples": n,
        "p50_ms": float(all_lats[n // 2] * 1e3) if n else None,
        "p99_ms": float(all_lats[int(n * 0.99)] * 1e3) if n else None,
        "p999_ms": float(all_lats[int(n * 0.999)] * 1e3) if n else None,
        "answers_kept": len(flat), "answers_checked": len(pick),
        "mismatches": tally.mismatches - before,
        "client_shed": sum(sheds), "client_deadline_shed": sum(dl_sheds),
        "client_errors": len(client_errors),
        "route_mix": {r: delta(f"co_route_{r}_batches")
                      for r in ("host", "hostchunk", "device", "resident")},
        "batches": delta("co_batches"), "inline": delta("co_inline"),
        "co_shed": delta("co_shed"),
        "co_deadline_shed": delta("co_deadline_shed"),
        "co_device_loss_absorbed": st1["co_device_loss_absorbed"],
        "pack_ms_avg": delta("co_pack_ms_total") / d,
        "device_ms_avg": delta("co_device_ms_total") / d,
        "collect_ms_avg": delta("co_collect_ms_total") / d,
        "batch_size_end": st1["co_batch_size"],
        "est": {k[7:]: st1[k] for k in st1 if k.startswith("co_est_")},
        "plans": {k[8:]: delta(k) for k in st1 if k.startswith("co_plan_")},
        "graph": {"captures": kern.cache.captures - k0[3],
                  "hits": kern.hits - k0[0], "misses": kern.misses - k0[1],
                  "busy": kern.busy - k0[2], "replays": replays},
        "b1_eager_launches": launches,
        "card": smi,
    }
    log(json.dumps({"serving": line}))
    failures = [f"serving {name}: {e}" for e in client_errors[:3]]
    if stuck:
        failures.append(f"serving {name}: {stuck} clients did not stop")
    if st1["co_device_loss_absorbed"] > 0:
        failures.append(f"serving {name}: device loss absorbed")
    if not n:
        failures.append(f"serving {name}: no request completed")
    return line, failures


def bulk_bursts(idx, twin, seed, smi) -> tuple:
    """The reference's bulk stale drain (BURST_* above), BURSTS times
    through CudaSpatialIndex.query_ids: for each burst the table's
    submit waits on a gate, BURST_CALLERS callers start (the first runs
    inline and holds the gate, so the rest queue behind it), the gate
    opens once BURST_QUEUED are queued, and every answer is held
    against the CPU twin.  B1's counts are set to 0 just before the
    first burst and read just after the last.  -> (line, failures)."""
    co = idx.coalescer
    co.configure(min_batch=BURST_MIN_BATCH)
    kern = co.resident_loop().kernel
    table = idx.table
    submit = table.query_many_submit
    tally = TALLY["fused_window_filter"]
    before = tally.mismatches
    client_errors, queued = [], []
    st0 = co.stats()
    k0 = (kern.hits, kern.misses, kern.busy, kern.cache.captures)
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    for k in range(BURSTS):
        keys, alo, ahi, ts, te = make_batch(seed + k, BURST_CALLERS,
                                            N_CELLS, WIDTH)
        cells = s2cell.dar_key_to_cell(keys.ravel()).reshape(keys.shape)
        got = [None] * BURST_CALLERS
        gate = threading.Event()

        def gated(*a, **kw):
            gate.wait(10.0)
            return submit(*a, **kw)

        def client(i):
            try:
                got[i] = idx.query_ids(cells[i], float(alo[i]),
                                       float(ahi[i]), int(ts[i]),
                                       int(te[i]), now=NOW,
                                       allow_stale=True)
            except Exception as e:  # noqa: BLE001 — fails the burst below
                client_errors.append(repr(e))

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(BURST_CALLERS)]
        table.query_many_submit = gated
        try:
            for th in ths:
                th.start()
            until = time.perf_counter() + 5.0
            while (co.stats()["co_queue_depth"] < BURST_QUEUED
                   and time.perf_counter() < until):
                time.sleep(0.005)
            queued.append(co.stats()["co_queue_depth"])
        finally:
            del table.query_many_submit
            gate.set()
        for th in ths:
            th.join(60)
        until = time.perf_counter() + 10.0
        while co.stats()["co_inflight"] > 0 and time.perf_counter() < until:
            time.sleep(0.005)
        want = twin.table.query_many(list(keys), alo, ahi, ts, te, now=NOW)
        for i, (g, w) in enumerate(zip(got, want)):
            tally.check(g == w, f"bulk burst {k}: caller {i} != twin")
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays
    st1 = co.stats()

    def delta(key):
        return st1[key] - st0[key]

    line = {
        "bursts": BURSTS, "callers": BURST_CALLERS,
        "min_batch": BURST_MIN_BATCH, "queued_at_release": queued,
        "answers_checked": BURSTS * BURST_CALLERS,
        "mismatches": tally.mismatches - before,
        "client_errors": len(client_errors),
        "route_mix": {r: delta(f"co_route_{r}_batches")
                      for r in ("host", "hostchunk", "device", "resident")},
        "batches": delta("co_batches"), "inline": delta("co_inline"),
        "co_device_loss_absorbed": st1["co_device_loss_absorbed"],
        "graph": {"captures": kern.cache.captures - k0[3],
                  "hits": kern.hits - k0[0], "misses": kern.misses - k0[1],
                  "busy": kern.busy - k0[2], "replays": replays},
        "b1_eager_launches": launches,
        "card": smi,
    }
    log(json.dumps({"bulk_burst": line}))
    failures = [f"bulk burst: {e}" for e in client_errors[:3]]
    if st1["co_device_loss_absorbed"] > 0:
        failures.append("bulk burst: device loss absorbed")
    if replays <= 0:
        failures.append("bulk burst: no graph replay")
    return line, failures


def serving_phase(idx, twin, smi) -> tuple:
    """Phase 7 on the compacted index -> (B1's serving numbers,
    failures)."""
    co = idx.coalescer
    co.configure(slo_ms=SLO_MS, resident=True)
    loop = co.resident_loop()
    kern = loop.kernel
    tiers_now = idx.table._state.tiers
    t = time.perf_counter()
    built = idx.table.warm_resident(kern, batch_buckets=GRID_BATCH,
                                    window_buckets=GRID_WINDOW)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    cache = kern.cache
    log(json.dumps({"graph_warm": {
        "tiers": len(tiers_now), "entries": built,
        "units": cache.instances(), "captures": cache.captures,
        "seconds": warm_s,
        "ms_per_capture": warm_s * 1e3 / max(1, cache.captures),
        "card": smi}}))
    out = graph_phase(tiers_now[0].snap.fast, kern, smi)
    failures, legs = [], {}
    for k, (name, threads, warm, run_s) in enumerate(LEGS):
        line, bad = serving_leg(idx, twin, name, threads, warm, run_s,
                                seed=10_000 * (k + 1), smi=smi)
        legs[name] = line
        failures += bad
    if legs["loaded"]["route_mix"]["resident"] <= 0:
        failures.append("serving loaded: no resident batch")
    burst, bad = bulk_bursts(idx, twin, seed=40_000, smi=smi)
    failures += bad
    runs = list(legs.values()) + [burst]
    out["graph_replays"] = sum(x["graph"]["replays"] for x in runs)
    out["serving_launches"] = sum(x["b1_eager_launches"] for x in runs)
    return out, failures



class StoreOracle:
    """oracle.search over the store phase's operations: the WAL's rows
    (column arrays, found by a sorted postings index) minus those
    rewritten since, plus the rewritten ones still present.  `now` is
    the store clock's, so expiry is the store's visibility rule."""

    def __init__(self, cols, now):
        self.keys, self.alo, self.ahi, self.t0, self.t1 = cols
        flat = self.keys.ravel()
        self.order = np.argsort(flat, kind="stable")
        self.sorted = flat[self.order]
        self.now = now
        self.changed = {}  # id -> Record, or None when removed

    def rows(self, keys_row):
        lo = np.searchsorted(self.sorted, keys_row, "left")
        hi = np.searchsorted(self.sorted, keys_row, "right")
        hit = np.concatenate([self.order[a:b] for a, b in zip(lo, hi)])
        return np.unique(hit // self.keys.shape[1])

    def record(self, r):
        return Record(f"op{r}", self.keys[r], float(self.alo[r]),
                      float(self.ahi[r]), int(self.t0[r]), int(self.t1[r]), 0)

    def ids(self, keys_row, alo, ahi, ts, te):
        cands = [self.record(r) for r in self.rows(keys_row)
                 if f"op{r}" not in self.changed]
        cands += [r for r in self.changed.values() if r is not None]
        recs = dict(enumerate(cands))
        slots = oracle.search(recs, keys_row, float(alo), float(ahi),
                              int(ts), int(te), self.now)
        return sorted(recs[s].entity_id for s in slots)


def store_columns(n, seed=5, now=NOW):
    """The store phase's operational intents as columns: KPE contiguous
    level-13 cells over the N_CELLS metro region, 10-600 m altitude
    bands, 1-5 h windows starting -4..3 h from `now`."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, N_CELLS - KPE, n)
    keys = (start[:, None] + np.arange(KPE)[None, :]).astype(np.int32)
    alo = rng.uniform(0, 3000, n).astype(np.float32)
    ahi = alo + rng.uniform(10, 600, n).astype(np.float32)
    t0 = now + rng.integers(-4, 4, n) * HOUR
    t1 = t0 + rng.integers(1, 6, n) * HOUR
    return keys, alo, ahi, t0, t1


def write_store_wal(path, cols, now=NOW) -> dict:
    """The store phase's WAL, written with the port's codec and
    WriteAheadLog: the format record, then one `scd_op_put` per
    operation, the poll recipe's ISAs, RID subscriptions over its
    areas, and SCD subscriptions and constraints.  Commit stamps are
    one microsecond apart, ending at `now` (the store clock's).  ->
    {"rid_recs": the ISA and RID subscription records, "areas": the
    poll areas' coverings, "window": (t0, t1) of the ISAs}."""
    from datetime import timedelta

    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.dar import codec
    from dss_tpu_torch.dar.wal import WriteAheadLog
    from dss_tpu_torch.models import rid as ridm
    from dss_tpu_torch.models import scd as scdm
    from dss_tpu_torch.models.core import Version, new_ovn_from_time

    keys, alo, ahi, t0, t1 = cols
    n = len(keys)
    cells = s2cell.dar_key_to_cell(keys.ravel()).reshape(keys.shape)
    base = from_nanos(now)
    total = n + POLL_ISAS + 2 * STORE_SUBS + STORE_CSTS
    stamps = iter(base - timedelta(microseconds=total - k)
                  for k in range(total))
    wal = WriteAheadLog(path)
    for i in range(n):
        oid = f"op{i}"
        wal.append({"t": "scd_op_put", "doc": codec.op_to_doc(scdm.Operation(
            id=oid, owner=f"uss{i % 64}", version=1,
            ovn=new_ovn_from_time(next(stamps), oid),
            start_time=from_nanos(int(t0[i])), end_time=from_nanos(int(t1[i])),
            altitude_lower=float(alo[i]), altitude_upper=float(ahi[i]),
            uss_base_url="https://uss.example", state="Accepted",
            cells=cells[i], subscription_id=f"sub{i % STORE_SUBS}"))})
    # the poll recipe's RID state (bench.py:796-840): POLL_ISAS ISAs
    # spread over POLL_AREAS disjoint areas of POLL_CELLS cells
    areas = [s2cell.dar_key_to_cell(np.arange(
        k * POLL_CELLS, (k + 1) * POLL_CELLS, dtype=np.int64))
        for k in range(POLL_AREAS)]
    w0 = base + timedelta(minutes=5)
    w1 = w0 + timedelta(hours=24)
    rid_recs = []
    for k in range(POLL_ISAS):
        rid_recs.append({"t": "isa_put", "doc": codec.isa_to_doc(
            ridm.IdentificationServiceArea(
                id=f"isa{k}", owner="poller", url="https://uss.example/f",
                cells=areas[k % POLL_AREAS], start_time=w0, end_time=w1,
                version=Version.from_time(next(stamps)),
                altitude_lo=0.0, altitude_hi=3000.0))})
    # display providers' subscriptions over the poll areas
    for k in range(STORE_SUBS):
        rid_recs.append({"t": "rid_sub_put", "doc": codec.rid_sub_to_doc(
            ridm.Subscription(
                id=f"rsub{k}", owner=f"dp{k % 16}",
                url="https://dp.example/n", cells=areas[k % POLL_AREAS],
                start_time=w0, end_time=w1,
                version=Version.from_time(next(stamps)),
                altitude_lo=0.0, altitude_hi=3000.0))})
    for rec in rid_recs:
        wal.append(rec)
    rng = np.random.default_rng(6)
    for j in range(STORE_SUBS + STORE_CSTS):
        s = int(rng.integers(0, N_CELLS - KPE))
        c = s2cell.dar_key_to_cell(np.arange(s, s + KPE, dtype=np.int64))
        if j < STORE_SUBS:
            wal.append({"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(
                scdm.Subscription(
                    id=f"sub{j}", owner=f"uss{j % 64}", version=1,
                    start_time=base - timedelta(hours=1),
                    end_time=base + timedelta(hours=6),
                    base_url="https://uss.example",
                    notify_for_operations=True, cells=c))})
            next(stamps)
        else:
            cid = f"cst{j}"
            wal.append({"t": "scd_cst_put", "doc": codec.constraint_to_doc(
                scdm.Constraint(
                    id=cid, owner="authority", version=1,
                    ovn=new_ovn_from_time(next(stamps), cid),
                    start_time=base - timedelta(hours=1),
                    end_time=base + timedelta(hours=5),
                    altitude_lower=0.0, altitude_upper=600.0,
                    uss_base_url="https://authority.example", cells=c))})
    wal.close()
    return {"rid_recs": rid_recs, "areas": areas, "window": (w0, w1)}


def seed_region_log(log_cls, path, entries, snapshot_at, state) -> None:
    """A region log written offline through `log_cls` (a RegionLog of
    either package; the smoke passes the port's): one lease append per
    entry (an entry is one transaction's records), the state snapshot
    `state` put at entry index `snapshot_at` (the log compacts below
    it, as a live region's does after an instance's upload), then a
    clean shutdown, so the region server that boots from it keeps its
    epoch."""
    log = log_cls(path)
    try:
        for k, recs in enumerate(entries):
            token = log.acquire("seed", 60.0)
            if log.append(token, list(recs)) is None:
                raise RuntimeError(f"seed append {k} fenced")
            if k + 1 == snapshot_at:
                plan = log.put_snapshot(snapshot_at, state)
                if plan is None:
                    raise RuntimeError("seed snapshot refused")
                log.finish_compact(log.begin_compact(plan))
    finally:
        log.close()


STORE_CLASSES = ("isa", "rid_sub", "op", "scd_sub", "constraint")


def store_counts(store) -> dict:
    """Per class: the store's records and the index's live records."""
    held = {"isa": store.rid._isas, "rid_sub": store.rid._subs,
            "op": store.scd._ops, "scd_sub": store.scd._subs,
            "constraint": store.scd._csts}
    out = {}
    for index, cls in store._class_indexes():
        st = index.stats()
        out[cls] = {"records": len(held[cls]),
                    "live_records": st["live_records"],
                    "tier_count": st.get("tier_count", 0)}
    return out


def op_query(store, q, i, allow_stale=False):
    """Query i of batch q through store.scd.search_operations -> the
    answer as (id, version, ovn) triples."""
    from dss_tpu_torch.clock import from_nanos

    keys, alo, ahi, ts, te = q
    cells = s2cell.dar_key_to_cell(keys[i])
    got = store.scd.search_operations(
        cells, float(alo[i]), float(ahi[i]), from_nanos(int(ts[i])),
        from_nanos(int(te[i])), allow_stale=allow_stale)
    return [(o.id, o.version, o.ovn) for o in got]


def drain_bursts(store, bursts, call, want, what) -> dict:
    """The reference's bulk stale drain (bench.py:1157-1186) on the op
    class: for each burst, BURST_CALLERS threads run call(item) (a
    bounded-staleness search -> its ids) while the op table's submit is
    held until BURST_QUEUED callers queue; every answer is held against
    want(item)."""
    index = store.scd._op_index
    co, table = index.coalescer, index.table
    submit = table.query_many_submit
    own = table.__dict__.get("query_many_submit")  # a counting wrapper
    errors_seen, queued = [], []
    st0 = co.stats()
    for k, items in enumerate(bursts):
        got = [None] * len(items)
        gate = threading.Event()

        def gated(*a, **kw):
            gate.wait(10.0)
            return submit(*a, **kw)

        def client(i):
            try:
                got[i] = call(items[i])
            except Exception as e:  # noqa: BLE001 — fails the phase below
                errors_seen.append(repr(e))

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(items))]
        table.query_many_submit = gated
        try:
            for th in ths:
                th.start()
            until = time.perf_counter() + 5.0
            while (co.stats()["co_queue_depth"] < BURST_QUEUED
                   and time.perf_counter() < until):
                time.sleep(0.005)
            queued.append(co.stats()["co_queue_depth"])
        finally:
            if own is None:
                del table.query_many_submit
            else:
                table.query_many_submit = own
            gate.set()
        for th in ths:
            th.join(60)
        for i, g in enumerate(got):
            STORE_TALLY.check(g is not None and g == want(items[i]),
                              f"{what} burst {k}: caller {i} != oracle")
    st1 = co.stats()
    return {
        "bursts": len(bursts), "callers": BURST_CALLERS,
        "queued_at_release": queued, "client_errors": errors_seen[:3],
        "route_mix": {r: st1[f"co_route_{r}_batches"]
                      - st0[f"co_route_{r}_batches"]
                      for r in ("host", "hostchunk", "device", "resident")},
        "device_loss_absorbed": st1["co_device_loss_absorbed"],
    }


def store_bursts(store, orc, seed) -> dict:
    """The bulk stale drain through store.scd.search_operations(...,
    allow_stale=True): STORE_BURSTS bursts of BURST_CALLERS callers."""
    bursts = []
    for k in range(STORE_BURSTS):
        q = make_batch(seed + k, BURST_CALLERS, N_CELLS, WIDTH)
        bursts.append([(q, i) for i in range(BURST_CALLERS)])
    return drain_bursts(
        store, bursts,
        lambda it: [x[0] for x in op_query(store, *it, allow_stale=True)],
        lambda it: orc.ids(*(col[it[1]] for col in it[0])), "store")


def store_writes(store, orc) -> dict:
    """STORE_WRITES writes through the store, in turns: new operations
    keyed with the OVNs of a prior search (every third one a key short
    of an overlapping OVN, which the store must refuse with
    MISSING_OVNS), fenced updates of live operations, deletes, and SCD
    subscriptions.  The oracle follows every accepted write."""
    import dataclasses

    from dss_tpu_torch import errors
    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.models import scd as scdm

    rng = np.random.default_rng(7)
    n_ops = len(orc.keys)
    done = {"new": 0, "refused": 0, "updated": 0, "deleted": 0, "subs": 0}
    bad = []

    def live_op():
        while True:
            i = int(rng.integers(0, n_ops))
            if f"op{i}" not in orc.changed and orc.t1[i] >= orc.now:
                return i

    for j in range(STORE_WRITES):
        kind = j % 6
        if kind in (0, 1, 2, 3):
            start = int(rng.integers(0, N_CELLS - KPE))
            keys = np.arange(start, start + KPE, dtype=np.int32)
            alo = float(np.float32(rng.uniform(0, 3000)))
            ahi = float(np.float32(alo + rng.uniform(10, 600)))
            t0 = NOW + int(rng.integers(0, 4)) * HOUR
            t1 = t0 + int(rng.integers(1, 6)) * HOUR
            cells = s2cell.dar_key_to_cell(keys)
            if kind == 3:  # fenced update of a live op, moved in place
                i = live_op()
                old = store.scd.get_operation(f"op{i}")
                keys, cells = orc.keys[i], old.cells
                op = dataclasses.replace(
                    old, altitude_lower=alo, altitude_upper=ahi,
                    start_time=from_nanos(t0), end_time=from_nanos(t1))
            else:
                op = scdm.Operation(
                    id=f"w{j}", owner=f"uss{j % 64}", version=0,
                    start_time=from_nanos(t0), end_time=from_nanos(t1),
                    altitude_lower=alo, altitude_upper=ahi,
                    uss_base_url="https://uss.example", state="Accepted",
                    cells=cells, subscription_id=f"sub{j % STORE_SUBS}")
            prior = store.scd.search_operations(
                cells, alo, ahi, from_nanos(t0), from_nanos(t1))
            key = [o.ovn for o in prior]
            if kind == 3:
                key.append(old.ovn)
            short = kind == 2 and len(key) > 0
            try:
                stored, _ = store.scd.upsert_operation(
                    op, key[1:] if short else key)
            except errors.StatusError as e:
                if short and e.code == errors.Code.MISSING_OVNS and (
                        prior[0].id in [d.id for d in e.details]):
                    done["refused"] += 1
                else:
                    bad.append(f"write {j} refused: {e.code!r} {e.message}")
                continue
            if short:
                bad.append(f"write {j} passed a key short of {prior[0].id}")
            orc.changed[stored.id] = Record(
                stored.id, np.asarray(keys, np.int32), alo, ahi, t0, t1, 0)
            done["updated" if kind == 3 else "new"] += 1
        elif kind == 4:
            i = live_op()
            store.scd.delete_operation(f"op{i}", f"uss{i % 64}")
            orc.changed[f"op{i}"] = None
            done["deleted"] += 1
        else:
            s = int(rng.integers(0, N_CELLS - KPE))
            store.scd.upsert_subscription(scdm.Subscription(
                id=f"wsub{j}", owner=f"uss{j % 64}",
                start_time=from_nanos(NOW), end_time=from_nanos(NOW + HOUR),
                base_url="https://uss.example", notify_for_operations=True,
                cells=s2cell.dar_key_to_cell(
                    np.arange(s, s + KPE, dtype=np.int64))))
            done["subs"] += 1
    for msg in bad:
        STORE_TALLY.check(False, msg)
    return done


def poll_pass(store, twin, areas, window, cache, seed) -> dict:
    """One closed-loop poll run through store.rid.search_isas
    (bench.py:845-912): POLL_THREADS threads poll Zipf-favored areas
    and make one fenced ISA update per POLL_RATIO polls, each update
    also applied to the memory twin.  A serial pass touches every area
    first.  -> served queries/s, p50/p99 ms, hit rate, polls, writes."""
    import dataclasses

    store.configure_serving(cache=cache)
    t0 = window[0]
    for area in areas:
        store.rid.search_isas(area, t0, None)
    ranks = np.arange(1, len(areas) + 1, dtype=np.float64)
    probs = ranks ** -POLL_ZIPF
    probs /= probs.sum()
    stop = threading.Event()
    wlock = threading.Lock()
    lats = [[] for _ in range(POLL_THREADS)]
    writes = [0] * POLL_THREADS
    errs = []

    def client(i):
        rng = np.random.default_rng(seed * 1000 + i)
        pick = rng.choice(len(areas), size=4096, p=probs)
        ops = 0
        while not stop.is_set():
            a = int(pick[ops % len(pick)])
            ops += 1
            try:
                if ops % (POLL_RATIO + 1) == POLL_RATIO:
                    eid = f"isa{(i * 7919 + ops) % POLL_ISAS}"
                    with wlock:
                        for s in (store, twin):
                            cur = s.rid.get_isa(eid)
                            s.rid.insert_isa(dataclasses.replace(
                                cur, cells=areas[int(eid[3:]) % len(areas)]))
                    writes[i] += 1
                    continue
                t_req = time.perf_counter()
                store.rid.search_isas(areas[a], t0, None)
                lats[i].append(time.perf_counter() - t_req)
            except Exception as e:  # noqa: BLE001 — fails the phase
                errs.append(repr(e))
                return

    c0 = store.cache.stats()
    ths = [threading.Thread(target=client, args=(i,))
           for i in range(POLL_THREADS)]
    t_run = time.perf_counter()
    for th in ths:
        th.start()
    time.sleep(POLL_SECS)
    stop.set()
    for th in ths:
        th.join()
    span = time.perf_counter() - t_run
    c1 = store.cache.stats()
    lat = np.sort(np.concatenate([np.asarray(x) for x in lats]))
    hits = c1["hits"] - c0["hits"]
    misses = c1["misses"] - c0["misses"]
    return {
        "served_qps": len(lat) / span,
        "p50_ms": float(lat[len(lat) // 2]) * 1e3,
        "p99_ms": float(lat[int(len(lat) * 0.99)]) * 1e3,
        "hit_rate": hits / max(1, hits + misses),
        "polls": int(len(lat)), "writes": int(sum(writes)),
        "errors": errs[:3],
    }


class ClassCounts:
    """B1's eager launches and graph replays per entity class of a
    store.  Each class table's submit and collect run under a thread-
    local class tag, and FastTable.submit — where B1 launches or
    replays on the store's path, an overflow's re-run included — runs
    under one lock that reads B1's counters before and after.  The
    eager launch that precedes each graph capture (on the capture
    thread, tagged with no class) runs under the same lock and is
    counted apart (`capture_warmups`).  close() restores all three."""

    def __init__(self, store):
        from dss_tpu_torch.ops import resident

        self.by = {cls: {"launches": 0, "graph_replays": 0}
                   for cls in STORE_CLASSES}
        self.by["capture_warmups"] = {"launches": 0, "graph_replays": 0}
        self._tag = threading.local()
        self._lock = threading.Lock()
        self._tables = []
        for index, cls in store._class_indexes():
            t = index.table
            for name in ("query_many_submit", "query_many_collect"):
                setattr(t, name, self._tagged(getattr(t, name), cls))
            self._tables.append(t)
        self._patched = [(FastTable, "submit", FastTable.submit),
                         (resident._Instance, "capture",
                          resident._Instance.capture)]
        FastTable.submit = self._counted(FastTable.submit)
        resident._Instance.capture = self._tagged(
            self._counted(resident._Instance.capture), "capture_warmups")

    def _tagged(self, fn, cls):
        def run(*a, **kw):
            prev = getattr(self._tag, "cls", None)
            self._tag.cls = cls
            try:
                return fn(*a, **kw)
            finally:
                self._tag.cls = prev
        return run

    def _counted(self, submit):
        fwf = ff.fused_window_filter

        def run(obj, *a, **kw):
            with self._lock:
                l0, r0 = fwf.launches, fwf.graph_replays
                try:
                    return submit(obj, *a, **kw)
                finally:
                    cls = getattr(self._tag, "cls", None)
                    if cls is not None:
                        self.by[cls]["launches"] += fwf.launches - l0
                        self.by[cls]["graph_replays"] += (
                            fwf.graph_replays - r0)
        return run

    def close(self):
        for owner, name, fn in self._patched:
            setattr(owner, name, fn)
        for t in self._tables:
            for name in ("query_many_submit", "query_many_collect"):
                t.__dict__.pop(name, None)


def settle(store, quiet_s=1.0, limit_s=120.0) -> float:
    """Wait until no class table has a fold running, signalled or due
    (a pending overlay, or churn past the major-compaction ratio), at
    two checks quiet_s apart.  -> seconds waited."""
    t0 = time.perf_counter()
    tables = [index.table for index, _ in store._class_indexes()]

    def busy(t):
        st = t._state
        churn = bool(t._delta or len(st.tiers) > 1
                     or any(x.dead_count for x in st.tiers))
        return (t._folding or t._fold_event.is_set() or bool(st.pending)
                or (churn and t._want_major()))

    calm = 0
    while calm < 2 and time.perf_counter() - t0 < limit_s:
        calm = 0 if any(busy(t) for t in tables) else calm + 1
        time.sleep(quiet_s)
    return time.perf_counter() - t0


def tiers_by_class(store) -> dict:
    return {cls: index.table.stats().get("tier_count", 0)
            for index, cls in store._class_indexes()}


def graph_cache_line(built, seconds, tables) -> dict:
    """The warm's entries beside the cache's bound and reservations,
    its capture failures, and the entries the reference's executable
    cache would build for the same tables (one per block count)."""
    from dss_tpu_torch.ops import resident

    cache = resident.graph_cache()
    return {"entries": built, "seconds": seconds, "cache_entries":
            cache.size(), "cap": cache.cap(), "reserved": cache.reserved(),
            "evictions": cache.evictions,
            "capture_failures": cache.capture_failures,
            "reference_entries": resident.reference_grid_entries(tables)}


def store_tables(store) -> list:
    return [tier.snap.fast for index, _ in store._class_indexes()
            for tier in index.table._state.tiers
            if tier.snap.fast is not None]


# -- services and HTTP: the top of the main path ------------------------------


def svc_square(key, half=0.004) -> list:
    """A square of +-half degrees around the center of DAR key `key`'s
    cell (an odd key: a valid level-13 cell)."""
    lat, lng = s2cell.xyz_to_latlng(
        s2cell.cell_center(int(s2cell.dar_key_to_cell(key | 1))))
    lat, lng = float(lat), float(lng)
    return [(lat - half, lng - half), (lat - half, lng + half),
            (lat + half, lng + half), (lat + half, lng - half)]


def scd_volume(poly, alo, ahi, t0, t1) -> dict:
    """An SCD Volume4D request dict (t0, t1 in ns)."""
    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.services import serialization as ser

    return {
        "volume": {
            "outline_polygon": {"vertices": [
                {"lat": a, "lng": b} for a, b in poly]},
            "altitude_lower": {"value": alo, "reference": "W84",
                               "units": "M"},
            "altitude_upper": {"value": ahi, "reference": "W84",
                               "units": "M"},
        },
        "time_start": {"value": ser.format_time(from_nanos(t0)),
                       "format": "RFC3339"},
        "time_end": {"value": ser.format_time(from_nanos(t1)),
                     "format": "RFC3339"},
    }


def svc_aois(seed, n, now) -> list:
    """n operational-intent queries as the SCD service's request dicts
    (area_of_interest: a square over the metro region, a 10-600 m band,
    a 1-2 h window in whole seconds from `now`), with the DAR keys of
    the covering the service computes and the oracle's arguments."""
    from dss_tpu_torch.clock import to_nanos
    from dss_tpu_torch.services import serialization as ser

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        poly = svc_square(int(rng.integers(0, N_CELLS)))
        alo = float(rng.integers(0, 2400))
        ahi = alo + float(rng.integers(10, 600))
        t0 = now + int(rng.integers(-3, 3)) * HOUR + int(
            rng.integers(0, 3600)) * 1_000_000_000
        t1 = t0 + int(rng.integers(1, 3)) * HOUR
        aoi = scd_volume(poly, alo, ahi, t0, t1)
        v = ser.volume4d_from_scd_json(aoi)
        keys = s2cell.cell_to_dar_key(v.calculate_spatial_covering())
        out.append(({"area_of_interest": aoi},
                    (keys, alo, ahi, to_nanos(v.start_time),
                     to_nanos(v.end_time))))
    return out


def isa_area(k) -> str:
    """The RID search area string over poll area k."""
    poly = svc_square(k * POLL_CELLS + POLL_CELLS // 2)
    return ",".join(f"{a},{b}" for a, b in poly)


def lat_ms(lats) -> dict:
    a = np.sort(np.asarray(lats)) * 1e3
    return {"p50_ms": float(a[len(a) // 2]),
            "p99_ms": float(a[min(len(a) - 1, int(len(a) * 0.99))])}


def services_phase(store, twin, orc, seed) -> tuple:
    """The services over the store phase's booted store: RIDService and
    SCDService from the port; SVC_SAMPLE ISA searches held against the
    memory twin's RIDService, SVC_SAMPLE operational-intent queries
    held against the oracle (each from one caller), then the bulk stale
    drain through SCDService.search_operations (it searches with
    allow_stale=True), STORE_BURSTS bursts.  B1's counts are set to 0
    just before and read just after.  -> (the `services` line,
    failures)."""
    from dss_tpu_torch.services.rid import RIDService
    from dss_tpu_torch.services.scd import SCDService

    rid_svc = RIDService(store.rid, store.clock)
    twin_svc = RIDService(twin.rid, twin.clock)
    scd_svc = SCDService(store.scd, store.clock)
    failures = []
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    t_all = time.perf_counter()
    rng = np.random.default_rng(seed)
    lat_isa, lat_op = [], []
    for k in rng.integers(0, POLL_AREAS, SVC_SAMPLE):
        area = isa_area(int(k))
        t = time.perf_counter()
        got = rid_svc.search_isas(area)
        lat_isa.append(time.perf_counter() - t)
        want = twin_svc.search_isas(area)
        STORE_TALLY.check(
            sorted(a["id"] for a in got["service_areas"])
            == sorted(a["id"] for a in want["service_areas"]),
            f"services: ISA search over area {k} != memory twin")
    hits = 0
    for params, args in svc_aois(seed + 1, SVC_SAMPLE, orc.now):
        t = time.perf_counter()
        got = scd_svc.search_operations(params, "uss0")
        lat_op.append(time.perf_counter() - t)
        ids = sorted(o["id"] for o in got["operation_references"])
        hits += len(ids)
        STORE_TALLY.check(ids == orc.ids(*args),
                          "services: op query != oracle")
    single_s = sum(lat_isa) + sum(lat_op)  # the service calls alone
    bursts = [svc_aois(seed + 2 + k, BURST_CALLERS, orc.now)
              for k in range(STORE_BURSTS)]
    burst = drain_bursts(
        store, bursts,
        lambda it: sorted(o["id"] for o in scd_svc.search_operations(
            it[0], "uss0")["operation_references"]),
        lambda it: orc.ids(*it[1]), "services")
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays
    if burst["client_errors"]:
        failures.append(f"services burst: {burst['client_errors']}")
    if burst["device_loss_absorbed"]:
        failures.append("services burst: device loss absorbed")
    if launches + replays <= 0:
        failures.append("services: no drain reached B1")
    return {"services": {
        "isa_searches": SVC_SAMPLE, "op_queries": SVC_SAMPLE,
        "op_hits": hits,
        "searches_per_s": 2 * SVC_SAMPLE / single_s,
        "isa_search": lat_ms(lat_isa), "op_query": lat_ms(lat_op),
        "burst": burst, "b1_launches": launches,
        "b1_graph_replays": replays,
        "mismatches": STORE_TALLY.mismatches,
        "seconds": time.perf_counter() - t_all,
    }}, failures


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(base, method, path, body=None, timeout=30.0):
    """One request with the standard library -> (status, JSON body)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def metric_values(text, suffix) -> dict:
    """{series: value} of the /metrics lines whose family name ends
    with `suffix`, labelled or not."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, val = line.rsplit(" ", 1)
        if name.split("{", 1)[0].endswith(suffix):
            out[name] = float(val)
    return out


def http_phase(smi) -> tuple:
    """The server entry as a process on the card:
    `python3 -m dss_tpu_torch.cmds.server --storage cuda` booted from a
    WAL of HTTP_OPS operational intents and the poll recipe's ISAs
    (their windows set from the wall clock, which the server keeps),
    driven with urllib: an ISA's PUT, GET, search and DELETE; an
    operational intent PUT with its key, queried, updated and DELETEd;
    HTTP_SEARCHES op queries held against the oracle of the same WAL;
    /metrics and /status; a closed loop of HTTP_LOOP_CLIENTS client
    threads, then the process-client loops of LOOP_CLIENTS (the shm
    front's comparison); then SIGTERM, which must stop the server
    within --shutdown_grace.  -> (the `http` line, failures, the state
    the shm front phase boots from: its WAL, columns, clock and
    queries; the caller removes its directory).  Without aiohttp it
    does not run."""
    import importlib.util
    import os
    import shutil
    import signal
    import uuid

    if importlib.util.find_spec("aiohttp") is None:
        return {"http": {"ran": False,
                         "why": "aiohttp is not installed on this machine"}
                }, [], None
    from dss_tpu_torch.services import serialization as ser
    from dss_tpu_torch.clock import from_nanos

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "http_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wal = os.path.join(work, "dss.wal")
    # wall-clock windows: no intent ends within 30 min of the phase, so
    # the oracle's `now` and the server's agree on every expiry
    now = time.time_ns() // 1_000_000_000 * 1_000_000_000
    cols = store_columns(HTTP_OPS, seed=9, now=now + HOUR // 2)
    t = time.perf_counter()
    write_store_wal(wal, cols, now=now)
    n_records = HTTP_OPS + POLL_ISAS + 2 * STORE_SUBS + STORE_CSTS
    wal_s = time.perf_counter() - t
    log(json.dumps(replay_profile(wal, n_records, torch.device(HTTP_DEVICE),
                                  smi)))
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    err_path = os.path.join(work, "server.log")
    errf = open(err_path, "wb")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--enable_scd", "--storage", "cuda",
         "--device", HTTP_DEVICE, "--insecure_no_auth", "--wal_path", wal,
         "--shutdown_grace", str(HTTP_GRACE_S), "--inline_reads", "on"],
        cwd=root, stdout=subprocess.DEVNULL, stderr=errf)
    line, failures = {}, []
    try:
        import urllib.request

        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited at boot: rc "
                                   f"{proc.returncode}")
            if time.perf_counter() - t_start > 300:
                raise RuntimeError("server never became healthy")
            try:
                with urllib.request.urlopen(base + "/healthy",
                                            timeout=1) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.1)
        boot_s = time.perf_counter() - t_start
        t_healthy = time.perf_counter()
        while True:  # the boot warm ends with its log line
            with open(err_path, "rb") as f:
                warm = [json.loads(x) for x in f.read().splitlines()
                        if b"resident graph warm" in x
                        or b"resident warm failed" in x]
            if warm:
                break
            if time.perf_counter() - t_healthy > 300:
                raise RuntimeError("the boot warm never ended")
            time.sleep(0.1)
        warm_s = time.perf_counter() - t_healthy
        if "failed" in warm[0]["msg"]:
            raise RuntimeError(f"boot warm: {warm[0]}")

        def ok(status_body, what, want=200):
            status, body = status_body
            if status != want:
                raise RuntimeError(f"{what}: HTTP {status} {body}")
            return body

        # an ISA: PUT, GET, search, DELETE
        w0, w1 = from_nanos(now + 10 * 60 * 10**9), from_nanos(now + HOUR)
        isa_id = str(uuid.uuid4())
        poly = svc_square(7 * POLL_CELLS + 1)
        ext = {"spatial_volume": {"footprint": {"vertices": [
            {"lat": a, "lng": b} for a, b in poly]},
            "altitude_lo": 0.0, "altitude_hi": 120.0},
            "time_start": ser.format_time(w0), "time_end": ser.format_time(w1)}
        isa_path = f"/v1/dss/identification_service_areas/{isa_id}"
        v = ok(http_json(base, "PUT", isa_path, {
            "extents": ext, "flights_url": "https://uss.example/f"}),
            "ISA PUT")["service_area"]["version"]
        if ok(http_json(base, "GET", isa_path), "ISA GET")[
                "service_area"]["version"] != v:
            raise RuntimeError("ISA GET: another version")
        found = ok(http_json(base, "GET", "/v1/dss/identification_service_"
                             "areas?area=" + ",".join(
                                 f"{a},{b}" for a, b in poly)), "ISA search")
        if isa_id not in [a["id"] for a in found["service_areas"]]:
            raise RuntimeError("ISA search missed the new ISA")
        ok(http_json(base, "DELETE", f"{isa_path}/{v}"), "ISA DELETE")
        # an operational intent: PUT with its key, query, update, DELETE
        aoi = scd_volume(svc_square(1001), 0.0, 3000.0,
                         now + HOUR // 3, now + HOUR)
        op_id = str(uuid.uuid4())
        op_path = f"/dss/v1/operation_references/{op_id}"
        body = {"extents": [aoi], "uss_base_url": "https://uss.example",
                "new_subscription": {"uss_base_url": "https://uss.example"},
                "state": "Accepted", "old_version": 0, "key": []}
        status, conflict = http_json(base, "PUT", op_path, body)
        key = []
        if status == 409:
            key = [c["operation_reference"]["ovn"]
                   for c in conflict["entity_conflicts"]
                   if "operation_reference" in c]
            body["key"] = key
        elif status != 200:
            raise RuntimeError(f"op PUT: HTTP {status} {conflict}")
        put = (ok(http_json(base, "PUT", op_path, body), "op PUT with key")
               if status == 409 else conflict)
        ovn = put["operation_reference"]["ovn"]
        q = ok(http_json(base, "POST", "/dss/v1/operation_references/query",
                         {"area_of_interest": aoi}), "op query")
        if op_id not in [o["id"] for o in q["operation_references"]]:
            raise RuntimeError("op query missed the new intent")
        body.update(old_version=1, key=key + [ovn], state="Activated")
        upd = ok(http_json(base, "PUT", op_path, body), "op update")
        if upd["operation_reference"]["version"] != 2:
            raise RuntimeError(f"op update: {upd['operation_reference']}")
        ok(http_json(base, "DELETE", op_path), "op DELETE")
        # HTTP_SEARCHES op queries against the oracle of the same WAL
        orc = StoreOracle(cols, time.time_ns())
        mism = 0
        aois = svc_aois(71, HTTP_SEARCHES, now + HOUR // 2)
        for params, args in aois:
            got = ok(http_json(base, "POST",
                               "/dss/v1/operation_references/query", params),
                     "op query")
            ids = sorted(o["id"] for o in got["operation_references"])
            good = ids == orc.ids(*args)
            mism += not good
            STORE_TALLY.check(good, "http: op query != oracle")
        status_doc = ok(http_json(base, "GET", "/status"), "/status")
        # a closed loop of clients, one search each per request
        stop = threading.Event()
        lats, errs = [[] for _ in range(HTTP_LOOP_CLIENTS)], []

        def client(i):
            k = i
            while not stop.is_set():
                params = aois[k % len(aois)][0]
                k += HTTP_LOOP_CLIENTS
                t = time.perf_counter()
                status, _ = http_json(
                    base, "POST", "/dss/v1/operation_references/query",
                    params)
                if status != 200:
                    errs.append(status)
                    return
                lats[i].append(time.perf_counter() - t)

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(HTTP_LOOP_CLIENTS)]
        t = time.perf_counter()
        for th in ths:
            th.start()
        time.sleep(HTTP_LOOP_S)
        stop.set()
        for th in ths:
            th.join(30)
        span = time.perf_counter() - t
        if errs:
            raise RuntimeError(f"closed loop: HTTP {errs[:3]}")
        loop = np.concatenate([np.asarray(x) for x in lats])
        bodies = [params for params, _ in aois]
        loop_procs = [proc_loop(base, bodies, c, work) for c in LOOP_CLIENTS]
        for lp in loop_procs:
            if lp["errors"] or set(lp["codes"]) != {"200"}:
                failures.append(f"http: process loop {lp}")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        fails = metric_values(metrics, "_co_res_graph_capture_failures")
        entries = metric_values(metrics, "_co_res_aot_buckets")
        mix = {r: int(sum(metric_values(
            metrics, f"_co_route_{r}_batches").values()))
            for r in ("host", "hostchunk", "device", "resident")}
        plans = {r: int(sum(metric_values(
            metrics, f"_co_plan_{r}").values()))
            for r in ("cache", "inline", "hostchunk", "device", "resident")}
        line = {
            "wal_records": n_records, "wal_s": wal_s,
            "boot_s": boot_s, "boot_records_per_s": n_records / boot_s,
            "healthy_to_warm_end_s": warm_s, "warm_log": warm[0]["msg"],
            "graph_entries": max(entries.values(), default=0),
            "capture_failures": max(fails.values(), default=0),
            "searches": HTTP_SEARCHES, "mismatches": mism,
            "loop": {"clients": HTTP_LOOP_CLIENTS, "seconds": span,
                     "queries_per_s": len(loop) / span, **lat_ms(loop)},
            "loop_procs": loop_procs,
            "route_mix": mix, "plan_mix": plans,
            "status_keys": sorted(status_doc),
            "inline_reads": "on",
            "b1": "not expected: the executor holds at most 32 callers,"
                  " and drains of <= 64 take the host scan",
            "card": smi,
        }
        if line["capture_failures"] > 0:
            failures.append(f"http: {line['capture_failures']} capture "
                            "failures")
    finally:
        t = time.perf_counter()
        rc = None
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
                failures.append("http: the server outlived its grace")
        else:
            rc = proc.returncode
            failures.append(f"http: the server died (rc {rc})")
        errf.close()
        line.update(sigterm_exit_s=time.perf_counter() - t, exit_code=rc)
        # the server's own account: the native halves at boot, and
        # where its READ handlers ran (logged at shutdown)
        with open(err_path, "rb") as f:
            msgs = [json.loads(x).get("msg", "")
                    for x in f.read().splitlines() if x.startswith(b"{")]
        nat = [m for m in msgs if m.startswith("native host halves:")]
        reads = [m for m in msgs if m.startswith("reads: ")]
        line["native_ready"] = bool(nat) and "loaded" in nat[0]
        if not line["native_ready"]:
            failures.append(f"http: native halves not loaded ({nat})")
        if reads:
            n = [int(w) for w in reads[0].replace(",", "").split()
                 if w.isdigit()]
            line["reads"] = dict(zip(("inline", "rerun", "executor"), n))
            line["inline_share"] = n[0] / max(1, sum(n))
        else:
            failures.append("http: no reads line at shutdown")
        if rc != 0:
            with open(err_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            failures.append(f"http: exit code {rc}: {tail}")
    state = {"work": work, "wal": wal, "cols": cols, "now": now,
             "aois": aois, "n_records": n_records}
    return {"http": line}, failures, state


_LOOP_CLIENT = r"""
import http.client, json, sys, threading, time

host, port, path, bodies_file, threads, start_at, warm_s, run_s, k0 = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), float(sys.argv[6]), float(sys.argv[7]),
    float(sys.argv[8]), int(sys.argv[9]))
with open(bodies_file, "rb") as f:
    bodies = [json.dumps(b).encode() for b in json.load(f)]
hdr = {"Content-Type": "application/json"}
lats, codes, errors = [], {}, []
lock = threading.Lock()


def client(i):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    k = k0 + i
    own, own_codes = [], {}
    while time.time() < start_at:
        time.sleep(0.001)
    t_warm, t_end = start_at + warm_s, start_at + warm_s + run_s
    while True:
        t = time.time()
        if t >= t_end:
            break
        try:
            conn.request("POST", path, bodies[k % len(bodies)], hdr)
            r = conn.getresponse()
            r.read()
            code = str(r.status)
        except (OSError, http.client.HTTPException) as e:
            with lock:
                errors.append(repr(e))
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=30)
            continue
        k += 1009
        if t >= t_warm:
            own.append(time.time() - t)
            own_codes[code] = own_codes.get(code, 0) + 1
    conn.close()
    with lock:
        lats.extend(own)
        for c, n in own_codes.items():
            codes[c] = codes.get(c, 0) + n


ths = [threading.Thread(target=client, args=(i,)) for i in range(threads)]
for th in ths:
    th.start()
for th in ths:
    th.join()
print(json.dumps({"lats": lats, "codes": codes, "errors": errors[:5],
                  "n_errors": len(errors)}))
"""


def proc_loop(base, bodies, clients, work, path="/dss/v1/operation_"
              "references/query") -> dict:
    """A closed loop of `clients` clients over LOOP_PROCS processes of
    the standard library alone, each client thread on one keep-alive
    connection, cycling `bodies`: LOOP_WARM_S of warm-up, then
    HTTP_LOOP_S timed.  -> queries/s, p50/p99 ms, status codes."""
    import os

    bodies_file = os.path.join(work, "loop_bodies.json")
    with open(bodies_file, "w") as f:
        json.dump(bodies, f)
    host, port = base.rsplit("//", 1)[1].split(":")
    procs = min(LOOP_PROCS, clients)
    start_at = time.time() + 1.0  # every process up before the clock
    ps = [subprocess.Popen(
        [sys.executable, "-c", _LOOP_CLIENT, host, port, path, bodies_file,
         str(clients // procs + (i < clients % procs)), str(start_at),
         str(LOOP_WARM_S), str(HTTP_LOOP_S), str(97 * i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(procs)]
    outs = []
    for p in ps:
        out, err = p.communicate(timeout=60 + LOOP_WARM_S + HTTP_LOOP_S)
        if p.returncode != 0:
            raise RuntimeError(f"loop client exited {p.returncode}: "
                               f"{err.decode()[-1000:]}")
        outs.append(json.loads(out))
    lats = np.concatenate([np.asarray(o["lats"], float) for o in outs])
    codes = {}
    for o in outs:
        for c, n in o["codes"].items():
            codes[c] = codes.get(c, 0) + n
    return {"clients": clients, "procs": procs, "seconds": HTTP_LOOP_S,
            "queries_per_s": len(lats) / HTTP_LOOP_S,
            **(lat_ms(lats) if len(lats) else {}), "codes": codes,
            "errors": sum(o["n_errors"] for o in outs),
            "error_sample": [e for o in outs for e in o["errors"]][:3]}


class Pinned:
    """One keep-alive connection: serial requests on it stay on the
    process that accepted it (SO_REUSEPORT hashes connections, not
    requests)."""

    def __init__(self, base):
        import http.client

        host, port = base.rsplit("//", 1)[1].split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=30)

    def req(self, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        self.conn.request(method, path, data,
                          {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if raw.startswith((b"{", b"["))
                          else raw.decode(errors="replace"))

    def close(self):
        self.conn.close()


def metric_series(text, name) -> dict:
    """{labels: value} of the /metrics family `name` ('' for an
    unlabelled series)."""
    import re

    pat = re.compile(rf"^{re.escape(name)}(?:\{{([^}}]*)\}})? (\S+)$")
    out = {}
    for line in text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


def metric_sum(text, name) -> float:
    return sum(metric_series(text, name).values())


def is_process(pid) -> bool:
    """Whether `pid` names a process, not one of its threads (a
    `children` file may list a child's threads too, as gVisor's does)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for ln in f:
                if ln.startswith("Tgid:"):
                    return int(ln.split()[1]) == pid
    except OSError:
        pass
    return False


def fleet_pids(leader_pid) -> dict:
    """{worker index: pid} of the leader's read workers, from every
    leader thread's children (respawns come from a watcher thread)."""
    import os

    out = {}
    for task in os.listdir(f"/proc/{leader_pid}/task"):
        try:
            with open(f"/proc/{leader_pid}/task/{task}/children") as f:
                kids = [int(x) for x in f.read().split()]
        except OSError:
            continue
        for pid in kids:
            if not is_process(pid):
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
            except OSError:
                continue
            if "--shm_worker_index" in argv:
                out[int(argv[argv.index("--shm_worker_index") + 1])] = pid
    return out


def nvidia_fds(pid) -> int:
    """Open /dev/nvidia* descriptors of a process."""
    import os

    n = 0
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                    "/dev/nvidia")
            except OSError:
                pass
    except OSError:
        return -1
    return n


def shm_front_phase(smi, state, workers0) -> tuple:
    """The shared-memory serving front on the card: `python3 -m
    dss_tpu_torch.cmds.server --storage cuda --device cuda --workers
    SHM_WORKERS` booted from the http phase's WAL; the leader owns the
    card and its workers run `--device cpu`.  The reference's shm-smoke
    drill (bench.py:3339-3590), with keep-alive connections pinned to
    each worker and one to the leader's loopback port: SHM_BURST op
    queries and as many ISA searches through every worker, equal to
    the leader's answers and the op queries to the oracle, then again
    (worker cache hits); a write fencing exactly the cells it touches;
    read-your-writes on a worker; the process-client loops of
    LOOP_CLIENTS beside the `--workers 0` server's (`workers0`); a
    worker SIGKILLed in a burst (0 5xx from the survivors, its slots
    reclaimed, the ladder HEALTHY, the worker respawned and revived);
    the leader's /metrics (the ring, the plans, the owner's route mix,
    the merged stage histograms); only the leader on the card
    (nvidia-smi's compute apps); SIGTERM with searches in flight.
    -> (the `shm_front` line, failures)."""
    import os
    import re
    import signal
    import urllib.request
    import uuid

    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.services import serialization as ser

    root = os.path.dirname(os.path.abspath(__file__))
    work, wal, now, aois = (state["work"], state["wal"], state["now"],
                            state["aois"])
    orc = StoreOracle(state["cols"], time.time_ns())
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    err_path = os.path.join(work, "fleet.log")
    errf = open(err_path, "wb")
    # the ring's region file under `work`; a worker that dies of a
    # signal leaves its Python stack in the log
    env = dict(os.environ, TMPDIR=work, PYTHONFAULTHANDLER="1")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--enable_scd", "--storage", "cuda",
         "--device", HTTP_DEVICE, "--insecure_no_auth", "--wal_path", wal,
         "--workers", str(SHM_WORKERS), "--shutdown_grace",
         str(HTTP_GRACE_S), "--inline_reads", "on"],
        cwd=root, stdout=subprocess.DEVNULL, stderr=errf, env=env)
    line, failures, sessions = {"card": smi}, [], []

    def fail(what):
        failures.append(f"shm_front: {what}")

    def ok(status_body, what, want=200):
        status, body = status_body
        if status != want:
            raise RuntimeError(f"shm_front {what}: HTTP {status} {body}")
        return body

    def worker_session(limit_s, want=None):
        """A keep-alive connection to the public port -> (worker
        index, pid, session), retried until it lands on a worker in
        `want` (any when None)."""
        t_end = time.perf_counter() + limit_s
        while time.perf_counter() < t_end:
            if proc.poll() is not None:
                raise RuntimeError(f"the leader exited (rc "
                                   f"{proc.returncode})")
            sess = Pinned(base)
            try:
                st, text = sess.req("GET", "/metrics")
            except OSError:
                sess.close()
                time.sleep(0.2)
                continue
            m = re.search(r'process="worker-(\d+):(\d+)"', str(text))
            if st == 200 and m and (want is None or int(m.group(1)) in want):
                if ok(sess.req("GET", "/healthy"), "worker /healthy") \
                        is not None:
                    sessions.append(sess)
                    return int(m.group(1)), int(m.group(2)), sess
            sess.close()
        raise RuntimeError(f"no worker in {want} answered within "
                           f"{limit_s} s")

    try:
        # -- boot: the leader's loopback port, then every worker -------
        leader_url = None
        while leader_url is None:
            if proc.poll() is not None:
                raise RuntimeError(f"the leader exited at boot (rc "
                                   f"{proc.returncode})")
            if time.perf_counter() - t_start > 300:
                raise RuntimeError("no worker started")
            for pid in fleet_pids(proc.pid).values():
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode().split("\0")
                leader_url = argv[argv.index("--leader_url") + 1]
                break
            time.sleep(0.1)
        while True:
            try:
                with urllib.request.urlopen(leader_url + "/healthy",
                                            timeout=1) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if proc.poll() is not None or \
                    time.perf_counter() - t_start > 300:
                raise RuntimeError("the leader never became healthy")
            time.sleep(0.1)
        leader_s = time.perf_counter() - t_start
        t_h = time.perf_counter()
        while True:  # the leader's boot warm ends with its log line
            with open(err_path, "rb") as f:
                warm = [json.loads(x) for x in f.read().splitlines()
                        if b"resident graph warm" in x
                        or b"resident warm failed" in x]
            if warm:
                break
            if time.perf_counter() - t_h > 300:
                raise RuntimeError("the boot warm never ended")
            time.sleep(0.1)
        warm_s = time.perf_counter() - t_h
        if "failed" in warm[0]["msg"]:
            fail(f"boot warm: {warm[0]}")
        # keep-alive sessions after the warm: none idles long enough
        # for the server to close it
        ws = {}
        while len(ws) < SHM_WORKERS:
            i, pid, sess = worker_session(
                300 - (time.perf_counter() - t_start),
                set(range(SHM_WORKERS)) - set(ws))
            ws[i] = (pid, sess)
        line["boot"] = {"leader_healthy_s": leader_s,
                        "healthy_to_warm_end_s": warm_s,
                        "workers_healthy_s": time.perf_counter() - t_start,
                        "records": state["n_records"]}
        lsess = Pinned(leader_url)
        sessions.append(lsess)

        def scrape():
            return ok(lsess.req("GET", "/metrics"), "leader /metrics")

        # -- 1. a burst through the ring: every worker against the leader
        #    and the oracle, then again from the worker caches
        isa_paths = ["/v1/dss/identification_service_areas?area="
                     + isa_area((37 * k) % POLL_AREAS)
                     for k in range(SHM_BURST)]
        ops = aois[:SHM_BURST]
        op_path = "/dss/v1/operation_references/query"
        want_isa = [ok(lsess.req("GET", p), "leader ISA search")
                    for p in isa_paths]
        want_op = [ok(lsess.req("POST", op_path, q), "leader op query")
                   for q, _ in ops]
        mism = {"leader": 0, "oracle": 0}
        for q, body in zip(ops, want_op):
            good = sorted(o["id"] for o in body["operation_references"]) \
                == orc.ids(*q[1])
            mism["oracle"] += not good
            STORE_TALLY.check(good, "shm_front: leader op query != oracle")
        t = time.perf_counter()
        n_burst = 0
        for rnd in range(2):
            for i, (pid, sess) in sorted(ws.items()):
                for p, want in zip(isa_paths, want_isa):
                    good = ok(sess.req("GET", p), "worker ISA search") == want
                    mism["leader"] += not good
                    STORE_TALLY.check(good, f"shm_front: worker {i} ISA "
                                      "search != leader")
                for (q, args), want in zip(ops, want_op):
                    got = ok(sess.req("POST", op_path, q), "worker op query")
                    good = got == want
                    mism["leader"] += not good
                    STORE_TALLY.check(good, f"shm_front: worker {i} op "
                                      "query != leader")
                    good = sorted(o["id"] for o in got[
                        "operation_references"]) == orc.ids(*args)
                    mism["oracle"] += not good
                    STORE_TALLY.check(good, f"shm_front: worker {i} op "
                                      "query != oracle")
                n_burst += 2 * SHM_BURST
        burst_s = time.perf_counter() - t
        m = scrape()
        hits = metric_sum(m, "dss_shm_worker_cache_hits")
        line["burst"] = {
            "requests": n_burst, "seconds": burst_s,
            "mismatches": mism,
            "served_total": metric_sum(m, "dss_shm_served_total"),
            "worker_cache_hits": hits,
            "proxy_fallbacks": metric_sum(
                m, "dss_shm_worker_proxy_fallbacks"),
        }
        if line["burst"]["served_total"] <= 0:
            fail("the ring served nothing")
        if hits <= 0:
            fail("no worker cache hit")

        # -- 2. a write fences exactly the cells it touches ------------
        w0i = min(ws)
        s0 = ws[w0i][1]
        a_k, b_k = 11, 300  # two poll areas, disjoint cells
        pa = "/v1/dss/identification_service_areas?area=" + isa_area(a_k)
        pb = "/v1/dss/identification_service_areas?area=" + isa_area(b_k)
        for p in (pa, pb, pa, pb):
            ok(s0.req("GET", p), "worker poll")

        def enqueued():
            return metric_series(scrape(), "dss_shm_worker_enqueued").get(
                f'process="worker-{w0i}"', -1)

        tw0, tw1 = (from_nanos(now + 10 * 60 * 10**9),
                    from_nanos(now + HOUR))

        def isa_body(k):
            return {"extents": {"spatial_volume": {"footprint": {
                "vertices": [{"lat": a, "lng": b} for a, b in svc_square(
                    k * POLL_CELLS + POLL_CELLS // 2, half=0.002)]},
                "altitude_lo": 0.0, "altitude_hi": 120.0},
                "time_start": ser.format_time(tw0),
                "time_end": ser.format_time(tw1)},
                "flights_url": "https://shm.uss.example/f"}

        e0 = enqueued()
        ok(s0.req("GET", pb), "worker poll")
        e_hit = enqueued() - e0
        new_id = str(uuid.uuid4())
        ok(s0.req("PUT", f"/v1/dss/identification_service_areas/{new_id}",
                  isa_body(a_k)), "proxied ISA PUT")
        e1 = enqueued()
        got_a = ok(s0.req("GET", pa), "worker poll after the write")
        e_a = enqueued() - e1
        e2 = enqueued()
        ok(s0.req("GET", pb), "worker poll after the write")
        e_b = enqueued() - e2
        sees = new_id in [a["id"] for a in got_a["service_areas"]]
        same = got_a == ok(lsess.req("GET", pa), "leader poll")
        line["invalidation"] = {"enqueued_cached_poll": e_hit,
                                "enqueued_written_area": e_a,
                                "enqueued_other_area": e_b,
                                "sees_write": sees, "equals_leader": same}
        STORE_TALLY.check(sees and same, "shm_front: the poll after a "
                          "write missed it or differs from the leader")
        if (e_hit, e_a, e_b) != (0, 1, 0):
            fail(f"invalidation not exact: {line['invalidation']}")

        # -- 3. read-your-writes on one worker session ------------------
        w1i = sorted(ws)[1]
        s1 = ws[w1i][1]
        ryw = 0
        for j in range(8):
            k = 40 + 7 * j
            rid = str(uuid.uuid4())
            ok(s1.req("PUT", f"/v1/dss/identification_service_areas/{rid}",
                      isa_body(k)), "proxied ISA PUT")
            got = ok(s1.req("GET", "/v1/dss/identification_service_areas"
                            "?area=" + isa_area(k)), "worker search")
            ryw += rid in [a["id"] for a in got["service_areas"]]
        line["read_your_writes"] = {"writes": 8, "seen": ryw}
        STORE_TALLY.check(ryw == 8, "shm_front: read-your-writes missed")

        # -- 4. the closed loops against the front ---------------------
        m0 = scrape()
        bodies = [q for q, _ in aois]
        line["loops"] = [proc_loop(base, bodies, c, work)
                         for c in LOOP_CLIENTS]
        m1 = scrape()
        for lp in line["loops"]:
            if lp["errors"] or set(lp["codes"]) != {"200"}:
                fail(f"loop {lp}")
        line["workers0_loops"] = workers0

        def delta(name):
            a, b = metric_series(m0, name), metric_series(m1, name)
            return {k.split('"')[1] if '"' in k else k: b[k] - a.get(k, 0)
                    for k in b}

        line["loops_by_worker"] = {
            "served": delta("dss_shm_worker_served"),
            "cache_hits": delta("dss_shm_worker_cache_hits"),
            "plan_proxy": delta("dss_shm_worker_plan_proxy"),
        }

        # -- 5. SIGKILL one worker in a burst ---------------------------
        kill_i = max(ws)
        kill_pid = ws[kill_i][0]
        survivors = [s for i, (_, s) in ws.items() if i != kill_i] + [lsess]
        stop = threading.Event()
        counts = {"done": 0, "5xx": 0, "errors": []}
        count_lock = threading.Lock()

        def survivor(sess, off):
            k = off
            while not stop.is_set():
                try:
                    st, _ = sess.req("GET", isa_paths[k % len(isa_paths)])
                except OSError as e:
                    with count_lock:
                        counts["errors"].append(repr(e))
                    return
                with count_lock:
                    counts["done"] += 1
                    counts["5xx"] += st >= 500
                k += 1

        ths = [threading.Thread(target=survivor, args=(s, 13 * n))
               for n, s in enumerate(survivors)]
        for th in ths:
            th.start()
        time.sleep(0.5)
        os.kill(kill_pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        time.sleep(SHM_KILL_BURST_S)
        stop.set()
        for th in ths:
            th.join(30)
        m = scrape()
        status_doc = ok(lsess.req("GET", "/status"), "/status")
        kill = {"survivor_requests": counts["done"],
                "survivor_5xx": counts["5xx"],
                "survivor_errors": counts["errors"][:3],
                "dead_workers": metric_sum(m, "dss_shm_dead_workers"),
                "degraded_mode": status_doc.get("degraded_mode")}
        if counts["5xx"] or counts["errors"] or counts["done"] < 20:
            fail(f"survivors during the kill: {kill}")
        if kill["dead_workers"] != 1:
            fail(f"dead workers {kill['dead_workers']} after the kill")
        if kill["degraded_mode"] != "healthy":
            fail(f"ladder left HEALTHY: {kill['degraded_mode']}")
        new_pid = None
        while time.perf_counter() - t_kill < SHM_RESPAWN_S:
            p = fleet_pids(proc.pid).get(kill_i)
            if p is not None and p != kill_pid:
                new_pid = p
                break
            time.sleep(0.2)
        if new_pid is None:
            raise RuntimeError("the killed worker was not respawned")
        kill["respawn_s"] = time.perf_counter() - t_kill
        _, pid, sess = worker_session(
            SHM_RESPAWN_S - (time.perf_counter() - t_kill), {kill_i})
        if pid != new_pid:
            fail(f"worker {kill_i} answers as pid {pid}, not {new_pid}")
        got = ok(sess.req("GET", isa_paths[0]), "respawned worker search")
        STORE_TALLY.check(got == want_isa[0], "shm_front: the respawned "
                          "worker's answer != leader")
        while metric_sum(scrape(), "dss_shm_dead_workers") != 0:
            if time.perf_counter() - t_kill > SHM_RESPAWN_S:
                fail("the respawned worker was never revived")
                break
            time.sleep(0.2)
        kill["respawned_serving_s"] = time.perf_counter() - t_kill
        line["kill"] = kill

        # -- 6. the leader's account of the whole front -----------------
        m = scrape()
        line["front"] = {k: metric_sum(m, f"dss_shm_{k}") for k in (
            "served_total", "errors_total", "deadline_drops_total",
            "overloaded_total", "reclaimed_total", "ring_full_total",
            "serve_ms_total", "workers", "dead_workers")}
        line["front"].update({k: metric_sum(m, f"dss_shm_worker_{k}") for k in (
            "plan_shm", "plan_proxy", "proxy_fallbacks", "cache_hits",
            "cache_misses", "timeouts", "oversize", "assembly_misses")})
        line["owner_route_mix"] = {r: sum(metric_values(
            m, f"_co_route_{r}_batches").values())
            for r in ("host", "hostchunk", "device", "resident")}
        line["owner_plan_mix"] = {r: sum(metric_values(
            m, f"_co_plan_{r}").values())
            for r in ("cache", "inline", "hostchunk", "device", "resident")}
        # one graph cache serves every class: each class's series
        # repeats its counts
        line["owner_graph"] = {r: max(
            metric_values(m, f"_co_res_{r}").values(), default=0.0)
            for r in ("aot_hits", "aot_misses", "graph_captures",
                      "graph_capture_failures")}
        if line["owner_graph"]["graph_capture_failures"]:
            fail(f"graph capture failures: {line['owner_graph']}")
        stages = {}
        for lab, v in metric_series(
                m, "dss_stage_duration_seconds_count").items():
            d = dict(x.split("=") for x in lab.split(","))
            stages[f"{d['route'].strip(chr(34))}/"
                   f"{d['stage'].strip(chr(34))}"] = v
        line["stage_counts"] = stages
        # (a timeout is legal: a respawned worker's first requests may
        # find the owner still counting it dead, and take the proxy)
        if line["front"]["errors_total"]:
            fail(f"ring errors: {line['front']}")
        if not any(k.endswith("shm_ring_ms") for k in stages):
            fail("no shm_ring_ms stage in the merged histograms")
        line["b1"] = ("in the leader's process, so not counted here: "
                      "its route mix and graph hits above")

        # -- 7. only the leader on the card -----------------------------
        # nvidia-smi names processes by the host's pids, which this
        # machine's pid namespace may not share: the apps it lists are
        # counted against the processes here that hold the card (the
        # leader, and this smoke once it made a context), and each
        # process's /dev/nvidia* descriptors are read from /proc
        apps = [x.strip() for x in subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()
            if x.strip()]
        listed = {int(x.split(",")[0]) for x in apps}
        pids = fleet_pids(proc.pid)
        fds = {"leader": nvidia_fds(proc.pid), **{
            f"worker-{i}": nvidia_fds(p) for i, p in sorted(pids.items())}}
        smoke_ctx = torch.cuda.is_initialized()
        ca = line["compute_apps"] = {
            "nvidia_smi": apps, "leader_pid": proc.pid,
            "smoke_pid": os.getpid(), "smoke_holds_a_context": smoke_ctx,
            "worker_pids": pids, "expected_apps": 1 + smoke_ctx,
            "pids_in_this_namespace": bool(listed & {proc.pid, os.getpid()}),
            "workers_listed": sorted(set(pids.values()) & listed),
            "nvidia_fds": fds,
        }
        if (ca["workers_listed"] or len(apps) != ca["expected_apps"]
                or any(v != 0 for k, v in fds.items() if k != "leader")
                or fds["leader"] <= 0):
            fail(f"not the leader alone on the card: {ca}")
    finally:
        # -- 8. SIGTERM with searches in flight -------------------------
        def fire(p):
            try:
                urllib.request.urlopen(base + p, timeout=5).read()
            except OSError:
                pass  # the SIGTERM, not a failure

        flight = [threading.Thread(target=fire, args=(
            "/v1/dss/identification_service_areas?area=" + isa_area(k),))
            for k in range(16)]
        for th in flight:
            th.start()
        kids = fleet_pids(proc.pid) if proc.poll() is None else {}
        t = time.perf_counter()
        rc = None
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
                fail("the leader outlived its grace")
        else:
            rc = proc.returncode
            fail(f"the leader died (rc {rc})")
        for th in flight:
            th.join(10)
        for sess in sessions:
            sess.close()
        errf.close()
        left = [p for p in kids.values() if os.path.exists(f"/proc/{p}")]
        line.update(sigterm_exit_s=time.perf_counter() - t, exit_code=rc,
                    workers_left=left)
        if rc != 0:
            with open(err_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            fail(f"exit code {rc}: {tail}")
        if left:
            fail(f"workers outlived the leader: {left}")
            for p in left:
                os.kill(p, signal.SIGKILL)
        # the leader's account of its workers: one exit, the SIGKILLed
        # worker's, and its respawn
        with open(err_path, "rb") as f:
            text = f.read()
        events = [json.loads(x)["msg"] for x in text.splitlines()
                  if x.startswith(b"{") and b'"dss.server"' in x
                  and b'"msg": "worker ' in x]
        line["worker_events"] = events
        exits = [e for e in events if " exited " in e]
        if len(exits) != 1 or "rc=-9" not in exits[0]:
            fail(f"workers exited other than the SIGKILLed one: {events}")
        if b"Traceback" in text or b"Fatal Python error" in text:
            fail("a traceback in the fleet's log")
        if failures:
            # the fleet's own lines (not its access log) for the record
            os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
            with open(os.path.join(root, "chiprun_out",
                                   "shm_front_fleet.log"), "wb") as f:
                f.write(b"\n".join(
                    x for x in text.splitlines()
                    if b'"msg": "request"' not in x)[-2_000_000:])
    return {"shm_front": line}, failures



def replay_profile(wal, n_records, dev, smi) -> dict:
    """An in-process boot of DSSStore(storage="cuda") from `wal` under
    cProfile: the boot's seconds and the top 12 functions by cumulative
    time, for the replay that cuts the store phase to 60k.  -> the
    `store_replay_profile` line."""
    import cProfile
    import os
    import pstats

    from dss_tpu_torch.dar.dss_store import DSSStore

    prof = cProfile.Profile()
    t = time.perf_counter()
    store = prof.runcall(DSSStore, storage="cuda", device=dev, wal_path=wal)
    secs = time.perf_counter() - t
    store.close()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][3], reverse=True)
    top = []
    for (path, line_no, fn), (cc, nc, tt, ct, _) in rows[:12]:
        where = path
        for root in sys.path:
            if root and path.startswith(root + os.sep):
                where = os.path.relpath(path, root)
                break
        top.append({"function": f"{where}:{line_no}({fn})", "ncalls": nc,
                    "tottime_s": tt, "cumtime_s": ct})
    return {"store_replay_profile": {
        "records": n_records, "seconds_under_cprofile": secs,
        "records_per_s": n_records / secs, "top": top, "card": smi}}


class Receiver:
    """A stdlib HTTP server on a thread of this process that records
    every POST it is sent (the webhook of the fan-out smoke)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.got = []
        self.lock = threading.Lock()
        rec = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with rec.lock:
                    rec.got.append((self.path, json.loads(body)))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def fanout_store(dev, n_subs, n_uss, n_cells, transport, urls, **pipe_kw):
    """The reference's _fanout_store (bench.py:1514-1562) on the port: a
    DSSStore(storage="cuda") with an attached PushPipeline, n_uss
    registered webhooks (urls(u)), and n_subs RID subscriptions of 8
    cells each over one n_cells-cell area; with a storage="memory" twin
    holding the same subscriptions.  The subscriptions are folded into
    a device tier.  -> (store, pipe, twin, area)."""
    from datetime import datetime, timedelta, timezone
    import uuid

    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.models import rid as ridm
    from dss_tpu_torch.push import PushPipeline

    store = DSSStore(storage="cuda", device=dev)
    twin = DSSStore(storage="memory")
    pipe = PushPipeline(workers=pipe_kw.pop("workers", 4),
                        transport=transport, **pipe_kw)
    store.attach_push(pipe)
    for u in range(n_uss):
        pipe.register_hook(f"uss{u:03d}", urls(u))
    area = s2cell.dar_key_to_cell(np.arange(n_cells, dtype=np.int64))
    t0 = datetime.now(timezone.utc) + timedelta(minutes=5)
    for k in range(n_subs):
        lo = k % max(1, n_cells - 8)
        for s in (store, twin):
            sub = ridm.Subscription(
                id=str(uuid.UUID(int=10_000 + k, version=4)),
                owner=f"uss{k % n_uss:03d}",
                url=f"https://uss{k % n_uss:03d}.example/notify",
                cells=area[lo:lo + 8], start_time=t0,
                end_time=t0 + timedelta(hours=23),
                altitude_lo=0.0, altitude_hi=3000.0,
            )
            if s.rid.insert_subscription(sub) is None:
                raise RuntimeError("push: a subscription was refused")
    table = store.rid._sub_index.table
    table.fold()
    if table.stats()["tier_count"] < 1 or table._state.pending:
        raise RuntimeError("push: the subscriptions never reached a tier")
    return store, pipe, twin, area


def push_phase(dev, smi) -> tuple:
    """The reference's fan-out recipe (bench.py:1514-1665) on the card:
    PUSH_SUBS subscriptions, PUSH_USS hooks, one ISA, one warm and
    PUSH_WRITES timed writes, each matching every subscription through
    MatchStage's rqmatch route (B1 over the subscription DAR), every
    write's matched id set held against the memory twin's, every
    notification delivered (a counting transport) and acked; then the
    fan-out smoke (bench.py:1691-1760).  B1's counts are set to 0 just
    before the warm write and read after the drain.  -> (the `push`
    line, B1's counts in the phase, failures)."""
    from datetime import datetime, timedelta, timezone
    import uuid

    from dss_tpu_torch.models import rid as ridm

    failures = []
    delivered = []
    dlock = threading.Lock()

    def transport(url, body, headers):
        with dlock:
            delivered.append(body["subscription"]["id"])

    t_all = time.perf_counter()
    store, pipe, twin, area = fanout_store(
        dev, PUSH_SUBS, PUSH_USS, PUSH_CELLS, transport,
        lambda u: f"https://uss{u:03d}.example/notify",
        max_depth=(PUSH_WRITES + 2) * PUSH_SUBS + 1024)
    setup_s = time.perf_counter() - t_all
    try:
        t0 = datetime.now(timezone.utc)
        isa = ridm.IdentificationServiceArea(
            id=str(uuid.UUID(int=1, version=4)), owner="bench",
            url="https://uss.example/flights", cells=area, start_time=t0,
            end_time=t0 + timedelta(hours=24),
            altitude_lo=0.0, altitude_hi=3000.0)
        isa = store.rid.insert_isa(isa)
        twin.rid.insert_isa(isa)
        pre = store.stats()
        ff.fused_window_filter.launches = 0
        ff.fused_window_filter.graph_replays = 0

        def write() -> float:
            """One write matched on the card and on the twin; -> the
            card's seconds (match, bump, journal and enqueue)."""
            t = time.perf_counter()
            got = sorted(s.id for s in store.rid
                         .update_notification_idxs_in_cells(area, entity=isa))
            secs = time.perf_counter() - t
            want = sorted(s.id for s in twin.rid
                          .update_notification_idxs_in_cells(area,
                                                             entity=isa))
            PUSH_TALLY.check(got == want and len(got) == PUSH_SUBS,
                             f"push: {len(got)} matched != twin's "
                             f"{len(want)}")
            return secs

        warm_s = write()  # the first rqmatch batch
        match_s = sum(write() for _ in range(PUSH_WRITES))
        t_run_end = time.perf_counter()
        if not pipe.drain(timeout_s=300.0):
            failures.append(f"push: queue never drained "
                            f"(depth {pipe.log.depth()})")
        drain_s = time.perf_counter() - t_run_end
        launches = ff.fused_window_filter.launches
        replays = ff.fused_window_filter.graph_replays
        post = store.stats()
        rq_plans = (post["dss_dar_rid_sub_co_plan_rqmatch"]
                    - pre["dss_dar_rid_sub_co_plan_rqmatch"])
        ps = pipe.stats()
        want_acks = (PUSH_WRITES + 1) * PUSH_SUBS
        with dlock:
            n_delivered = len(delivered)
            per_sub = np.unique(np.asarray(delivered), return_counts=True)[1]
        PUSH_TALLY.check(n_delivered == want_acks
                         and bool((per_sub == PUSH_WRITES + 1).all()),
                         f"push: {n_delivered} deliveries != {want_acks}")
        if rq_plans < 1:
            failures.append(f"push: {rq_plans} rqmatch plans")
        if launches + replays <= 0:
            failures.append("push: B1 never launched in the phase")
        if ps["dss_push_acked_total"] != want_acks:
            failures.append(f"push: {ps['dss_push_acked_total']} acks != "
                            f"{want_acks}")
        if ps["dss_push_dropped_total"] or ps["dss_push_parked_total"]:
            failures.append(f"push: dropped {ps['dss_push_dropped_total']},"
                            f" parked {ps['dss_push_parked_total']}")
        lag = pipe.pool.lag_percentiles_ms()
        line = {
            "subscriptions": PUSH_SUBS, "uss_hooks": PUSH_USS,
            "timed_writes": PUSH_WRITES, "matched_per_write": PUSH_SUBS,
            "setup_s": setup_s, "warm_write_s": warm_s,
            "match_write_qps": PUSH_WRITES / match_s,
            "matched_pairs_per_s": PUSH_WRITES * PUSH_SUBS / match_s,
            "rqmatch_plans": int(rq_plans),
            "b1_launches": launches, "b1_graph_replays": replays,
            "acked": ps["dss_push_acked_total"], "delivered": n_delivered,
            "dropped": ps["dss_push_dropped_total"],
            "parked": ps["dss_push_parked_total"],
            "delivery_lag_p50_ms": lag["p50"],
            "delivery_lag_p99_ms": lag["p99"],
            "drain_s": drain_s,
        }
    finally:
        store.close()  # joins the delivery workers first
        twin.close()
    smoke, bad = fanout_smoke(dev)
    failures += bad
    line.update(fanout_smoke=smoke, compared=PUSH_TALLY.compared,
                mismatches=PUSH_TALLY.mismatches,
                seconds=time.perf_counter() - t_all, card=smi)
    return {"push": line}, {"push_phase_launches": launches,
                            "push_phase_graph_replays": replays}, failures


_CRASH_CHILD = """
import json, sys, time
from dss_tpu_torch.push.deliver import DeliveryPool
from dss_tpu_torch.push.queue import DeliveryLog

wal, sink = sys.argv[1], sys.argv[2]
log = DeliveryLog(wal, fsync=False)
fh = open(sink, "a", encoding="utf-8", buffering=1)

def transport(url, body, headers):
    fh.write(json.dumps({"nid": body["nid"]}) + chr(10))
    fh.flush()
    time.sleep(0.005)

pool = DeliveryPool(log, workers=1, transport=transport)
pool.start()
while True:
    time.sleep(0.1)
"""


def fanout_smoke(dev) -> tuple:
    """The reference's fan-out smoke (bench.py:1691-1760) on the port:
    (1) PUSH_SMOKE_SUBS subscriptions delivered over real HTTP
    (http_transport to a receiver thread of this process); one no-fault
    write, then a seeded plan of one push.match fault (absorbed onto
    the host oracle: the same ids) and two push.deliver faults
    (retried, nothing parked); (2) a delivery worker process SIGKILLed
    mid-drain over a shared delivery WAL: every acked notification was
    delivered before the kill, and the replay redelivers exactly the
    unacked ones.  -> (its line, failures)."""
    import os
    import shutil
    import signal

    from dss_tpu_torch import chaos
    from dss_tpu_torch.push.deliver import DeliveryPool, http_transport
    from dss_tpu_torch.push.queue import DeliveryLog

    failures = []
    chaos.clear_plan()
    chaos.registry().reset_counters()
    rx = Receiver()
    out = {}
    try:
        store, pipe, twin, area = fanout_store(
            dev, PUSH_SMOKE_SUBS, PUSH_SMOKE_USS, PUSH_SMOKE_CELLS,
            http_transport(3.0), lambda u: f"{rx.url}/uss{u:03d}",
            workers=2)
        try:
            oracle = sorted(s.id for s in
                            store.rid.update_notification_idxs_in_cells(area))
            twin_ids = sorted(s.id for s in
                              twin.rid.update_notification_idxs_in_cells(area))
            PUSH_TALLY.check(oracle == twin_ids
                             and len(oracle) == PUSH_SMOKE_SUBS,
                             "fanout smoke: no-fault match != twin")
            if not pipe.drain(30.0):
                failures.append("fanout smoke: no-fault drain timed out")
            base_acked = pipe.log.acked
            chaos.install_plan({"seed": 17, "events": [
                {"site": "push.match", "action": "error", "count": 1},
                {"site": "push.deliver", "action": "error", "count": 2},
            ]})
            got = sorted(s.id for s in
                         store.rid.update_notification_idxs_in_cells(area))
            PUSH_TALLY.check(got == oracle,
                             "fanout smoke: faulted match != no-fault")
            if not pipe.drain(30.0):
                failures.append("fanout smoke: faulted drain timed out")
            injected = chaos.registry().injected_by_site()
            ps = pipe.stats()
            absorbed = pipe.stage("rid_sub").absorbed
            if absorbed < 1:
                failures.append("fanout smoke: push.match not absorbed")
            if injected.get("push.match") != 1 or injected.get(
                    "push.deliver") != 2:
                failures.append(f"fanout smoke: injected {injected}")
            if ps["dss_push_parked_total"] or (
                    ps["dss_push_acked_total"] != base_acked
                    + PUSH_SMOKE_SUBS):
                failures.append(f"fanout smoke: acked "
                                f"{ps['dss_push_acked_total']}, parked "
                                f"{ps['dss_push_parked_total']}")
            if store.health.mode() != chaos.HEALTHY:
                failures.append("fanout smoke: the ladder left healthy")
        finally:
            chaos.clear_plan()
            store.close()
            twin.close()
        with rx.lock:
            http_got = list(rx.got)
        per_sub = {}
        for _, body in http_got:
            sid = body["subscription"]["id"]
            per_sub[sid] = per_sub.get(sid, 0) + 1
        PUSH_TALLY.check(len(http_got) == 2 * PUSH_SMOKE_SUBS
                         and set(per_sub.values()) == {2}
                         and sorted(per_sub) == oracle,
                         f"fanout smoke: {len(http_got)} HTTP deliveries")
        out.update(http_deliveries=len(http_got), match_absorbed=absorbed,
                   fault_injected=injected,
                   fault_retries=ps["dss_push_requeued_total"],
                   parked=ps["dss_push_parked_total"])
    finally:
        rx.close()

    # (2) SIGKILL a delivery worker process mid-drain
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "push_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wal = os.path.join(work, "push.wal")
    sink = os.path.join(work, "delivered.jsonl")
    n_evt = PUSH_CRASH_EVENTS
    log_ = DeliveryLog(wal, fsync=False)
    log_.register_hook("u1", "https://u1.example/notify")
    for i in range(n_evt):
        log_.enqueue("u1", "https://u1.example/notify", {"nid": i + 1})
    log_.close()

    def read_sink():
        if not os.path.exists(sink):
            return []
        got = []
        with open(sink, "r", encoding="utf-8") as fh:
            for ln in fh:
                try:
                    got.append(json.loads(ln)["nid"])
                except (ValueError, KeyError):
                    pass  # a torn tail write racing the reader
        return got

    child = subprocess.Popen([sys.executable, "-c", _CRASH_CHILD, wal, sink],
                             cwd=root, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    t = time.perf_counter()
    try:
        while len(read_sink()) < n_evt // 4:
            if child.poll() is not None:
                raise RuntimeError("fanout smoke: the worker died early")
            if time.perf_counter() - t > 120:
                raise RuntimeError("fanout smoke: the worker never "
                                   "delivered")
            time.sleep(0.01)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(10)
    before = read_sink()
    log2 = DeliveryLog(wal, fsync=False)
    pending = {n.body["nid"] for n in log2._open.values()}
    acked = set(range(1, n_evt + 1)) - pending
    lost = acked - set(before)
    PUSH_TALLY.check(not lost, f"fanout smoke: {len(lost)} acked "
                               "notifications lost at the kill")
    redelivered = []
    rlock = threading.Lock()

    def transport2(url, body, headers):
        with rlock:
            redelivered.append(body["nid"])

    pool2 = DeliveryPool(log2, workers=2, transport=transport2)
    pool2.start()
    t = time.perf_counter()
    while log2.depth() and time.perf_counter() - t < 30:
        time.sleep(0.01)
    pool2.close()
    log2.close()
    PUSH_TALLY.check(sorted(redelivered) == sorted(pending),
                     "fanout smoke: the replay did not redeliver exactly "
                     "the unacked notifications")
    PUSH_TALLY.check(set(before) | set(redelivered)
                     == set(range(1, n_evt + 1)),
                     "fanout smoke: a notification was never delivered")
    out.update(crash_events=n_evt, delivered_before_kill=len(before),
               acked_before_kill=len(acked), redelivered=len(redelivered))
    shutil.rmtree(work, ignore_errors=True)
    return out, failures


def store_phase(dev, smi) -> tuple:
    """Phase 8: the store.  Write the WAL (STORE_OPS operations and the
    rest), boot DSSStore(storage="cuda") from it, hold a sample of
    searches against the oracle, reach B1 with the bulk stale drain,
    write through the store, reboot from the same WAL and compare, and
    run the RID poll recipe cache on and off against a memory twin.
    B1's counts are set to 0 just before the searches and read after
    the poll.  -> (B1's store-phase counts, failures)."""
    import os
    import shutil

    from dss_tpu_torch.clock import FakeClock, from_nanos
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.runtime import freeze_boot_heap

    failures = []
    wal_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "store_smoke")
    shutil.rmtree(wal_dir, ignore_errors=True)
    os.makedirs(wal_dir)
    path = os.path.join(wal_dir, "dss.wal")
    t = time.perf_counter()
    cols = store_columns(STORE_OPS)
    rid = write_store_wal(path, cols)
    n_records = STORE_OPS + POLL_ISAS + 2 * STORE_SUBS + STORE_CSTS
    log(f"store wal: {n_records} records, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB, written in "
        f"{time.perf_counter() - t:.2f} s")

    def card_mib(mem0):
        if dev.type != "cuda":
            return 0.0
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated() - mem0) / 2**20

    def boot():
        """-> (store, seconds, its memory line): MiB on the card when
        the constructor returns and once its background folds settle,
        beside the tiers per class."""
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        t = time.perf_counter()
        s = DSSStore(storage="cuda", device=dev, wal_path=path,
                     clock=FakeClock(from_nanos(NOW)))
        at_return = card_mib(mem0)
        secs = time.perf_counter() - t
        waited = settle(s)
        return s, secs, {"mib_on_card": card_mib(mem0),
                         "mib_at_return": at_return, "settle_s": waited,
                         "tiers": tiers_by_class(s)}

    store, boot_s, mem = boot()
    log(json.dumps({"store_boot": {
        "records": n_records, "seconds": boot_s,
        "records_per_s": n_records / boot_s, "classes": store_counts(store),
        **mem, "card": smi}}))
    freeze_boot_heap()

    # the resident loops and their graph grid, as a server boots them
    store.configure_serving(resident=True, slo_ms=SLO_MS)
    t = time.perf_counter()
    built = store.warm_resident()
    warm = graph_cache_line(built, time.perf_counter() - t,
                            store_tables(store))
    log(json.dumps({"store_graph_warm": warm}))
    if warm["capture_failures"]:
        failures.append(f"store warm: {warm['capture_failures']} capture "
                        "failures")

    orc = StoreOracle(cols, NOW)
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    counts = ClassCounts(store)
    q = make_batch(50_000, ORACLE_SAMPLE, N_CELLS, WIDTH)
    t = time.perf_counter()
    for i in range(ORACLE_SAMPLE):
        got = op_query(store, q, i)
        STORE_TALLY.check([x[0] for x in got] == orc.ids(
            q[0][i], q[1][i], q[2][i], q[3][i], q[4][i]),
            f"store search {i} != oracle")
    log(json.dumps({"store_oracle": {
        "searches": ORACLE_SAMPLE, "mismatches": STORE_TALLY.mismatches,
        "seconds": time.perf_counter() - t}}))

    store.configure_serving(min_batch=BURST_MIN_BATCH)
    burst = store_bursts(store, orc, seed=60_000)
    if burst["client_errors"]:
        failures.append(f"store burst: {burst['client_errors']}")
    if burst["device_loss_absorbed"]:
        failures.append("store burst: device loss absorbed")
    log(json.dumps({"store_burst": burst}))

    t = time.perf_counter()
    done = store_writes(store, orc)
    q = make_batch(51_000, 128, N_CELLS, WIDTH)
    for i in range(128):
        STORE_TALLY.check([x[0] for x in op_query(store, q, i)] == orc.ids(
            q[0][i], q[1][i], q[2][i], q[3][i], q[4][i]),
            f"store search {i} after the writes != oracle")
    log(json.dumps({"store_writes": {
        **done, "seconds": time.perf_counter() - t,
        "wal_seq": store.wal.seq}}))

    # reboot from the same WAL: the time to recover, and the same state
    q = make_batch(52_000, REBOOT_SAMPLE, N_CELLS, WIDTH)
    live = [op_query(store, q, i) for i in range(REBOOT_SAMPLE)]
    held = store_counts(store)
    counts.close()
    by_class = counts.by
    store.close()
    del store  # its tables leave the card before the reboot's measure
    gc.collect()
    store, reboot_s, mem = boot()
    counts = ClassCounts(store)
    recounts = store_counts(store)
    for cls in STORE_CLASSES:
        for k in ("records", "live_records"):
            STORE_TALLY.check(recounts[cls][k] == held[cls][k],
                              f"reboot {cls} {k}: {recounts[cls][k]} != "
                              f"{held[cls][k]}")
    for i in range(REBOOT_SAMPLE):
        STORE_TALLY.check(op_query(store, q, i) == live[i],
                          f"reboot search {i} != live store")
    log(json.dumps({"store_reboot": {
        "records": store.wal.seq, "seconds": reboot_s,
        "records_per_s": store.wal.seq / reboot_s, "classes": recounts,
        **mem, "searches_compared": REBOOT_SAMPLE,
        "card": smi}}))

    # the RID poll recipe, cache on then off, against a memory twin
    twin = DSSStore(storage="memory", clock=FakeClock(from_nanos(NOW)))
    for rec in rid["rid_recs"]:
        twin.rid.apply_wal(rec)
    modes = {}
    for mode, cache in (("cache_on", True), ("cache_off", False)):
        modes[mode] = poll_pass(store, twin, rid["areas"], rid["window"],
                                cache, seed=11)
        if modes[mode]["errors"]:
            failures.append(f"store poll {mode}: {modes[mode]['errors']}")
    rng = np.random.default_rng(8)
    for a in rng.choice(len(rid["areas"]), 256, replace=False):
        area = rid["areas"][int(a)]
        got = sorted(x.id for x in store.rid.search_isas(
            area, rid["window"][0], None))
        want = sorted(x.id for x in twin.rid.search_isas(
            area, rid["window"][0], None))
        STORE_TALLY.check(got == want, f"poll area {a}: store != twin")
    log(json.dumps({"store_poll": {
        "isas": POLL_ISAS, "areas": POLL_AREAS, "ratio": POLL_RATIO,
        "zipf_a": POLL_ZIPF, "threads": POLL_THREADS, "seconds": POLL_SECS,
        **modes, "answers_checked": 256, "card": smi}}))
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays
    counts.close()
    for cls, n in counts.by.items():
        for k in n:
            by_class[cls][k] += n[k]
    log(json.dumps({"store_b1_by_class": by_class, "launches": launches,
                    "graph_replays": replays}))
    if launches + replays <= 0:
        failures.append("store phase: B1 never launched")

    # the services over the same store, before it closes
    store.configure_serving(resident=True, slo_ms=SLO_MS,
                            min_batch=BURST_MIN_BATCH)
    warm = graph_cache_line(store.warm_resident(), 0.0, store_tables(store))
    svc, bad = services_phase(store, twin, orc, seed=80_000)
    svc["services"]["graph_warm"] = warm
    svc["services"]["card"] = smi
    log(json.dumps(svc))
    failures += bad
    if warm["capture_failures"]:
        failures.append(f"services warm: {warm['capture_failures']} "
                        "capture failures")
    MESH_LINE["store_drains"], bad = mesh_store_drains(
        store, path, dev, orc, seed=90_000)
    log(json.dumps({"mesh_store_drains": MESH_LINE["store_drains"]}))
    failures += bad
    # the tuner's live loop and drills, before the store closes
    failures += tuner_live_loop(store, orc, dev, seed=100_000)
    log(json.dumps({"tuner_live_loop": TUNER_LINE["live_loop"]}))
    twin.close()
    store.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    return {"store_launches": launches, "store_graph_replays": replays,
            "store_by_class": by_class,
            "services_launches": svc["services"]["b1_launches"],
            "services_graph_replays": svc["services"]["b1_graph_replays"],
            "store_boot_s": boot_s, "store_reboot_s": reboot_s}, failures


# -- the mesh route (parallel/{mesh, sharded, replica}) ----------------------

MESH_TALLY = Tally("mesh")  # the mesh route's answers, every comparison
MESH_LINE = {}  # the `mesh` line, filled part by part
MESH_SHAPES = ((1, 1), (2, 4))  # the 2x4 on eight positions of one card
MESH_BATCHES = 4  # headline batches per mesh
MESH_ORACLE = 256  # queries of the first batch held against oracle.search
MESH_MAX_RESULTS = 512  # ShardedDar's default, shard_results the same
SKEW_COLD, SKEW_HOT, SKEW_AREAS, SKEW_QUERIES = 3000, 120, 64, 250
SKEW_ALPHAS = (0.0, 0.8, 1.2)
MESH_REPLICA, MESH_POSITIONS = "1,2", 2  # bench.py:4784's default mesh
MESH_REFRESH_S = 0.5  # --replica_refresh_interval
MESH_WRITES = 8  # ops written over HTTP, then read back from the replica
MESH_BURSTS = 16  # store-level stale drains of BURST_CALLERS
MESH_SURFACE_SAMPLE = 64  # op queries and ISA areas per surface check


def op_family(name: str) -> str:
    """The torch op behind a device kernel's name (the profiler's), for
    the mesh route's device time by op."""
    n = name.lower()
    for key, fam in (("mesh_query_kernel", "k1_mesh_query"),
                     ("mesh_merge_kernel", "k2_mesh_merge"),
                     ("memcpy htod", "copy_h2d"), ("memcpy dtoh", "copy_d2h"),
                     ("memcpy dtod", "copy_d2d"), ("memset", "memset"),
                     ("searchsorted", "searchsorted"), ("sort", "sort"),
                     ("radix", "sort"), ("scan", "cumsum"),
                     ("cumsum", "cumsum"),
                     ("scatter_gather", "gather_scatter"),
                     ("scatter", "gather_scatter"),
                     ("index", "index_select"), ("gather", "gather_scatter"),
                     ("reduce", "reduce"), ("cat", "cat"),
                     ("elementwise", "elementwise")):
        if key in n:
            return fam
    return "other"


def by_op(by_name) -> dict:
    """{op: [ms per call, launches per call]} from device_ms()'s
    per-kernel dict."""
    out = {}
    for name, (ms, k) in by_name.items():
        v = out.setdefault(op_family(name), [0.0, 0])
        v[0] += ms
        v[1] += k
    return out


def mesh_bound_padded(q, k, cap, n_postings, sp, sr) -> tuple:
    """The earlier bound of a mesh batch, kept to compare rows: the
    searched postings (int32 keys), q*k*cap candidates, padding
    included, each with an int32 slot, 25 B of columns and an int32
    sort pass, and the merge's pass over [Q, sp*shard_results] int32.
    -> (ms, bytes)."""
    cand = q * k * cap
    nbytes = 4 * n_postings + cand * (4 + 25 + 4) + 4 * q * sp * sr
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


SECTOR = 32  # bytes of one L2 / DRAM sector on the card


def search_sectors(row, keys, cap) -> int:
    """The distinct 32 B sectors of the sorted int32 `row` (pads
    included, as it lies on the card) that finding each key's run
    touches: the probes of a binary search for its first posting, then
    those of one for the run's end within the next min(left, cap)
    keys."""
    n = len(row)
    if n == 0 or cap <= 0 or len(keys) == 0:
        return 0
    probes = []
    lo = np.zeros(len(keys), np.int64)
    hi = np.full(len(keys), n, np.int64)
    while (lo < hi).any():
        act = lo < hi
        mid = lo + ((hi - lo) >> 1)
        probes.append(mid[act])
        less = row[np.minimum(mid, n - 1)] < keys
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    first = lo
    lo = np.zeros(len(keys), np.int64)
    hi = np.minimum(n - first, cap)
    while (lo < hi).any():
        act = lo < hi
        mid = lo + ((hi - lo) >> 1)
        at = np.minimum(first + mid, n - 1)
        probes.append(at[act])
        le = row[at] <= keys
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    return len(np.unique(np.concatenate(probes) * 4 // SECTOR))


def k1_bound(pk_rows, pe_rows, keys, cap, r, count=False, delta=None,
             delta_cap=0) -> dict:
    """K1's least time for one call, from the host postings: each input
    read once and each output written once at the card's memory rate.
    The 32 B key sectors that each query cell's search must touch in
    each row (`search_sectors`), the postings that the cells' runs
    reach, min(run, cap) each (int32 slots), 25 B of columns (alt_lo,
    alt_hi f32, t_start, t_end i64, active u8) for each distinct slot
    they name, the queries (keys [Q, K] int32, 32 B of bounds, now and
    owner each), and the output (slots [S, Q, r] and counts int32, or
    the counts alone in count mode).  Every query is searched in every
    row, as a dp row's queries are in each of its shards.  The earlier
    formula, which read every live key of every row once, stands beside
    it (`*_all_keys`) so that rows can be compared.
    -> {ms, bytes, candidates, ms_all_keys, bytes_all_keys}."""
    keys = np.asarray(keys)
    live_keys = keys[keys >= 0]
    rows = [(pk_rows, pe_rows, cap)]
    if delta is not None:
        rows.append((delta[0], delta[1], delta_cap))
    n_keys, sectors, n_post, cand, slots = 0, 0, 0, 0, []
    for pks, pes, c in rows:
        for pk, pe in zip(np.asarray(pks), np.asarray(pes)):
            sectors += search_sectors(pk, live_keys, c)
            m = pk != int(mc.INT32_MAX)
            pk, pe = pk[m], pe[m]
            n_keys += len(pk)
            lo = np.searchsorted(pk, live_keys, side="left")
            n = np.minimum(np.searchsorted(pk, live_keys, side="right") - lo,
                           c)
            cand += int(n.sum())
            edge = np.zeros(len(pk) + 1, np.int64)
            np.add.at(edge, lo, 1)
            np.add.at(edge, lo + n, -1)
            reached = np.cumsum(edge[:-1]) > 0
            n_post += int(reached.sum())
            slots.append(pe[reached])
    n_slots = len(np.unique(np.concatenate(slots))) if slots else 0
    s, (q, k) = len(pk_rows), keys.shape
    out = 4 * s * q * (1 if count else r + 1)
    rest = 4 * n_post + 25 * n_slots + 4 * q * k + 32 * q + out
    nbytes, old = SECTOR * sectors + rest, 4 * n_keys + rest
    return {"ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "candidates": cand, "ms_all_keys": old / HBM_BYTES_PER_S * 1e3,
            "bytes_all_keys": old}


def k2_bound(n_uni, sr, r, width) -> dict:
    """K2's least time for one dp row, from K1's counts `n_uni`
    [n_sp, Q]: it reads those counts and the min(n_uni, sr) live values
    of each shard list (int32; the rest of a list is padding it never
    reads), and writes every one of the r columns of each query's row
    (int32, pads included), a flag and a count a query, and the n_sp + 1
    sums.  The earlier formula, which read every slot of the lists and
    wrote only the batch's `width` columns of a row, stands beside it
    (`*_padded_lists`).  -> {ms, bytes, ms_padded_lists,
    bytes_padded_lists}."""
    n_uni = np.asarray(n_uni, np.int64)
    n_sp, q = n_uni.shape
    live = int(np.minimum(np.maximum(n_uni, 0), sr).sum())
    nbytes = 4 * n_sp * q + 4 * live + 4 * q * r + 5 * q + 4 * (n_sp + 1)
    old = 4 * n_sp * q * (sr + 1) + 4 * q * width + 5 * q
    return {"ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "ms_padded_lists": old / HBM_BYTES_PER_S * 1e3,
            "bytes_padded_lists": old}


MESH_ERR = dict.fromkeys(MESH_COUNTED, 0)  # largest |kernel - plain|


def mesh_check(name, got, want, what) -> None:
    """A mesh kernel's outputs against its plain version's, on the
    kernel's tally and the mesh line's; the largest absolute difference
    of any output goes to MESH_ERR."""
    if any(t.is_cuda for t in got):
        torch.cuda.synchronize()
    err, same = 0, len(got) == len(want)
    for g, w in zip(got, want):
        same = same and g.shape == w.shape and g.dtype == w.dtype
        if g.shape == w.shape and g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        same = same and torch.equal(g, w)
    MESH_ERR[name] = max(MESH_ERR[name], err)
    TALLY[name].check(same, f"{what}: max abs err {err}")
    MESH_TALLY.check(same, f"{name} {what}: kernel != plain")


def mesh_counts() -> dict:
    """The mesh kernels' launches in this process, each kernel apart:
    K1 a warp an item, K1 a block an item (the spread kernel), K2."""
    spread = mc.mesh_query.spread_launches
    return {"mesh_query": mc.mesh_query.launches - spread,
            SPREAD_KERNEL: spread, "mesh_merge": mc.mesh_merge.launches}


def mesh_counts_of(metrics) -> dict:
    """mesh_counts() of a server, from its /metrics text (where
    dss_mesh_query_launches counts both of K1's kernels)."""
    n = {name: int(sum(metric_values(metrics, f"_{name}_launches").values()))
         for name in MESH_COUNTED}
    n["mesh_query"] -= n[SPREAD_KERNEL]
    return n


def reset_mesh() -> None:
    mc.mesh_query.launches = 0
    mc.mesh_query.spread_launches = 0
    mc.mesh_merge.launches = 0


@contextlib.contextmanager
def k1_width(warps):
    """K1 at `warps` warps an item (1: a warp an item) whatever a call's
    size, for checks that hold both of its kernels to the plain
    version on the same cases."""
    choose = mc.spread_warps
    mc.spread_warps = lambda items, sms: warps
    try:
        yield
    finally:
        mc.spread_warps = choose


def k1(args, kw) -> tuple:
    """K1 on the card -> (the name of the kernel that ran, as the
    kernels line and TALLY name it, its outputs)."""
    spread = mc.mesh_query.spread_launches
    got = mc.mesh_query(*args, **kw)
    ran = SPREAD_KERNEL if mc.mesh_query.spread_launches > spread else \
        "mesh_query"
    return ran, got


def mesh_pair(k1_args, k1_kw, k2_kw, what, want_k1=None) -> None:
    """K1, and then K2 on K1's lists, each against its plain version on
    the same tensors, tallied; with `want_k1` the kernel K1 must have
    launched."""
    ran, got = k1(k1_args, k1_kw)
    if want_k1 is not None:
        MESH_TALLY.check(ran == want_k1, f"{what}: K1 ran {ran}, not "
                         f"{want_k1}")
    want = mc.mesh_query_torch(*k1_args, **k1_kw)
    if k1_kw["count"]:
        mesh_check(ran, (got,), (want,), what)
        return
    mesh_check(ran, got, want, what)
    mesh_check("mesh_merge", mc.mesh_merge(*got, **k2_kw),
               mc.mesh_merge_torch(*got, **k2_kw), what)


def mesh_kernel_checks(dev) -> None:
    """K1 and K2 against their plain versions on the card over
    mesh_cases(), then on outputs the allocator hands back full of -1
    (the kernels write every pad themselves), then 40 launches over the
    cases with no sync between them: all of it once with K1 a warp an
    item and once with the spread kernel's block of SPREAD_MAX_WARPS
    warps an item (count mode a warp an item at both), each launch's
    kernel confirmed by the spread counter."""
    cases = [(n, mesh_case_args(c, dev))
             for n, c in mesh_cases(mc.query_tile())]
    for warps in (1, mc.SPREAD_MAX_WARPS):
        with k1_width(warps):
            mesh_width_checks(cases, dev, warps)


def mesh_width_checks(cases, dev, warps) -> None:
    """mesh_kernel_checks at one width of K1 (on the CPU, where the
    wrappers run the plain versions, no call takes the spread kernel)."""
    wide = (SPREAD_KERNEL if warps > 1 and dev.type == "cuda"
            else "mesh_query")
    at = f" at {warps} warps an item"
    for name, (args, kw, mkw) in cases:
        mesh_pair(args, kw, mkw, f"case {name}{at}",
                  "mesh_query" if kw["count"] else wide)
    args, kw, mkw = dict(cases)["owner_off"]
    want = mc.mesh_query_torch(*args, **kw)
    want2 = mc.mesh_merge_torch(*want, **mkw)
    torch.cuda.synchronize()
    q = args[5].keys.shape[0]
    for name, shape in (("mesh_query", (1, q, kw["max_results"])),
                        ("mesh_merge", (q, mkw["max_results"]))):
        dirty = torch.full(shape, -1, dtype=torch.int32, device=dev)
        ptr = dirty.data_ptr()
        del dirty
        if name == "mesh_query":
            name, got = k1(args, kw)
            ref = want
            MESH_TALLY.check(name == wide, f"dirty output{at}: K1 ran "
                             f"{name}")
        else:
            got, ref = mc.mesh_merge(*want, **mkw), want2
        torch.cuda.synchronize()
        handed_back = got[0].data_ptr() == ptr
        TALLY[name].check(handed_back, "dirty output: the -1 block was "
                          "not handed back, so it tested nothing")
        MESH_TALLY.check(handed_back, f"{name} dirty output not handed back")
        mesh_check(name, got, ref, f"dirty output{at}")
    small = [(n, a) for n, a in cases if "past" not in n]
    plain = {n: (mc.mesh_query_torch(*a, **kw_),) if kw_["count"] else
             mc.mesh_query_torch(*a, **kw_) for n, (a, kw_, _) in small}
    outs = []
    for i in range(40):
        n, (a, kw_, _) = small[i % len(small)]
        ran, got = k1(a, kw_)
        MESH_TALLY.check(ran == ("mesh_query" if kw_["count"] else wide),
                         f"back-to-back launch {i}{at}: K1 ran {ran}")
        outs.append((n, ran, (got,) if kw_["count"] else got))
    for i, (n, ran, got) in enumerate(outs):
        mesh_check(ran, got, plain[n], f"back-to-back launch {i}{at}")


def dar_row_args(dar, q, d, now=NOW) -> list:
    """K1's arguments for dp row `d` of ShardedDar `dar` on batch `q`,
    as sharded_conflict_query_batch builds them (keys padded to the
    reference's bucket of 16) -> [(device, columns, args, kw)], one a
    device group of the row."""
    from dss_tpu_torch.ops import conflict as oc
    from dss_tpu_torch.parallel import sharded as ps

    keys = q[0]
    kw = 16
    while kw < keys.shape[1]:
        kw *= 2
    keys = np.pad(keys, ((0, 0), (0, kw - keys.shape[1])),
                  constant_values=-1)
    qloc = len(keys) // dar.dp
    rows = slice(d * qloc, (d + 1) * qloc)
    out = []
    for dev, shards in dar.mesh.row_groups(d):
        spec = oc.query_spec(keys[rows], *(a[rows] for a in q[1:]), dev)
        args = (dar.post_key.rows(dev, shards), dar.post_ent.rows(dev, shards),
                None, None, oc._u8(dar.ents[dev]), spec,
                torch.full((qloc,), now, dtype=torch.int64, device=dev), None)
        out.append((dev, list(shards), args,
                    {"cap": dar.cap, "delta_cap": 0,
                     "max_results": dar.shard_results,
                     "rows": dar.rows[dev]}))
    return out


def dar_kernel_checks(dar, q, what, now=NOW) -> list:
    """Every dp row of `dar` on batch `q` through K1 and K2 and through
    their plain versions on the same card tensors, slot for slot,
    tallied.  -> [(row's K1 columns, K2 kwargs)] for the timings."""
    from dss_tpu_torch.parallel import sharded as ps

    mkw = {"shard_results": dar.shard_results,
           "max_results": dar.max_results}
    rows = []
    for d in range(dar.dp):
        groups = []
        for dev, shards, args, kw in dar_row_args(dar, q, d, now):
            ran, got = k1(args, kw)
            mesh_check(ran, got, mc.mesh_query_torch(*args, **kw),
                       f"{what} row {d}")
            groups.append((dev, shards, *got))
        cols = ps._row_columns(groups, dar.n_sp, dar.mesh.devices[d, 0])
        mesh_check("mesh_merge", mc.mesh_merge(*cols, **mkw),
                   mc.mesh_merge_torch(*cols, **mkw), f"{what} row {d}")
        rows.append((cols, mkw))
    return rows


def mesh_case(recs, queries, *, n_sp=1, delta=None, r=16, merge_r=None,
              cap=None, delta_cap=8, count=False, owner=None, now=NOW,
              dead=9, base=True, reverse_runs=False):
    """One case of the mesh kernels as numpy inputs: Records -> the
    entity columns (every `dead`-th slot dead; 0: none), their postings
    split over n_sp shards (the equal-count split; none without
    `base`; with `reverse_runs` each key's run of slots descending, not
    in slot order), `delta` (slots whose postings also form the delta
    rows, S = 1 only), `queries` (keys [Q, K] and the bounds), `owner`
    [Q] or None, `now` (scalar or [Q]); K1 compacts to r, K2 merges the
    n_sp shard lists to merge_r."""
    from dss_tpu_torch.parallel.sharded import shard_postings

    p = pack_records(recs, pad_postings=False)

    active = p.active.copy()
    if dead:
        active[::dead] = False
    pk, pe = shard_postings(p.post_key, p.post_ent, n_sp, p.capacity)
    if reverse_runs:
        for row_k, row_e in zip(pk, pe):
            for key in np.unique(row_k[row_k != int(mc.INT32_MAX)]):
                at = np.flatnonzero(row_k == key)
                row_e[at] = row_e[at[::-1]]
    if p.n_postings == 0 or not base:
        pk, pe = pk[:, :0], pe[:, :0]
    dk = de = None
    if delta is not None:
        take = np.isin(p.post_ent, np.asarray(delta, np.int32))
        dk, de = p.post_key[take][None], p.post_ent[take][None]
    keys, alo, ahi, t0, t1 = queries
    nq = len(keys)
    return {
        "records": recs, "n_sp": n_sp,
        "pk": pk, "pe": pe, "dk": dk, "de": de,
        "ents": (p.alt_lo, p.alt_hi, p.t_start, p.t_end,
                 active.astype(np.uint8), p.owner),
        "keys": np.ascontiguousarray(keys, np.int32),
        "qalo": np.asarray(alo, np.float32),
        "qahi": np.asarray(ahi, np.float32),
        "qt0": np.asarray(t0, np.int64), "qt1": np.asarray(t1, np.int64),
        "now": np.broadcast_to(np.asarray(now, np.int64), (nq,)).copy(),
        "owner": None if owner is None else np.asarray(owner, np.int32),
        "cap": p.base_cap if cap is None else cap, "delta_cap": delta_cap,
        "r": r, "merge_r": r if merge_r is None else merge_r, "count": count,
    }


MESH_CASE_NAMES = (
    "random_k16_sp1_owner", "random_k32_sp2_sr_lt_mr", "random_k16_sp8",
    "random_k32_sp8_owner", "p0_all_pad_keys", "p0_delta_only",
    "k1_n_unique_r-1", "k1_n_unique_r", "k1_n_unique_r+1",
    "k2_n_unique_r-1", "k2_n_unique_r", "k2_n_unique_r+1",
    "slot_in_cells_and_delta", "now_past_t_end", "owner_off", "count_mode",
    "k1_past_shared_memory", "k2_past_shared_memory", "k1_run_out_of_order",
    "k1_hits_tile-1", "k1_hits_tile", "k1_hits_tile+1",
    "k1_k48_spill_second_chunk", "k2_slot_in_all_8_lists",
)


def mesh_cases(tile) -> list:
    """The mesh kernels' fixed edge cases (numpy, from seeds) ->
    [(name, case)]: random tables at K 16 and 32 on 1, 2 and 8 shards
    (shard_results below max_results on 2), owner filter on and off;
    P = 0 with all-pad keys, and P = 0 with a delta; n_unique at R-1, R
    and R+1 for K1 and for K2; one slot in several query cells and in
    both base and delta; `now` past t_end for some queries; the count
    mode; K*cap past one block's shared memory (K1) and n_sp*sr past it
    (K2); runs of slots out of slot order; an item's hits at K1's
    shared tile of `tile` int32 (the built kernel's,
    `mesh_cuda.query_tile()`) less one, equal to it and one past it (the
    spill to its global slice); K 48 whose hits pass a tile of 512 in
    the second chunk of 32 cells; one slot in every one of 8 shard
    lists (K2)."""
    rng = np.random.default_rng(77)
    recs = []
    for i in range(400):
        keys = np.unique(rng.integers(0, 300, int(rng.integers(1, 7))))
        alo = float(np.float32(rng.uniform(0, 3000)))
        ahi = float(np.float32(alo + rng.uniform(10, 900)))
        if i % 13 == 0:
            alo = -np.inf
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        recs.append(Record(f"r{i}", keys.astype(np.int32), alo, ahi, t0,
                           t0 + int(rng.integers(1, 7)) * HOUR,
                           int(rng.integers(0, 5))))

    def queries(seed, nq, k, key_space=300, open_bounds=False):
        r = np.random.default_rng(seed)
        keys = np.full((nq, k), -1, np.int32)
        for i in range(nq):
            u = np.unique(r.integers(0, key_space, int(r.integers(1, k))))
            keys[i, : len(u)] = u
        alo = r.uniform(0, 3000, nq).astype(np.float32)
        ahi = (alo + 900).astype(np.float32)
        t0 = (NOW + r.integers(-3, 3, nq) * HOUR).astype(np.int64)
        t1 = t0 + 2 * HOUR
        if open_bounds:
            alo[:], ahi[:], t0[:], t1[:] = -np.inf, np.inf, NO_TIME_LO, \
                NO_TIME_HI
        alo[::5], ahi[::5] = -np.inf, np.inf
        t0[::4], t1[::4] = NO_TIME_LO, NO_TIME_HI
        return keys, alo, ahi, t0, t1

    def owners(seed, nq):
        return np.random.default_rng(seed).integers(0, 5, nq)

    def same(n, key_of, alo=0.0, ahi=100.0):
        return [Record(f"s{i}", np.asarray(key_of(i), np.int32), alo, ahi,
                       NOW - HOUR, NOW + HOUR, 1) for i in range(n)]

    def one_query(keys, k=16, nq=1):
        rows = np.full((nq, k), -1, np.int32)
        rows[:, : len(keys)] = keys
        return (rows, np.full(nq, -np.inf, np.float32),
                np.full(nq, np.inf, np.float32), np.full(nq, NO_TIME_LO),
                np.full(nq, NO_TIME_HI))

    later = np.full(24, NOW, np.int64)
    later[::3] = NOW + 6 * HOUR  # past every t_end of those queries' hits
    line = same(16, lambda i: [5 + i])  # 16 slots, one per key 5..20
    hot = same(600, lambda i: [9])  # one cell of 600 slots: cap 1024
    cells = same(12, lambda i: [3, 4, 5])  # every slot in three cells
    wide = [Record(f"w{i}", np.asarray([i], np.int32), 0.0, 100.0,
                   NOW - HOUR, NOW + HOUR, 1) for i in range(8 * 300)]
    wq = one_query(np.arange(0, 8 * 300, 150, dtype=np.int32))

    def tile_hits(extra):
        # 8 cells of tile / 8 slots, the last with `extra` more: every
        # candidate hits, so the item has tile + extra hits
        return same(tile + extra, lambda i: [min(i // (tile // 8), 7)])

    # chunk 0: 32 cells of 2 slots; chunk 1: 16 cells of 40 postings,
    # every slot in two of them (704 hits, 384 unique)
    k48 = (same(64, lambda i: [1000 + i // 2])
           + same(320, lambda i: [2000 + i % 16, 2000 + (i + 1) % 16]))
    k48_keys = np.r_[1000:1032, 2000:2016].astype(np.int32)
    # 8 cells of 8 postings each, slot 0 in all of them: with 8 postings
    # a shard, every shard list holds slot 0
    in_all = same(1, lambda i: np.arange(0, 800, 100)) + same(
        56, lambda i: [100 * (i // 7)])
    return [
        ("random_k16_sp1_owner", mesh_case(
            recs, queries(1, 24, 16), owner=owners(2, 24), r=32)),
        ("random_k32_sp2_sr_lt_mr", mesh_case(
            recs, queries(3, 24, 32), n_sp=2, r=4, merge_r=16)),
        ("random_k16_sp8", mesh_case(recs, queries(4, 24, 16), n_sp=8,
                                     r=16, merge_r=64)),
        ("random_k32_sp8_owner", mesh_case(
            recs, queries(5, 24, 32), n_sp=8, owner=owners(6, 24), r=8,
            merge_r=8)),
        ("p0_all_pad_keys", mesh_case([], one_query([], nq=4), delta=[],
                                      r=8)),
        ("p0_delta_only", mesh_case(
            recs, queries(7, 24, 16), delta=list(range(0, 400, 3)),
            base=False, r=16)),
        *((f"k1_n_unique_{tag}", mesh_case(
            line, one_query(range(5, 21)), r=r, dead=0))
          for tag, r in (("r-1", 17), ("r", 16), ("r+1", 15))),
        *((f"k2_n_unique_{tag}", mesh_case(
            line, one_query(range(5, 21)), n_sp=2, r=16, merge_r=r, dead=0))
          for tag, r in (("r-1", 17), ("r", 16), ("r+1", 15))),
        ("slot_in_cells_and_delta", mesh_case(
            cells, one_query([3, 4, 5, 6]), delta=[0, 2, 5, 11], r=32)),
        ("now_past_t_end", mesh_case(
            recs, queries(8, 24, 16), now=later, r=32)),
        ("owner_off", mesh_case(recs, queries(1, 24, 16), r=32)),
        ("count_mode", mesh_case(
            recs, queries(9, 16, 16, open_bounds=True),
            delta=list(range(0, 400, 5)), owner=owners(10, 16), count=True)),
        ("k1_past_shared_memory", mesh_case(
            hot + recs, queries(11, 8, 16, key_space=40), r=64)),
        ("k2_past_shared_memory", mesh_case(
            wide, wq, n_sp=8, r=8192, merge_r=16, cap=8)),
        ("k1_run_out_of_order", mesh_case(
            recs, queries(12, 24, 16), delta=list(range(0, 400, 7)), r=32,
            reverse_runs=True)),
        *((f"k1_hits_tile{tag}", mesh_case(
            tile_hits(extra), one_query(range(8)), r=600, dead=0))
          for tag, extra in (("-1", -1), ("", 0), ("+1", 1))),
        ("k1_k48_spill_second_chunk", mesh_case(
            k48, one_query(k48_keys, k=48), r=1024, dead=0)),
        ("k2_slot_in_all_8_lists", mesh_case(
            in_all, one_query(np.arange(0, 800, 100), nq=2), n_sp=8, r=16,
            merge_r=64, dead=0)),
    ]


def mesh_case_args(c, dev):
    """A case's K1 and K2 arguments on `dev` -> (K1 args, K1 kwargs,
    K2 kwargs)."""
    from dss_tpu_torch.ops import conflict as oc

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    ents = oc.EntityTable(*(t(a) for a in c["ents"]))
    q = oc.QuerySpec(*(t(c[k]) for k in ("keys", "qalo", "qahi", "qt0",
                                         "qt1")))
    args = (t(c["pk"]), t(c["pe"]), t(c["dk"]), t(c["de"]), ents, q,
            t(c["now"]), t(c["owner"]))
    kw = {"rows": mc.pack_entity_rows(ents),
          "cap": c["cap"], "delta_cap": c["delta_cap"],
          "max_results": c["r"], "count": c["count"]}
    return args, kw, {"shard_results": c["r"], "max_results": c["merge_r"]}


def live_records(recs, orc) -> list:
    """The main path's records as its index holds them after the writes
    (the oracle's changed map applied)."""
    out = [r for r in recs if r.entity_id not in orc.changed]
    return out + [r for r in orc.changed.values() if r is not None]


def mesh_scale(dev, idx, recs, orc, flush, smi, b1_ms) -> dict:
    """Part 1: ShardedDar over the main path's 1M live records on a 1x1
    mesh and on a virtual 2x4 mesh of the card; MESH_BATCHES headline
    batches each, held to each other slot for slot, to B1's
    CudaSpatialIndex answers as id sets and, on a sample, to
    oracle.search; the build, the card's MiB, the batch p50, device
    time by op beside the bound, overflow fallbacks and shard_hits;
    then ops/conflict.py's conflict_query_batch and max_count_per_cell
    on the 1x1 mesh's tensors.  Before it, K1 and K2 against their plain
    versions over mesh_cases(); after the headline batches, every batch
    of both meshes through K1 and K2 and through their plain versions
    on the same card tensors, and K1's and K2's times at the 1x1 and
    2x4 headline beside their bounds.  The functions' and the kernels'
    launch counts are set to 0 just before and read after the headline
    batches."""
    from dss_tpu_torch.ops import conflict as oc
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    t_all = time.perf_counter()
    mesh_kernel_checks(dev)
    live = live_records(recs, orc)
    batches = [make_batch(500 + i, BATCH, N_CELLS, WIDTH)
               for i in range(MESH_BATCHES)]
    out, dars, answers = {}, {}, {}
    b1_before = ff.fused_window_filter.launches
    oc.conflict_query_batch.launches = 0
    oc.max_count_per_cell.launches = 0
    ps.sharded_conflict_query_batch.launches = 0
    reset_mesh()
    for dp, sp in MESH_SHAPES:
        name = f"{dp}x{sp}"
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t = time.perf_counter()
        dar = ps.ShardedDar(live, make_mesh(
            dp * sp, dp=dp, sp=sp, devices=virtual_devices(dev, dp * sp)),
            max_results=MESH_MAX_RESULTS)
        build_s = time.perf_counter() - t
        torch.cuda.synchronize()
        mib = (torch.cuda.memory_allocated() - mem0) / 2**20
        lat, got = [], []
        for q in batches:
            t = time.perf_counter()
            got.append(dar.query_batch(*q, now=NOW))
            lat.append(time.perf_counter() - t)
        answers[name], dars[name] = got, dar
        out[name] = {"build_s": build_s, "mib_on_card": mib,
                     "postings": int(sum(
                         (t != int(oc.INT32_MAX)).sum().item()
                         for _, t in dar.post_key.parts.values())),
                     "cap": dar.cap, "batch_ms": [x * 1e3 for x in lat],
                     "p50_batch_ms": statistics.median(lat) * 1e3,
                     "overflow_fallbacks": dar.overflow_fallbacks,
                     "shard_hits": dar.shard_hits.tolist()}
    launches = {
        "sharded_conflict_query_batch":
            ps.sharded_conflict_query_batch.launches,
        "b1": ff.fused_window_filter.launches - b1_before,
        **mesh_counts(),
    }
    a, b = answers["1x1"], answers["2x4"]
    for k, q in enumerate(batches):
        want = idx.table.query_many(list(q[0]), *q[1:], now=NOW)
        for i in range(BATCH):
            MESH_TALLY.check(a[k][i] == b[k][i],
                             f"mesh 1x1 != 2x4 at batch {k} query {i}")
            ids = sorted(live[s].entity_id for s in a[k][i])
            MESH_TALLY.check(ids == sorted(want[i]),
                             f"mesh != B1 at batch {k} query {i}")
            if k == 0 and i < MESH_ORACLE:
                MESH_TALLY.check(
                    ids == orc.ids(*(col[i] for col in q)),
                    f"mesh != oracle at query {i}")
    keys16 = np.full((BATCH, 16), -1, np.int32)
    keys16[:, :WIDTH] = batches[0][0]
    kern = {}
    for name, dar in dars.items():
        for k, q in enumerate(batches):
            rows = dar_kernel_checks(dar, q, f"mesh {name} batch {k}")
        ms, by_name, src = device_ms(
            lambda: dar.query_batch(*batches[0], now=NOW), flush, n=10)
        DEVICE_BY_NAME[f"mesh_{name}"] = {"cold": by_name}
        rows = dar_kernel_checks(dar, batches[0], f"mesh {name} timed")
        pk_rows = np.concatenate([t.cpu().numpy() for _, t in
                                  dar.post_key.parts.values()])
        pe_rows = np.concatenate([t.cpu().numpy() for _, t in
                                  dar.post_ent.parts.values()])
        b1 = k1_bound(pk_rows, pe_rows, keys16, dar.cap, dar.shard_results)
        widths = [int(mc.mesh_merge(*cols, **mkw)[3][-1])
                  for cols, mkw in rows]
        b2 = [k2_bound(cols[1].cpu().numpy(), dar.shard_results,
                       dar.max_results, w)
              for (cols, _), w in zip(rows, widths)]
        b_ms = b1["ms"] + sum(b["ms"] for b in b2)
        b_ms_earlier = b1["ms_all_keys"] + sum(
            b["ms_padded_lists"] for b in b2)
        old_ms, old_bytes = mesh_bound_padded(
            BATCH, WIDTH, dar.cap, out[name]["postings"], dar.n_sp,
            dar.shard_results)
        out[name].update(
            device_ms=ms, ms_source=src, device_ms_by_op=by_op(by_name),
            device_kernels_per_batch=sum(k for _, k in by_name.values()),
            bound_ms=b_ms,
            bound_bytes=b1["bytes"] + sum(b["bytes"] for b in b2),
            share_of_bound=b_ms / ms, candidates=b1["candidates"],
            widths=widths, bound_ms_padded_formula=old_ms,
            bound_bytes_padded_formula=old_bytes,
            bound_ms_earlier_formula=b_ms_earlier,
            share_of_bound_earlier_formula=b_ms_earlier / ms,
            vs_b1=ms / b1_ms)
        # K1 and K2 alone at this mesh's headline, dp row 0
        _, _, args, kw = dar_row_args(dar, batches[0], 0)[0]
        cols, mkw = rows[0]
        rb1 = k1_bound(args[0].cpu().numpy(), args[1].cpu().numpy(),
                       keys16[: BATCH // dar.dp], dar.cap,
                       dar.shard_results)
        tag = "" if name == "1x1" else f"_{name}"
        t1 = timings(f"mesh_query{tag}",
                     lambda: mc.mesh_query(*args, **kw),
                     lambda: mc.mesh_query_torch(*args, **kw), flush)
        t2 = timings(f"mesh_merge{tag}",
                     lambda: mc.mesh_merge(*cols, **mkw),
                     lambda: mc.mesh_merge_torch(*cols, **mkw), flush)
        kern[name] = {
            "mesh_query": {**t1, "bound_ms": rb1["ms"],
                           "bound_bytes": rb1["bytes"],
                           "candidates": rb1["candidates"],
                           "share_of_bound": rb1["ms"] / t1["ms"],
                           "bound_ms_all_keys": rb1["ms_all_keys"],
                           "share_of_bound_all_keys":
                               rb1["ms_all_keys"] / t1["ms"]},
            "mesh_merge": {**t2, "bound_ms": b2[0]["ms"],
                           "bound_bytes": b2[0]["bytes"],
                           "width": widths[0],
                           "share_of_bound": b2[0]["ms"] / t2["ms"],
                           "bound_ms_padded_lists": b2[0]["ms_padded_lists"],
                           "share_of_bound_padded_lists":
                               b2[0]["ms_padded_lists"] / t2["ms"]},
            "dp_rows": dar.dp, "shards_per_launch": dar.n_sp}
    # ops/conflict.py's two other functions on the 1x1 mesh's tensors
    d11 = dars["1x1"]
    rows, pk = d11.post_key.parts[dev]
    base = oc.Postings(pk[0], d11.post_ent.parts[dev][1][0])
    ents = d11.ents[dev]
    sent = ents.alt_lo.shape[0] - 1
    delta = oc.Postings(
        torch.full((8,), int(oc.INT32_MAX), dtype=torch.int32, device=dev),
        torch.full((8,), sent, dtype=torch.int32, device=dev))
    keys16 = np.full((BATCH, 16), -1, np.int32)
    keys16[:, :WIDTH] = batches[0][0]
    spec = oc.query_spec(keys16, *batches[0][1:], dev)

    def cqb():
        return oc.conflict_query_batch(
            base, delta, ents, spec, NOW, base_cap=d11.cap, delta_cap=8,
            max_results=MESH_MAX_RESULTS)

    slots, ovf = (t.cpu().numpy() for t in cqb())
    for i in range(BATCH):
        row = slots[i]
        MESH_TALLY.check(
            not ovf[i] and [int(s) for s in row[row != oc.INT32_MAX]]
            == a[0][i], f"conflict_query_batch != the 1x1 mesh at {i}")
    launches["conflict_query_batch"] = oc.conflict_query_batch.launches
    keys_row = batches[0][0][0]
    cands = [r for r in orc.cands(keys_row)
             if np.isin(r.keys, keys_row).any()]
    owner = cands[0].owner_id if cands else 0
    want_max = oracle.max_count_per_cell(dict(enumerate(cands)), keys_row,
                                         owner, NOW)
    keys_t = torch.from_numpy(keys_row).to(dev)

    def mcc():
        return oc.max_count_per_cell(base, delta, ents, keys_t, NOW, owner,
                                     base_cap=d11.cap, delta_cap=8)

    MESH_TALLY.check(int(mcc()) == want_max,
                     "max_count_per_cell != oracle")
    launches["max_count_per_cell"] = oc.max_count_per_cell.launches
    fns = {}
    host_rows = (pk.cpu().numpy(), d11.post_ent.parts[dev][1].cpu().numpy())
    host_delta = tuple(t.cpu().numpy()[None] for t in delta)
    for name, fn, keys, count in (
            ("conflict_query_batch", cqb, keys16, False),
            ("max_count_per_cell", mcc, keys_row[None], True)):
        ms, by_name, src = device_ms(fn, flush, n=10)
        DEVICE_BY_NAME[name] = {"cold": by_name}
        b = k1_bound(*host_rows, keys, d11.cap, MESH_MAX_RESULTS,
                     count=count, delta=host_delta, delta_cap=8)
        old_ms, old_bytes = mesh_bound_padded(
            len(keys), WIDTH, d11.cap, out["1x1"]["postings"], 1,
            0 if count else MESH_MAX_RESULTS)
        fns[name] = {"device_ms": ms, "ms_source": src,
                     "device_ms_by_op": by_op(by_name), "bound_ms": b["ms"],
                     "bound_bytes": b["bytes"],
                     "share_of_bound": b["ms"] / ms,
                     "bound_ms_padded_formula": old_ms,
                     "bound_bytes_padded_formula": old_bytes,
                     "bound_ms_all_keys": b["ms_all_keys"]}
    del dars, d11, base, ents, delta, spec
    gc.collect()
    return {"records": len(live), "batch": BATCH, "batches": MESH_BATCHES,
            "oracle_sample": MESH_ORACLE, "meshes": out,
            "functions": fns, "kernels": kern, "launches": launches,
            "b1_ms_same_data": b1_ms, "seconds": time.perf_counter() - t_all,
            "note": "a virtual position is not a second card: the 2x4 "
                    "mesh runs its 8 positions on one H100", "card": smi}


def skew_fixture(seed=7) -> tuple:
    """The reference's skew fixture (bench.py:2464-2494): SKEW_COLD
    records uniform over 50,000 keys plus SKEW_HOT in one narrow hot
    metro; area 0 covers the hot range, the rest are cold windows of
    24 keys.  -> (records, areas)."""
    rng = np.random.default_rng(seed)
    key_space, hot_lo, hot_w = 50_000, 21_000, 64
    recs = []
    for i in range(SKEW_COLD):
        k0 = int(rng.integers(0, key_space - 16))
        keys = np.unique(rng.integers(k0, k0 + 16, 4).astype(np.int32))
        recs.append(Record(f"c{i}", keys, 0.0, 3000.0, -(2**62), 2**62, 0))
    for i in range(SKEW_HOT):
        k0 = hot_lo + int(rng.integers(0, hot_w - 4))
        keys = np.unique(rng.integers(k0, k0 + 4, 3).astype(np.int32))
        recs.append(Record(f"h{i}", keys, 0.0, 3000.0, -(2**62), 2**62, 0))
    areas = [np.arange(hot_lo, hot_lo + hot_w, dtype=np.int32)]
    for _ in range(SKEW_AREAS - 1):
        k0 = int(rng.integers(0, key_space - 24))
        areas.append(np.arange(k0, k0 + 24, dtype=np.int32))
    return recs, areas


def zipf_ranks(rng, n_areas, alpha, n):
    """n area indices, P(rank r) ~ (r+1)^-alpha (bench.py:2497)."""
    p = np.arange(1, n_areas + 1, dtype=np.float64) ** (-alpha)
    return rng.choice(n_areas, size=n, p=p / p.sum())


def skew_pass(rep, areas, picks) -> tuple:
    """Serial single-query mesh dispatches (bench.py:2505-2530) ->
    (latencies ms, overflow fallbacks, measured per-shard work,
    answers)."""
    one = (np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32),
           np.full(1, -(2**62), np.int64), np.full(1, 2**62, np.int64))
    snap = rep._snapshots["isas"]
    dars = [d for d in (snap.base, snap.delta) if d is not None]
    ovf0 = sum(d.overflow_fallbacks for d in dars)
    hits0 = rep.measured_shard_loads().copy()
    lat, got = [], []
    for a in picks:
        t = time.perf_counter()
        got.append(rep.query_batch([areas[a]], *one, now=0, cls="isas")[0])
        lat.append((time.perf_counter() - t) * 1e3)
    ovf = sum(d.overflow_fallbacks for d in dars) - ovf0
    return (np.asarray(lat), int(ovf), rep.measured_shard_loads() - hits0,
            got)


def mesh_skew(dev, smi, flush) -> dict:
    """Part 2: the reference's skew leg (bench.py:2424-2459, 2530-2600)
    at its own size on a virtual 1x8 mesh of the card, max_results 256,
    shard_results 48: per Zipf alpha, SKEW_QUERIES serial queries with
    rebalancing off (the equal-count split) and on (measure, move at
    the fold, re-measure).  The answers with it on must equal those
    with it off, and the exact host answer.  Its one query is 8 K1
    items, which take the spread kernel: timed here
    (`spread_kernel`) at the hot area's query against the plain
    version, beside its bound on the same inputs."""
    import os
    import shutil

    from dss_tpu_torch.dar.tiers import RangeLoad
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from dss_tpu_torch.parallel.replica import ShardedReplica
    from dss_tpu_torch.parallel.sharded import imbalance_factor

    t_all = time.perf_counter()
    ps.sharded_conflict_query_batch.launches = 0
    reset_mesh()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "mesh_skew")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wal = os.path.join(work, "empty.wal")
    open(wal, "w").close()
    recs, areas = skew_fixture()
    rep = ShardedReplica(
        make_mesh(8, dp=1, sp=8, devices=virtual_devices(dev, 8)),
        wal_path=wal, max_results=256, shard_results=48,
        rebalance_ratio=1.5, move_interval_s=0.0)
    with rep._mu:
        rep._records["isas"] = {r.entity_id: r for r in recs}
        rep._dirty["isas"] = True
    rep.refresh(plan=False)
    one = (np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32),
           np.full(1, -(2**62), np.int64), np.full(1, 2**62, np.int64))
    host = [rep.query_batch_host([a], *one, now=0, cls="isas")[0]
            for a in areas]
    per_alpha = {}
    try:
        for alpha in SKEW_ALPHAS:
            rng = np.random.default_rng(int(alpha * 10) + 1)
            picks = zipf_ranks(rng, SKEW_AREAS, alpha, SKEW_QUERIES)
            warm = zipf_ranks(rng, SKEW_AREAS, alpha, 16)
            # off: the static equal-count split
            rep.load = RangeLoad(shift=2, decay_factor=0.5)
            rep.rebalance_ratio = 0.0
            if rep.boundaries is not None:
                rep.boundaries = None
                with rep._mu:
                    rep._force_major["isas"] = True
                    rep._dirty["isas"] = True
                rep.refresh(plan=False)
            skew_pass(rep, areas, warm)
            lat_off, ovf_off, work_off, got_off = skew_pass(rep, areas,
                                                            picks)
            # on: measure the load, move at the fold, re-measure
            rep.load = RangeLoad(shift=2, decay_factor=0.5)
            rep.rebalance_ratio = 1.5
            skew_pass(rep, areas, picks)
            moves0 = rep.boundary_moves
            rep.plan_rebalance()
            imb_before = rep._imbalance
            rep.refresh(plan=False)
            skew_pass(rep, areas, warm)
            lat_on, ovf_on, work_on, got_on = skew_pass(rep, areas, picks)
            rep.plan_rebalance()
            for i, a in enumerate(picks):
                MESH_TALLY.check(got_on[i] == got_off[i],
                                 f"skew {alpha}: on != off at {i}")
                MESH_TALLY.check(got_on[i] == host[a],
                                 f"skew {alpha}: mesh != host at {i}")

            def pct(x, p):
                return float(np.percentile(x, p))

            per_alpha[str(alpha)] = {
                "off": {"p50_ms": pct(lat_off, 50), "p99_ms": pct(lat_off, 99),
                        "overflow_fallbacks": ovf_off,
                        "measured_imbalance": imbalance_factor(work_off)},
                "on": {"p50_ms": pct(lat_on, 50), "p99_ms": pct(lat_on, 99),
                       "overflow_fallbacks": ovf_on,
                       "measured_imbalance": imbalance_factor(work_on),
                       "boundary_moves": rep.boundary_moves - moves0,
                       "imbalance_before_move": imb_before,
                       "imbalance_after_move": rep._imbalance,
                       "shard_results_effective":
                           rep.shard_results_effective},
            }
        kernel_launches = mesh_counts()
        # every area at once through K1 and K2 against their plain
        # versions, on the replica's own tensors
        snap = rep._snapshots["isas"]
        keys = np.full((len(areas), max(map(len, areas))), -1, np.int32)
        for i, a in enumerate(areas):
            keys[i, : len(a)] = a
        q = (keys, *(np.repeat(x, len(areas)) for x in one))
        for dar in (snap.base, snap.delta):
            if dar is not None:
                dar_kernel_checks(dar, q, "skew", now=0)
        hot = (keys[:1], *(x[:1] for x in q[1:]))
        _, _, args, kw = dar_row_args(snap.base, hot, 0, now=0)[0]
        spread_kernel = spread_timing(args, kw, flush)
    finally:
        rep.close()
        shutil.rmtree(work, ignore_errors=True)
    return {"cold": SKEW_COLD, "hot": SKEW_HOT, "areas": SKEW_AREAS,
            "queries_per_pass": SKEW_QUERIES, "mesh": "1x8 virtual",
            "sharded_launches": ps.sharded_conflict_query_batch.launches,
            "kernel_launches": kernel_launches,
            "spread_kernel": spread_kernel,
            "max_results": 256, "shard_results": 48,
            "per_alpha": per_alpha, "seconds": time.perf_counter() - t_all,
            "card": smi}


def spread_timing(args, kw, flush) -> dict:
    """The spread kernel's timings() on K1's `args`, `kw` (a call it
    takes, as the counter confirms), with k1_bound on the same inputs
    and the share of it."""
    ran, _ = k1(args, kw)
    MESH_TALLY.check(ran == SPREAD_KERNEL, f"spread timing: K1 ran {ran}")
    t = timings(SPREAD_KERNEL, lambda: mc.mesh_query(*args, **kw),
                lambda: mc.mesh_query_torch(*args, **kw), flush)
    b = k1_bound(args[0].cpu().numpy(), args[1].cpu().numpy(),
                 args[5].keys.cpu().numpy(), kw["cap"], kw["max_results"])
    return {**t, "items": args[0].shape[0] * args[5].keys.shape[0],
            "bound_ms": b["ms"], "bound_bytes": b["bytes"],
            "candidates": b["candidates"],
            "share_of_bound": b["ms"] / t["ms"]}


def mesh_failures(line) -> list:
    """The mesh parts' own checks: the route ran on the card through K1
    and K2, never B1, and the skew leg's rebalancing moved."""
    out = []
    launches = line["scale"]["launches"]
    if launches["b1"]:
        out.append(f"mesh: B1 launched {launches['b1']} times")
    for name in ("sharded_conflict_query_batch", "conflict_query_batch",
                 "max_count_per_cell") + MESH_KERNELS:
        if launches[name] <= 0:
            out.append(f"mesh: {name} never ran on the card")
    if launches[SPREAD_KERNEL]:
        out.append(f"mesh: the headline batches took the spread kernel "
                   f"{launches[SPREAD_KERNEL]} times")
    if line["skew"]["kernel_launches"][SPREAD_KERNEL] <= 0:
        out.append("mesh skew: K1 never took the spread kernel")
    hot = line["skew"]["per_alpha"][str(SKEW_ALPHAS[-1])]["on"]
    if hot["boundary_moves"] <= 0:
        out.append("mesh skew: no boundary move at the hottest alpha")
    return out


def mesh_kernel_entries() -> list:
    """K1's and K2's entries of the kernels line: times at the 1x1
    headline (the 2x4's beside them), launches on the main path (the
    headline batches) and in every leg; then the spread kernel's (K1 a
    block an item), timed at the skew leg's hot query, whose launches
    are the skew leg's (no headline batch takes it)."""
    scale = MESH_LINE["scale"]
    legs = {"mesh": scale["launches"],
            "skew": MESH_LINE["skew"]["kernel_launches"],
            "store_drains": MESH_LINE.get("store_drains", {}).get(
                "kernel_launches", {}),
            "server": MESH_LINE.get("server", {}).get("kernel_launches", {}),
            "multihost": MESH_LINE.get("multihost_kernel_launches", {})}
    occ = mc.occupancy()
    spread_occ = occ.pop("spread")
    out = []
    for name in MESH_KERNELS:
        t = scale["kernels"]["1x1"][name]
        e = entry(name, legs["mesh"][name], MESH_ERR[name],
                  {k: t[k] for k in ("ms", "warm_ms", "call_ms", "plain_ms",
                                     "plain_call_ms", "ms_source")},
                  t["bound_ms"])
        e["launches_by_leg"] = {leg: v.get(name, 0)
                                for leg, v in legs.items()}
        bounds = [k for k in t if k.startswith(("bound_ms_", "share_of"))]
        e.update((k, t[k]) for k in bounds)
        e["at_2x4"] = {k: scale["kernels"]["2x4"][name][k]
                       for k in ("ms", "warm_ms", "call_ms", "plain_ms",
                                 "bound_ms", *bounds)}
        if name == "mesh_query":
            e.update(occ)
        out.append(e)
    t = MESH_LINE["skew"]["spread_kernel"]
    e = entry(SPREAD_KERNEL, legs["skew"][SPREAD_KERNEL],
              MESH_ERR[SPREAD_KERNEL],
              {k: t[k] for k in ("ms", "warm_ms", "call_ms", "plain_ms",
                                 "plain_call_ms", "ms_source")},
              t["bound_ms"])
    e["launches_by_leg"] = {leg: v.get(SPREAD_KERNEL, 0)
                            for leg, v in legs.items()}
    e.update((k, t[k]) for k in ("items", "bound_bytes", "candidates",
                                 "share_of_bound"))
    e["timed_at"] = "the skew leg's hot query, virtual 1x8"
    e.update(spread_occ)
    out.append(e)
    return out


def mesh_store_drains(store, wal_path, dev, orc, seed) -> tuple:
    """Part 3, in the store: a ShardedReplica on a virtual 1x2 mesh of
    the card tails the store's own WAL and is attached to its
    coalescers (attach_mesh_replica); MESH_BURSTS bulk stale drains of
    BURST_CALLERS SCDService searches (the services phase's recipe)
    then ride the mesh.  Every answer must equal the local path's
    (the same searches one at a time before the replica is attached,
    held against the oracle), and the op class's mesh_offloads must
    rise.  -> (its part of the mesh line, failures)."""
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from dss_tpu_torch.parallel.replica import ShardedReplica
    from dss_tpu_torch.services.scd import SCDService

    t_all = time.perf_counter()
    failures = []
    svc = SCDService(store.scd, store.clock)

    def ids(params):
        return sorted(o["id"] for o in svc.search_operations(
            params, "uss0")["operation_references"])

    bursts = []
    for k in range(MESH_BURSTS):
        items = []
        for params, args in svc_aois(seed + k, BURST_CALLERS, orc.now):
            local = ids(params)
            MESH_TALLY.check(local == orc.ids(*args),
                             "mesh drains: a local search != oracle")
            items.append((params, local))
        bursts.append(items)
    dp, sp = (int(x) for x in MESH_REPLICA.split(","))
    t = time.perf_counter()
    rep = ShardedReplica(
        make_mesh(dp * sp, dp=dp, sp=sp,
                  devices=virtual_devices(dev, MESH_POSITIONS)),
        wal_path=wal_path, warm_batches=(1, 32, 64))
    rep.sync()
    sync_s = time.perf_counter() - t
    rep.start(MESH_REFRESH_S)
    try:
        store.attach_mesh_replica(rep)
        if not rep.fresh():
            failures.append("mesh drains: the replica is not fresh")
        off0 = store.stats()["dss_dar_op_mesh_offloads"]
        ps.sharded_conflict_query_batch.launches = 0
        reset_mesh()
        burst = drain_bursts(store, bursts, lambda it: ids(it[0]),
                             lambda it: it[1], "mesh drains")
        offloads = store.stats()["dss_dar_op_mesh_offloads"] - off0
        launches = ps.sharded_conflict_query_batch.launches
        kernel_launches = mesh_counts()
    finally:
        rep.close()
    for index, _ in store._class_indexes():
        index.coalescer.set_mesh_delegate(None, None)
    if burst["client_errors"]:
        failures.append(f"mesh drains: {burst['client_errors']}")
    if offloads <= 0:
        failures.append("mesh drains: no batch offloaded to the mesh")
    st = rep.stats()
    return {"replica_sync_s": sync_s,
            "replica_records": st["replica_applied_records"],
            "replica_major_rebuilds": st["replica_major_rebuilds"],
            "mesh_offloads": offloads, "sharded_launches": launches,
            "kernel_launches": kernel_launches,
            "burst": burst,
            "seconds": time.perf_counter() - t_all}, failures


def area_of(vol) -> str:
    """The area query string of an SCD volume's outline."""
    return ",".join(f"{v['lat']},{v['lng']}" for v in
                    vol["volume"]["outline_polygon"]["vertices"])


def mesh_server(smi, state) -> tuple:
    """Part 3, as a process: the server binary with `--sharded_replica
    1,2 --virtual_devices 2` on the card, booted from the http phase's
    WAL.  Once the replica has tailed it (staleness under the refresh
    interval, no class dirty), every /aux/v1/replica/<surface> is held
    to its store route; MESH_WRITES ops, two RID subscriptions and an
    SCD subscription are written and read back from the replica
    surfaces; SIGTERM must exit 0.  The line records whether the
    server's fault handler printed (and then the stacks it printed).
    -> (its part of the mesh line, failures)."""
    import os
    import signal
    import urllib.parse
    import urllib.request
    import uuid

    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.services import serialization as ser

    root = os.path.dirname(os.path.abspath(__file__))
    work, wal, now = state["work"], state["wal"], state["now"]
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    err_path = os.path.join(work, "mesh_server.log")
    errf = open(err_path, "wb")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--enable_scd", "--storage", "cuda",
         "--device", HTTP_DEVICE, "--insecure_no_auth", "--wal_path", wal,
         "--shutdown_grace", str(HTTP_GRACE_S), "--no_warmup",
         "--sharded_replica", MESH_REPLICA,
         "--virtual_devices", str(MESH_POSITIONS),
         "--replica_refresh_interval", str(MESH_REFRESH_S)],
        cwd=root, stdout=subprocess.DEVNULL, stderr=errf)
    line, failures = {}, []

    def ok(status_body, what, want=200):
        status, body = status_body
        if status != want:
            raise RuntimeError(f"{what}: HTTP {status} {body}")
        return body

    def replica(surface, key, area, vol=None):
        qs = {"area": area}
        if vol is not None:
            qs.update(
                altitude_lo=vol["volume"]["altitude_lower"]["value"],
                altitude_hi=vol["volume"]["altitude_upper"]["value"],
                earliest_time=vol["time_start"]["value"],
                latest_time=vol["time_end"]["value"])
        body = ok(http_json(base, "GET", f"/aux/v1/replica/{surface}?"
                            + urllib.parse.urlencode(qs)), surface)
        return sorted(body[key]), body["replica"]

    def synced(st):
        return (0 <= st["replica_staleness_s"] < MESH_REFRESH_S
                and not any(v for k, v in st.items()
                            if k.startswith("replica_")
                            and k.endswith("_dirty")))

    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited at boot: rc "
                                   f"{proc.returncode}")
            if time.perf_counter() - t_start > 300:
                raise RuntimeError("server never became healthy")
            try:
                with urllib.request.urlopen(base + "/healthy",
                                            timeout=1) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.1)
        boot_s = time.perf_counter() - t_start
        probe = isa_area(0)
        while True:
            _, st = replica("operations", "operation_ids", probe)
            if st["replica_applied_records"] > 0 and synced(st):
                break
            if time.perf_counter() - t_start > 300:
                raise RuntimeError(f"the replica never synced: {st}")
            time.sleep(0.1)
        first_sync_s = time.perf_counter() - t_start
        # every surface against its store route, after the sync
        aois = state["aois"][:MESH_SURFACE_SAMPLE]
        mism = {}

        def hold(surface, got, want):
            good = got == want
            mism[surface] = mism.get(surface, 0) + (not good)
            MESH_TALLY.check(good, f"mesh server: {surface} != store route")

        for params, _ in aois:
            vol = params["area_of_interest"]
            want = sorted(o["id"] for o in ok(http_json(
                base, "POST", "/dss/v1/operation_references/query",
                params), "op query")["operation_references"])
            hold("operations", replica("operations", "operation_ids",
                                       area_of(vol), vol)[0], want)
            want = sorted(c["id"] for c in ok(http_json(
                base, "POST", "/dss/v1/constraint_references/query",
                params), "constraint query")["constraint_references"])
            hold("constraints", replica("constraints", "constraint_ids",
                                        area_of(vol), vol)[0], want)
        for k in range(MESH_SURFACE_SAMPLE):
            area = isa_area(k)
            want = sorted(a["id"] for a in ok(http_json(
                base, "GET", "/v1/dss/identification_service_areas?area="
                + area), "ISA search")["service_areas"])
            hold("identification_service_areas", replica(
                "identification_service_areas", "service_area_ids",
                area)[0], want)
        # writes: ops (keyed with what they conflict with), RID and SCD
        # subscriptions of this caller; then read back from the replica
        w0, w1 = from_nanos(now + 10 * 60 * 10**9), from_nanos(now + HOUR)
        written = {"operations": [], "subscriptions": [],
                   "scd_subscriptions": []}
        vols = []
        for j in range(MESH_WRITES):
            vol = scd_volume(svc_square(2001 + 64 * j), 0.0, 3000.0,
                             now + HOUR // 3, now + HOUR)
            op_id = str(uuid.uuid4())
            body = {"extents": [vol], "uss_base_url": "https://uss.example",
                    "new_subscription": {
                        "uss_base_url": "https://uss.example"},
                    "state": "Accepted", "old_version": 0, "key": []}
            path = f"/dss/v1/operation_references/{op_id}"
            status, resp = http_json(base, "PUT", path, body)
            if status == 409:
                body["key"] = [c["operation_reference"]["ovn"]
                               for c in resp["entity_conflicts"]
                               if "operation_reference" in c]
                resp = ok(http_json(base, "PUT", path, body), "op PUT")
            elif status != 200:
                raise RuntimeError(f"op PUT: HTTP {status} {resp}")
            written["operations"].append(op_id)
            vols.append(vol)
        for k in (3, 4):
            sub_id = str(uuid.uuid4())
            poly = svc_square(k * POLL_CELLS + POLL_CELLS // 2)
            ok(http_json(base, "PUT", f"/v1/dss/subscriptions/{sub_id}", {
                "extents": {"spatial_volume": {"footprint": {"vertices": [
                    {"lat": a, "lng": b} for a, b in poly]},
                    "altitude_lo": 0.0, "altitude_hi": 3000.0},
                    "time_start": ser.format_time(w0),
                    "time_end": ser.format_time(w1)},
                "callbacks": {"identification_service_area_url":
                              "https://dp.example/n"}}), "RID sub PUT")
            written["subscriptions"].append(sub_id)
        sub_id = str(uuid.uuid4())
        ok(http_json(base, "PUT", f"/dss/v1/subscriptions/{sub_id}", {
            "extents": vols[0], "uss_base_url": "https://uss.example",
            "notify_for_operations": True, "old_version": 0}),
            "SCD sub PUT")
        written["scd_subscriptions"].append(sub_id)
        # every write visible on its replica surface: the replica is
        # bounded-stale, and a tail that has applied the ops may not yet
        # have applied the subscriptions written after them
        t_w = time.perf_counter()
        while True:
            seen = {key: set() for key in written}
            st = None
            for vol in vols:
                got, st = replica("operations", "operation_ids",
                                  area_of(vol), vol)
                seen["operations"].update(got)
            for k in (3, 4):
                seen["subscriptions"].update(replica(
                    "subscriptions", "subscription_ids", isa_area(k))[0])
            seen["scd_subscriptions"].update(replica(
                "scd_subscriptions", "subscription_ids", area_of(vols[0]),
                vols[0])[0])
            if all(set(ids) <= seen[key] for key, ids in written.items()) \
                    and synced(st):
                break
            if time.perf_counter() - t_w > 60:
                raise RuntimeError("the replica never showed the writes")
            time.sleep(0.05)
        visible_s = time.perf_counter() - t_w
        # the owner-scoped surfaces, with this caller's entities in them,
        # and every write read back from the surface that serves it
        back = {key: set() for key in written}
        for k in (3, 4):
            area = isa_area(k)
            want = sorted(s["id"] for s in ok(http_json(
                base, "GET", "/v1/dss/subscriptions?area=" + area),
                "RID sub search")["subscriptions"])
            got = replica("subscriptions", "subscription_ids", area)[0]
            hold("subscriptions", got, want)
            back["subscriptions"].update(got)
        want = sorted(s["id"] for s in ok(http_json(
            base, "POST", "/dss/v1/subscriptions/query",
            {"area_of_interest": vols[0]}), "SCD sub query")["subscriptions"])
        got = replica("scd_subscriptions", "subscription_ids",
                      area_of(vols[0]), vols[0])[0]
        hold("scd_subscriptions", got, want)
        back["scd_subscriptions"].update(got)
        for vol in vols:
            want = sorted(o["id"] for o in ok(http_json(
                base, "POST", "/dss/v1/operation_references/query",
                {"area_of_interest": vol}), "op query")[
                "operation_references"])
            got = replica("operations", "operation_ids", area_of(vol),
                          vol)[0]
            hold("operations", got, want)
            back["operations"].update(got)
        for key, ids in written.items():
            MESH_TALLY.check(set(ids) <= back[key],
                             f"mesh server: written {key} not read back")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        line = {
            "wal": os.path.basename(wal), "boot_s": boot_s,
            "first_sync_s": first_sync_s,
            "surfaces_compared": {
                "operations": len(aois) + MESH_WRITES,
                "constraints": len(aois),
                "identification_service_areas": MESH_SURFACE_SAMPLE,
                "subscriptions": 2, "scd_subscriptions": 1},
            "mismatches": mism, "writes": {k: len(v) for k, v in
                                           written.items()},
            "write_to_visible_s": visible_s,
            "replica": {k: v for k, v in st.items()
                        if not k.startswith("replica_")
                        or not k.endswith(("_dirty", "_generation"))},
            "http_mesh_offloads": int(sum(metric_values(
                metrics, "_mesh_offloads").values())),
            "kernel_launches": mesh_counts_of(metrics),
        }
    finally:
        t = time.perf_counter()
        rc = None
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
                failures.append("mesh server: outlived its grace")
        else:
            rc = proc.returncode
            failures.append(f"mesh server: died (rc {rc})")
        errf.close()
        with open(err_path, "rb") as f:
            err_text = f.read().decode(errors="replace")
        # the server arms faulthandler: an abort prints every thread's
        # stack, from "Fatal Python error" on
        at = err_text.find("Fatal Python error")
        line.update(sigterm_exit_s=time.perf_counter() - t, exit_code=rc,
                    fault_handler_output=at >= 0)
        if at >= 0:
            line["fault_handler_stacks"] = err_text[at:at + 6000]
        if rc != 0:
            failures.append(f"mesh server: exit code {rc}: "
                            f"{err_text[at if at >= 0 else -2000:][:6000]}")
    return line, failures


# -- the DSS Region (region/, cmds/region_server, the store's region mode) --

REGION_TAIL = 800  # entries of the seeded log after its snapshot
REGION_WRITES = 200  # writes on A, each polled on B (write-to-visible)
REGION_QUERIES = 256  # op queries per instance against the oracle
REGION_CONCURRENT = 4  # writer threads per instance, 4 writes each
REGION_KILL_WRITERS = 2  # writer threads per instance across the SIGKILL
REGION_WRITE_PAUSE_S = 0.1  # between one writer's writes across the kill
REGION_POLL_S = 0.05  # --region_poll_interval (the server's default)
REGION_DEADLINE_S = 60.0  # any one wait of the phase
REGION_DEVICE = "cuda"  # the instances' --device and the store's device
REGION_TALLY = Tally("region")  # every answer and acknowledged write


def region_records(wal) -> list:
    """The http phase's WAL records (the format record left out)."""
    from dss_tpu_torch.dar.wal import FORMAT_RECORD_TYPE, WriteAheadLog

    log_ = WriteAheadLog(wal)
    try:
        return [r for r in log_.replay() if r.get("t") != FORMAT_RECORD_TYPE]
    finally:
        log_.close()


def region_state(records) -> dict:
    """The store's snapshot form (DSSStore's rid/scd serialize_state) of
    a sequence of put records with distinct ids."""
    state = {"rid": {"isas": [], "subs": []},
             "scd": {"ops": [], "subs": [], "constraints": []}}
    where = {"isa_put": ("rid", "isas"), "rid_sub_put": ("rid", "subs"),
             "scd_op_put": ("scd", "ops"), "scd_sub_put": ("scd", "subs"),
             "scd_cst_put": ("scd", "constraints")}
    for rec in records:
        a, b = where[rec["t"]]
        state[a][b].append(rec["doc"])
    return state


def isa_body(poly, w0, w1) -> dict:
    from dss_tpu_torch.services import serialization as ser

    return {"extents": {
        "spatial_volume": {"footprint": {"vertices": [
            {"lat": a, "lng": b} for a, b in poly]},
            "altitude_lo": 0.0, "altitude_hi": 120.0},
        "time_start": ser.format_time(w0), "time_end": ser.format_time(w1)},
        "flights_url": "https://uss.example/f"}


class RegionProc:
    """One process of the region phase: its command, log file and base
    URL."""

    def __init__(self, name, argv, port, work, root):
        import os

        self.name, self.port = name, port
        self.base = f"http://127.0.0.1:{port}"
        self.log_path = os.path.join(work, f"{name}.log")
        self._f = open(self.log_path, "wb")
        self.t0 = time.perf_counter()
        self.p = subprocess.Popen([sys.executable, "-m", *argv], cwd=root,
                                  stdout=subprocess.DEVNULL, stderr=self._f)
        self.healthy_s = None
        self.rc = None

    def wait_healthy(self, limit=REGION_DEADLINE_S * 2) -> float:
        import urllib.request

        while True:
            if self.p.poll() is not None:
                raise RuntimeError(f"{self.name} exited at boot: rc "
                                   f"{self.p.returncode}: {self.tail()}")
            if time.perf_counter() - self.t0 > limit:
                raise RuntimeError(f"{self.name} never became healthy")
            try:
                with urllib.request.urlopen(self.base + "/healthy",
                                            timeout=1) as r:
                    if r.status == 200:
                        self.healthy_s = time.perf_counter() - self.t0
                        return self.healthy_s
            except OSError:
                pass
            time.sleep(0.05)

    def tail(self, n=2000) -> str:
        if not self._f.closed:
            self._f.flush()
        with open(self.log_path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")

    def stop(self, sig=None, grace=HTTP_GRACE_S):
        """SIGTERM (or `sig`) -> its exit code (None: killed past the
        grace)."""
        import signal

        if self.p.poll() is None:
            self.p.send_signal(sig or signal.SIGTERM)
            try:
                self.rc = self.p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(30)
                self.rc = None
        else:
            self.rc = self.p.returncode
        self._f.close()
        return self.rc


def card_used_mib():
    """nvidia-smi's memory.used of card 0 in MiB (None if unreadable):
    the processes' sum, since this machine's nvidia-smi lists no
    per-process pids of this pid namespace."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip()
    try:
        return float(out)
    except ValueError:
        return None


def warm_end(proc, limit=REGION_DEADLINE_S * 4) -> dict:
    """Wait for a server process's boot warm to end (its log line) ->
    the line's message."""
    t = time.perf_counter()
    while True:
        with open(proc.log_path, "rb") as f:
            warm = [json.loads(x) for x in f.read().splitlines()
                    if b"resident graph warm" in x
                    or b"resident warm failed" in x]
        if warm:
            return warm[0]["msg"]
        if time.perf_counter() - t > limit:
            raise RuntimeError(f"{proc.name}: the boot warm never ended")
        time.sleep(0.1)


def region_phase(smi, state) -> tuple:
    """The DSS Region on the card.  The http phase's WAL (its 24,800
    records) becomes a region log, seeded offline through the port's
    RegionLog: one entry per record, a snapshot put REGION_TAIL entries
    before the head.  Then, as tests/e2e/test_failover.py:69 runs it:
    the port's region_server as a primary with two --mirror_of mirrors
    at --quorum 2 (mirrors too carry --quorum 2), the shared secret
    from a token file; two server processes (A, B: `--storage cuda
    --enable_scd --region_url <primary>,<mirror1>,<mirror2>`, as
    deploy/k8s/dss.yaml's two replicas) and one in-process
    DSSStore(storage="cuda", region_url=...) booting at once (snapshot
    + tail, each one's time to /healthy); cross-instance checks over
    HTTP (a write on A read on B, a conflicting op refused across
    instances, concurrent writers converging to equal ids, versions and
    OVNs); write-to-visible staleness of REGION_WRITES writes on A
    polled on B; REGION_QUERIES op queries on each instance against the
    oracle, and the in-process store's bulk stale drain (B1 from zero);
    a fenced append and a forced resync while a graph warm captures;
    the snapshot's serialisation and upload, timed; a SIGKILL of the
    primary with writers running, the most caught-up mirror promoted
    with `region_server --promote`, the other repointed, every
    acknowledged write read back on A and B; a late joiner booting from
    snapshot + tail; the card's compute apps; SIGTERM of every process.
    -> (the `region` line, failures, B1's counts in the phase)."""
    import os
    import shutil
    import signal
    import uuid
    from datetime import timedelta

    from dss_tpu_torch import errors
    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.models import rid as ridm
    from dss_tpu_torch.ops import resident
    from dss_tpu_torch.region.client import RegionError
    from dss_tpu_torch.region.log_server import RegionLog, epoch_gen

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(state["work"], "region")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    line = {"card": smi}
    failures = []

    def fail(msg):
        failures.append(f"region: {msg}")

    # -- 0. the region log, seeded offline -------------------------------
    t = time.perf_counter()
    recs = region_records(state["wal"])
    snap_at = len(recs) - REGION_TAIL
    region_wal = os.path.join(work, "primary.wal")
    seed_region_log(RegionLog, region_wal, [[r] for r in recs], snap_at,
                    region_state(recs[:snap_at]))
    line["seed"] = {"records": len(recs), "entries": len(recs),
                    "snapshot_index": snap_at, "seconds":
                    time.perf_counter() - t, "mib":
                    os.path.getsize(region_wal) / 2**20}
    token = uuid.uuid4().hex
    token_file = os.path.join(work, "region.token")
    with open(token_file, "w") as f:
        f.write(token)
    auth = {"Authorization": f"Bearer {token}"}

    def region_json(base, method, path, body=None, timeout=30.0):
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            base + path, data=data, method=method,
            headers={"Content-Type": "application/json", **auth})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    procs = {}
    store = None
    writers_stop = threading.Event()
    on_card = torch.cuda.is_available()
    used0 = card_used_mib()
    reserved0 = torch.cuda.memory_reserved() if on_card else 0
    try:
        # -- 1. the primary and its two mirrors ----------------------------
        ports = [free_port() for _ in range(3)]
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        for k, (name, port) in enumerate(zip(("primary", "mirror1",
                                              "mirror2"), ports)):
            argv = ["dss_tpu_torch.cmds.region_server",
                    "--addr", f"127.0.0.1:{port}",
                    "--wal_path", os.path.join(work, f"{name}.wal"),
                    "--token_file", token_file, "--quorum", "2",
                    "--advertise_url", urls[k]]
            if k:
                argv += ["--mirror_of", urls[0]]
            procs[name] = RegionProc(name, argv, port, work, root)
        for name in ("primary", "mirror1", "mirror2"):
            procs[name].wait_healthy()
        line["log_servers_healthy_s"] = {
            n: procs[n].healthy_s for n in ("primary", "mirror1", "mirror2")}

        def heads():
            return {n: region_json(procs[n].base, "GET", "/status")[1]
                    for n in ("primary", "mirror1", "mirror2")
                    if procs[n].p.poll() is None}

        # -- 2-3. two server processes and the in-process store ------------
        region_url = ",".join(urls)
        for name in ("A", "B"):
            port = free_port()
            procs[name] = RegionProc(name, [
                "dss_tpu_torch.cmds.server", "--addr", f"127.0.0.1:{port}",
                "--enable_scd", "--storage", "cuda", "--device",
                REGION_DEVICE, "--insecure_no_auth", "--region_url",
                region_url, "--region_token_file", token_file,
                "--region_poll_interval", str(REGION_POLL_S),
                "--instance_id", f"dss-{name.lower()}",
                "--shutdown_grace", str(HTTP_GRACE_S)], port, work, root)
        dev = torch.device(REGION_DEVICE)
        t = time.perf_counter()
        store = DSSStore(storage="cuda", device=dev, region_url=region_url,
                         region_token=token,
                         region_poll_interval_s=REGION_POLL_S,
                         instance_id="dss-smoke")
        store_boot_s = time.perf_counter() - t
        coord = store.region
        for name in ("A", "B"):
            procs[name].wait_healthy()
        A, B = procs["A"].base, procs["B"].base
        n_state = len(recs)
        line["boot"] = {
            "records": n_state, "snapshot_records": snap_at,
            "tail_entries": REGION_TAIL,
            "A_healthy_s": procs["A"].healthy_s,
            "B_healthy_s": procs["B"].healthy_s,
            "store_s": store_boot_s,
            "store_records_per_s": n_state / store_boot_s,
            "store_applied": coord.applied,
            "classes": store_counts(store),
        }
        if coord.applied != len(recs):
            fail(f"store booted at entry {coord.applied}, log head "
                 f"{len(recs)}")
        for name, st in heads().items():
            line.setdefault("log_status_at_boot", {})[name] = {
                k: st[k] for k in ("role", "head", "base", "epoch")}

        def ok(status_body, what, want=200):
            status, body = status_body
            if status != want:
                raise RuntimeError(f"{what}: HTTP {status} {body}")
            return body

        def until(fn, what, limit=REGION_DEADLINE_S):
            t = time.perf_counter()
            while True:
                v = fn()
                if v is not None:
                    return v, time.perf_counter() - t
                if time.perf_counter() - t > limit:
                    raise RuntimeError(f"{what}: not within {limit} s")
                time.sleep(0.005)

        now = time.time_ns()
        w0 = from_nanos(now + 10 * 60 * 10**9)
        w1 = from_nanos(now + HOUR)
        isa_path = "/v1/dss/identification_service_areas/"

        def put_isa(base, k):
            isa_id = str(uuid.uuid4())
            st, body = http_json(base, "PUT", isa_path + isa_id, isa_body(
                svc_square(2 * (k % (N_CELLS // 2)) + 1), w0, w1), 60.0)
            return isa_id, st, body

        def read_isa(base, isa_id):
            st, body = http_json(base, "GET", isa_path + isa_id)
            return body["service_area"] if st == 200 else None

        # -- 4. cross-instance checks over HTTP ----------------------------
        cross = {}
        isa_id, st, body = put_isa(A, 11)
        ok((st, body), "ISA PUT on A")
        got, cross["a_to_b_visible_s"] = until(
            lambda: read_isa(B, isa_id), "A's ISA on B")
        REGION_TALLY.check(got == body["service_area"],
                           "A's ISA read on B != A's answer")
        # an op on B, then A's overlapping op without B's OVN (off the
        # metro region's keys, where the WAL's intents would conflict)
        aoi = scd_volume(svc_square(N_CELLS + 50_001), 0.0, 3000.0,
                         now + HOUR // 3, now + HOUR)
        op_b, op_a = str(uuid.uuid4()), str(uuid.uuid4())
        op_body = {"extents": [aoi], "uss_base_url": "https://uss.example",
                   "new_subscription": {"uss_base_url":
                                        "https://uss.example"},
                   "state": "Accepted", "old_version": 0, "key": []}
        put_b = ok(http_json(B, "PUT", f"/dss/v1/operation_references/"
                             f"{op_b}", op_body), "op PUT on B")
        ovn_b = put_b["operation_reference"]["ovn"]
        until(lambda: http_json(A, "GET", f"/dss/v1/operation_references/"
                                f"{op_b}")[0] == 200 or None, "B's op on A")
        st, conflict = http_json(A, "PUT", f"/dss/v1/operation_references/"
                                 f"{op_a}", op_body)
        cross["conflict_status"] = st
        cross["conflict_names_b"] = any(
            c.get("operation_reference", {}).get("id") == op_b
            for c in (conflict or {}).get("entity_conflicts", []))
        REGION_TALLY.check(st == 409 and cross["conflict_names_b"],
                           f"A's op without B's OVN: HTTP {st}")
        ok(http_json(A, "PUT", f"/dss/v1/operation_references/{op_a}",
                     dict(op_body, key=[ovn_b])), "op PUT on A with key")
        # concurrent writers on both instances converge
        made, errs = [], []

        def writer(base, k0):
            for j in range(4):
                i, st, body = put_isa(base, k0 + j)
                if st == 200:
                    made.append(i)
                else:
                    errs.append((base, st, body))

        ths = [threading.Thread(target=writer, args=(b, 100 * (i + 1)))
               for i, b in enumerate([A, B] * REGION_CONCURRENT)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
        if errs:
            fail(f"concurrent writers: {errs[:3]}")
        for i in made + [isa_id]:
            a, _ = until(lambda i=i: read_isa(A, i), "converged on A")
            b, _ = until(lambda i=i: read_isa(B, i), "converged on B")
            REGION_TALLY.check(a == b, f"ISA {i}: A != B")
        for op_id in (op_a, op_b):
            a = ok(http_json(A, "GET", f"/dss/v1/operation_references/"
                             f"{op_id}"), "op GET on A")
            b, _ = until(lambda op_id=op_id: (lambda r: r[1] if r[0] == 200
                                              else None)(http_json(
                B, "GET", f"/dss/v1/operation_references/{op_id}")),
                "op on B")
            REGION_TALLY.check(a == b, f"op {op_id}: A != B (OVN, version)")
        for op_id in (op_a, op_b):  # the oracle below holds the WAL's ops
            ok(http_json(A, "DELETE", f"/dss/v1/operation_references/"
                         f"{op_id}"), "op DELETE")
        cross["concurrent_writes"] = len(made)
        line["cross"] = cross

        # -- 5. write-to-visible staleness, A -> B -------------------------
        vis = []
        t = time.perf_counter()
        for k in range(REGION_WRITES):
            i, st, body = put_isa(A, 1000 + k)
            ok((st, body), "staleness ISA PUT on A")
            t_ack = time.perf_counter()
            until(lambda i=i: read_isa(B, i), "staleness read on B")
            vis.append(time.perf_counter() - t_ack)
        line["staleness"] = {"writes": REGION_WRITES, "poll_s":
                             REGION_POLL_S, "seconds":
                             time.perf_counter() - t, **lat_ms(vis)}

        # -- 6. op queries against the oracle, and the store's drain -------
        orc = StoreOracle(state["cols"], time.time_ns())
        aois = svc_aois(73, REGION_QUERIES, state["now"] + HOUR // 2)
        mism = {}
        for name, base in (("A", A), ("B", B)):
            mism[name] = 0
            for params, args in aois:
                got = ok(http_json(base, "POST",
                                   "/dss/v1/operation_references/query",
                                   params), f"op query on {name}")
                good = sorted(o["id"] for o in got[
                    "operation_references"]) == orc.ids(*args)
                mism[name] += not good
                REGION_TALLY.check(good, f"op query on {name} != oracle")
        shift = state["now"] + HOUR // 2 - NOW
        ff.fused_window_filter.launches = 0
        ff.fused_window_filter.graph_replays = 0
        store.configure_serving(min_batch=BURST_MIN_BATCH)
        bursts = []
        for k in range(STORE_BURSTS):
            q = list(make_batch(95_000 + k, BURST_CALLERS, N_CELLS, WIDTH))
            q[3], q[4] = q[3] + shift, q[4] + shift
            bursts.append([(tuple(q), i) for i in range(BURST_CALLERS)])
        drains = drain_bursts(
            store, bursts,
            lambda it: [x[0] for x in op_query(store, *it, allow_stale=True)],
            lambda it: orc.ids(*(col[it[1]] for col in it[0])), "region")
        launches = ff.fused_window_filter.launches
        replays = ff.fused_window_filter.graph_replays
        line["queries"] = {"per_instance": REGION_QUERIES,
                           "mismatches": mism, "store_drains": drains,
                           "b1_launches": launches,
                           "b1_graph_replays": replays}
        if drains["client_errors"]:
            fail(f"store drains: {drains['client_errors']}")
        if launches <= 0:
            fail("B1 never launched on the region store")

        # -- 7. a fenced append and a forced resync while a warm captures ---
        cache = resident.graph_cache()
        fails0, size0 = cache.capture_failures, cache.size()
        store.configure_serving(resident=True, slo_ms=SLO_MS)
        built = []
        warm_th = threading.Thread(
            target=lambda: built.append(store.warm_resident()))
        st0 = store.stats()
        warm_th.start()
        until(lambda: (cache.size() > size0 or not warm_th.is_alive())
              or None, "the warm's first capture")
        real_append = coord._client.append
        fenced = {"n": 0}

        def flaky_append(token, records, **kw):
            fenced["n"] += 1
            if fenced["n"] == 1:
                raise RegionError("smoke: lease fenced")
            return real_append(token, records, **kw)

        coord._optimistic = False
        coord._client.append = flaky_append
        fenced_id = str(uuid.uuid4())
        probe = ridm.IdentificationServiceArea(
            id=fenced_id, owner="smoke", url="https://uss.example/f",
            cells=s2cell.dar_key_to_cell(np.arange(3, 9, 2, dtype=np.int64)),
            start_time=w0, end_time=w1, altitude_lo=0.0, altitude_hi=100.0)
        try:
            store.rid.insert_isa(probe)
            fail("the fenced append was acknowledged")
        except errors.StatusError as e:
            fenced["status"] = e.http_status
        finally:
            coord._client.append = real_append
            coord._optimistic = True
        if store.rid.get_isa(fenced_id) is not None:
            fail("the fenced append's ISA stayed in local state")
        t = time.perf_counter()
        with store._lock:
            coord._resync_locked()
        resync_s = time.perf_counter() - t
        warm_alive_at_resync_end = warm_th.is_alive()
        warm_th.join(600)
        t = time.perf_counter()
        rewarm = store.warm_resident()
        st1 = store.stats()
        line["resync"] = {
            "seconds": resync_s, "records": n_state,
            "records_per_s": n_state / resync_s,
            "fenced_append_status": fenced.get("status"),
            "rollbacks": st1["region_rollbacks"] - st0["region_rollbacks"],
            "resyncs": st1["region_resyncs"] - st0["region_resyncs"],
            "warm_entries": built[0] if built else None,
            "warm_running_through_resync": warm_alive_at_resync_end,
            "rewarm_entries": rewarm, "rewarm_s": time.perf_counter() - t,
            "capture_failures": cache.capture_failures - fails0,
        }
        if line["resync"]["capture_failures"]:
            fail(f"{line['resync']['capture_failures']} capture failures "
                 "across the forced resync")
        if line["resync"]["rollbacks"] < 1 or line["resync"]["resyncs"] < 1:
            fail(f"no rollback or resync: {line['resync']}")

        # -- the snapshot, serialised and uploaded as the poller does ------
        with store._lock:
            idx = coord.applied
            refs = (store.rid.snapshot_refs(), store.scd.snapshot_refs())
        t = time.perf_counter()
        snap = {"rid": type(store.rid).serialize_refs(refs[0]),
                "scd": type(store.scd).serialize_refs(refs[1])}
        state_json = json.dumps(snap, separators=(",", ":"))
        ser_s = time.perf_counter() - t
        t = time.perf_counter()
        accepted = store._region_client.put_snapshot(idx,
                                                     state_json=state_json)
        line["snapshot_upload"] = {
            "index": idx, "mib": len(state_json) / 2**20,
            "serialize_s": ser_s, "upload_s": time.perf_counter() - t,
            "accepted": accepted}

        # -- the card's memory once A's and B's boot warms ended ----------
        warms = {n: warm_end(procs[n]) for n in ("A", "B")}
        used1 = card_used_mib()
        smoke_mib = ((torch.cuda.memory_reserved() - reserved0) / 2**20
                     if on_card else 0.0)
        line["card_memory"] = {
            "used_mib_at_start": used0, "used_mib_with_a_b": used1,
            "smoke_store_reserved_mib": smoke_mib,
            "a_and_b_mib": (None if None in (used0, used1)
                            else used1 - used0 - smoke_mib),
            "warm_logs": warms}
        if any("failed" in m for m in warms.values()):
            fail(f"boot warm: {warms}")

        # -- 8. SIGKILL of the primary mid-writes, then --promote ----------
        acked, refused = [], []

        def kill_writer(name, base, k0):
            k = k0
            while not writers_stop.is_set():
                i, st, body = put_isa(base, k)
                k += 1
                if st == 200:
                    acked.append((name, i, time.perf_counter()))
                else:
                    refused.append((name, st, time.perf_counter()))
                time.sleep(REGION_WRITE_PAUSE_S)

        wths = [threading.Thread(target=kill_writer,
                                 args=(n, b, 5000 + 1000 * j))
                for j, (n, b) in enumerate(
                    [("A", A), ("B", B)] * REGION_KILL_WRITERS)]
        for th in wths:
            th.start()
        until(lambda: len(acked) >= 20 or None, "writes before the kill")
        gen0 = epoch_gen(heads()["primary"]["epoch"])
        t_kill = time.perf_counter()
        procs["primary"].stop(signal.SIGKILL)
        n_before = len(acked)
        # the most caught-up mirror, once the mirrors' heads settle
        time.sleep(0.5)
        hs = {n: s["head"] for n, s in heads().items()}
        best = max(("mirror1", "mirror2"), key=lambda n: hs[n])
        other = "mirror2" if best == "mirror1" else "mirror1"
        promote = subprocess.run(
            [sys.executable, "-m", "dss_tpu_torch.cmds.region_server",
             "--promote", "--addr", f"127.0.0.1:{procs[best].port}",
             "--token_file", token_file],
            cwd=root, capture_output=True, text=True, timeout=60)
        promoted = json.loads(promote.stdout.strip().splitlines()[-1])
        t_promoted = time.perf_counter()
        ok(region_json(procs[other].base, "POST", "/repoint",
                       {"primary": urls[ports.index(procs[best].port)]}),
           "repoint")

        def first_after(name):
            after = [t for n, _, t in acked if n == name and t > t_promoted]
            return min(after) if after else None

        until(lambda: (first_after("A") and first_after("B")) or None,
              "a write on each instance after the promotion", limit=120)
        writers_stop.set()
        for th in wths:
            th.join(120)
        gen1 = epoch_gen(heads()[best]["epoch"])

        def missing(base, ids, wait_s):
            """The ids of `ids` that `base` does not serve within wait_s."""
            from concurrent.futures import ThreadPoolExecutor

            def one(i):
                try:
                    until(lambda: read_isa(base, i), "acked ISA", wait_s)
                    return None
                except RuntimeError:
                    return i

            with ThreadPoolExecutor(8) as ex:
                return [i for i in ex.map(one, ids) if i is not None]

        lost = {}
        for name, base in (("A", A), ("B", B)):
            gone = missing(base, [i for _, i, _ in acked], 30.0)
            lost[name] = len(gone)
            for _, i, _ in acked:
                REGION_TALLY.check(i not in gone,
                                   f"acked write {i} lost on {name}")
        metrics = {}
        for name, base in (("A", A), ("B", B)):
            import urllib.request

            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                text = r.read().decode()
            metrics[name] = {k: int(sum(metric_values(text, k).values()))
                             for k in ("region_failovers", "region_resyncs",
                                       "region_optimistic_commits",
                                       "region_optimistic_conflicts",
                                       "region_txn_lease_count",
                                       "region_rollbacks",
                                       "region_client_retries")}
            metrics[name]["capture_failures"] = int(max(metric_values(
                text, "_co_res_graph_capture_failures").values(),
                default=0))
        line["failover"] = {
            "acked_before_kill": n_before, "acked": len(acked),
            "refused": len(refused), "mirror_heads": hs,
            "promoted": best, "promote_rc": promote.returncode,
            "promote_out": promoted, "epoch_gen": [gen0, gen1],
            "promote_s": t_promoted - t_kill,
            "A_failover_s": first_after("A") - t_kill,
            "B_failover_s": first_after("B") - t_kill,
            "lost_acked_writes": lost, "instances": metrics,
        }
        if sum(lost.values()):
            fail(f"acknowledged writes lost: {lost}")
        if gen1 <= gen0:
            fail(f"epoch generation did not rise: {gen0} -> {gen1}")
        for name in ("A", "B"):
            if metrics[name]["region_failovers"] <= 0:
                fail(f"{name}'s client never failed over")
            if metrics[name]["capture_failures"]:
                fail(f"{name}: {metrics[name]['capture_failures']} capture "
                     "failures")

        # -- 9. a late joiner: snapshot + tail -----------------------------
        port = free_port()
        used_before_c = card_used_mib()
        procs["C"] = RegionProc("C", [
            "dss_tpu_torch.cmds.server", "--addr", f"127.0.0.1:{port}",
            "--enable_scd", "--storage", "cuda", "--device", REGION_DEVICE,
            "--insecure_no_auth", "--region_url", region_url,
            "--region_token_file", token_file, "--instance_id", "dss-c",
            "--shutdown_grace", str(HTTP_GRACE_S)], port, work, root)
        procs["C"].wait_healthy()
        warms["C"] = warm_end(procs["C"])
        used_c = card_used_mib()
        line["card_memory"]["c_mib"] = (
            None if None in (used_before_c, used_c)
            else used_c - used_before_c)
        C = procs["C"].base
        late_mism = 0
        for params, args in aois[:64]:
            got = ok(http_json(C, "POST", "/dss/v1/operation_references/"
                               "query", params), "op query on C")
            good = sorted(o["id"] for o in got["operation_references"]) \
                == orc.ids(*args)
            late_mism += not good
            REGION_TALLY.check(good, "op query on C != oracle")
        late_lost = len(missing(C, [i for _, i, _ in acked], 10.0))
        REGION_TALLY.check(late_lost == 0, "acked writes missing on C")
        line["late_joiner"] = {
            "healthy_s": procs["C"].healthy_s,
            "records_per_s": n_state / procs["C"].healthy_s,
            "queries": 64, "mismatches": late_mism,
            "acked_missing": late_lost,
            "log_status": {n: {k: s[k] for k in ("role", "head", "base",
                                                 "snapshot_index")}
                           for n, s in heads().items()}}

        # -- the card's compute apps: A, B, C and this smoke ---------------
        apps = [x.strip() for x in subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()
            if x.strip()]
        fds = {n: nvidia_fds(p.p.pid) for n, p in procs.items()
               if p.p.poll() is None}
        pids = {n: p.p.pid for n, p in procs.items()}
        mib = {}
        for a in apps:
            pid, used = (x.strip() for x in a.split(",", 1))
            who = next((n for n, p in pids.items() if p == int(pid)),
                       "smoke" if int(pid) == os.getpid() else pid)
            mib[who] = used
        smoke_ctx = torch.cuda.is_initialized()
        line["compute_apps"] = {
            "nvidia_smi": apps, "listed_by_process": mib, "nvidia_fds": fds,
            "expected_apps": 3 + smoke_ctx, "smoke_pid": os.getpid(),
            "pids": pids}
        if (len(apps) != 3 + smoke_ctx
                or any(fds[n] <= 0 for n in ("A", "B", "C"))
                or any(fds.get(n, 0) > 0 for n in ("mirror1", "mirror2"))):
            fail(f"not A, B, C and the smoke on the card: "
                 f"{line['compute_apps']}")
    finally:
        writers_stop.set()
        # -- 10. SIGTERM of every process -----------------------------------
        t = time.perf_counter()
        codes = {}
        for name in ("C", "A", "B", "mirror1", "mirror2", "primary"):
            p = procs.get(name)
            if p is not None:
                codes[name] = p.stop()
        line["exit_codes"] = codes
        line["sigterm_s"] = time.perf_counter() - t
        for name, rc in codes.items():
            want = -signal.SIGKILL if name == "primary" else 0
            if rc != want:
                fail(f"{name} exit code {rc}: {procs[name].tail()}")
        if store is not None:
            store.close()
    line["mismatches"] = REGION_TALLY.mismatches
    line["compared"] = REGION_TALLY.compared
    return {"region": line}, failures, {
        "region_launches": line.get("queries", {}).get("b1_launches", 0),
        "region_graph_replays": line.get("queries", {}).get(
            "b1_graph_replays", 0)}


FED_QUERIES = 256  # cross-region op queries against the merged oracle
FED_LOCAL = 64  # op queries inside region a's airspace (the local path)
FED_RUN = 4  # keys per run; a cross-region covering is one run each side
FED_SPAN = 3000  # keys either side of the boundary a run starts within
FED_CHECKS = 32  # ISA, and as many constraint, queries across both regions
FED_DRAINS = 8  # bounded-stale drains of BURST_CALLERS through each store
FED_STALE = 64  # cross-region op queries served from the mirror
FED_RESET_S = 0.5  # the peers' breaker reset (DSS_FED_BREAKER_RESET_S)
FED_DEVICE = "cuda"  # the regions' stores' device, and the dryrun's
FED_TALLY = Tally("federation")  # every answer against the merged oracle
_FED_CLASS = {"isa": "isa", "rid_sub": "rid_sub", "scd_op": "op",
              "scd_sub": "scd_sub", "scd_cst": "constraint"}
_FED_PUT = {"isa": "isa_put", "rid_sub": "rid_sub_put", "op": "scd_op_put",
            "scd_sub": "scd_sub_put", "constraint": "scd_cst_put"}


def fed_split(records) -> tuple:
    """The http phase's WAL records -> the live state (puts minus
    deletes, per class and id), split at the median DAR key of the
    records' first keys: region a owns keys below the boundary, b the
    rest.  A record whose cells straddle the boundary is left out of
    both (a federation's ownership guard never lets one be written).
    -> (boundary, {"a": [put records], "b": [...]}, left out)."""
    live = {}
    for rec in records:
        t = rec.get("t", "")
        head, _, kind = t.rpartition("_")
        cls = _FED_CLASS.get(head)
        if cls is None or kind not in ("put", "del"):
            continue
        if kind == "put":
            live[(cls, rec["doc"]["id"])] = rec["doc"]
        else:
            live.pop((cls, rec["id"]), None)
    span = {}
    for key, doc in live.items():
        k = s2cell.cell_to_dar_key(np.asarray(doc["cells"], np.uint64))
        span[key] = (int(k.min()), int(k.max()))
    boundary = int(np.median([lo for lo, _ in span.values()]))
    out, dropped = {"a": [], "b": []}, 0
    for key, doc in live.items():
        lo, hi = span[key]
        if lo < boundary <= hi:
            dropped += 1
            continue
        out["a" if hi < boundary else "b"].append(
            {"t": _FED_PUT[key[0]], "doc": doc})
    return boundary, out, dropped


class DocOracle:
    """oracle.search over operation documents (a postings index of
    their DAR keys), at the wall clock's `now` as the store's
    visibility rule; `add` and `drop` follow later writes."""

    def __init__(self, docs):
        from dss_tpu_torch.clock import to_nanos
        from dss_tpu_torch.dar import codec

        self.recs = []
        for d in docs:
            op = codec.doc_to_op(d)
            self.add(op.id, op.cells, op.altitude_lower, op.altitude_upper,
                     to_nanos(op.start_time), to_nanos(op.end_time))
        self.dead = set()

    def add(self, oid, cells, alo, ahi, t0, t1):
        keys = np.unique(s2cell.cell_to_dar_key(
            np.asarray(cells, np.uint64)))
        self.recs.append(Record(
            oid, keys, -np.inf if alo is None else float(alo),
            np.inf if ahi is None else float(ahi), int(t0), int(t1), 0))
        self._index = None

    def drop(self, oid):
        self.dead.add(oid)

    def ids(self, keys_row, alo, ahi, ts, te) -> list:
        if self._index is None:
            flat = np.concatenate([r.keys for r in self.recs])
            rows = np.repeat(np.arange(len(self.recs)),
                             [len(r.keys) for r in self.recs])
            order = np.argsort(flat, kind="stable")
            self._index = (flat[order], rows[order])
        keys, rows = self._index
        q = np.unique(np.asarray(keys_row, np.int32))
        lo = np.searchsorted(keys, q, "left")
        hi = np.searchsorted(keys, q, "right")
        hit = np.unique(np.concatenate([rows[a:b] for a, b in zip(lo, hi)]
                                       or [np.zeros(0, np.int64)]))
        cand = {i: self.recs[r] for i, r in enumerate(hit)
                if self.recs[r].entity_id not in self.dead}
        slots = oracle.search(cand, q, float(alo), float(ahi), int(ts),
                              int(te), time.time_ns())
        return sorted(cand[s].entity_id for s in slots)


def fed_queries(seed, n, boundary, shift, runs) -> list:
    """n op queries of FED_RUN-key runs (`runs` of them, one each side
    of the boundary when 2; one inside region a when 1), a 300 m band,
    a 1 h window around the phase's clock: [(keys, alo, ahi, ts, te)]."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if runs == 2:
            starts = (int(r.integers(boundary - FED_SPAN, boundary - FED_RUN)),
                      int(r.integers(boundary, boundary + FED_SPAN)))
        else:
            starts = (int(r.integers(max(0, boundary - 4 * FED_SPAN),
                                     boundary - FED_RUN)),)
        keys = np.concatenate([np.arange(s, s + FED_RUN) for s in starts])
        alo = float(np.float32(r.uniform(0, 3000)))
        t0 = NOW + shift + int(r.integers(-2, 2)) * HOUR
        out.append((keys.astype(np.int32), alo,
                    float(np.float32(alo + 300.0)), t0, t0 + HOUR))
    return out


def fed_search(store, q):
    from dss_tpu_torch.clock import from_nanos

    keys, alo, ahi, ts, te = q
    got = store.scd.search_operations(
        s2cell.dar_key_to_cell(keys), alo, ahi, from_nanos(ts),
        from_nanos(te), allow_stale=True)
    return sorted(o.id for o in got)


def fed_drain(stores, order, qs, entry) -> dict:
    """One bulk stale drain of len(qs) callers through stores[entry]'s
    federated store: each store's op table (in `order`: the entry's own
    first, then the peer's) holds its submit until BURST_QUEUED callers
    queue there and the previous store's drain is done, so each region
    drains one batch past HOST_MAX_BATCH.  B1's counts are read between
    the releases: -> {"answers", "launches": {region: n}, "replays":
    {region: n}, "queued": {region: n}, "errors"}."""
    gates, subs = {}, {}
    for k in order:
        table = stores[k].scd._op_index.table
        gates[k] = threading.Event()
        subs[k] = table.query_many_submit

        def gated(*a, _k=k, **kw):
            gates[_k].wait(10.0)
            return subs[_k](*a, **kw)

        table.query_many_submit = gated
    got, errs = [None] * len(qs), []

    def client(i):
        try:
            got[i] = fed_search(stores[entry], qs[i])
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errs.append(repr(e))

    out = {"launches": {}, "replays": {}, "queued": {}}
    ths = [threading.Thread(target=client, args=(i,))
           for i in range(len(qs))]
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
    try:
        for th in ths:
            th.start()
        prev = None
        for k in order:
            co = stores[k].scd._op_index.coalescer
            until = time.perf_counter() + 5.0
            while time.perf_counter() < until and (
                    co.stats()["co_queue_depth"] < BURST_QUEUED
                    or (prev is not None and prev.stats()["co_inflight"])):
                time.sleep(0.002)
            out["queued"][k] = co.stats()["co_queue_depth"]
            if prev is not None:
                out["launches"][order[0]] = ff.fused_window_filter.launches
                out["replays"][order[0]] = \
                    ff.fused_window_filter.graph_replays
                ff.fused_window_filter.launches = 0
                ff.fused_window_filter.graph_replays = 0
            gates[k].set()
            prev = co
        for th in ths:
            th.join(60)
        out["launches"][order[-1]] = ff.fused_window_filter.launches
        out["replays"][order[-1]] = ff.fused_window_filter.graph_replays
    finally:
        for k in order:
            stores[k].scd._op_index.table.__dict__.pop("query_many_submit",
                                                         None)
            gates[k].set()
    out["answers"], out["errors"] = got, errs
    return out


def federation_phase(smi, state) -> tuple:
    """The federation on the card (region/federation.py).
    Part A, in-process: the http phase's WAL (its live state) split at
    the median DAR key into two WALs, each booting a
    DSSStore(storage="cuda") on the card: region a (keys below the
    boundary) and region b; each federated with the other through
    in-process transports over serve_query/serve_sync with the
    `region.federation.request` fault seam (the reference's dryrun
    transport), the sync driven by hand.  Every answer is held against
    the merged state (op queries: oracle.search over both regions' ops;
    ISAs and constraints: one memory store restored from both): local
    and cross-region op queries, ISA and constraint queries over both
    regions, FED_DRAINS bulk stale drains of BURST_CALLERS through each
    region's federated store (B1 counted per region from zero), a write
    into the other region's airspace (400 with the owner's URLs), the
    mirror's full-state sync timed, a seeded FaultPlan partition
    (stale answers exact against the mirror's synced state, a lag
    bound below the mirror's lag shed with a Retry-After, a write to a
    remote cell 503, FEDERATION_DEGRADED entered), the heal (the ladder
    walks back and the state converges).  Part B: the dryrun's sigkill
    leg (cmds/federation_dryrun.run_sigkill_leg) with its two servers
    on --device FED_DEVICE, the card's memory.used read around them.
    -> (the `federation` line, failures, B1's counts in the phase)."""
    import os
    import shutil
    import uuid

    from dss_tpu_torch import chaos, errors
    from dss_tpu_torch.clock import Clock, from_nanos, to_nanos
    from dss_tpu_torch.cmds import federation_dryrun
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.dar.wal import WriteAheadLog
    from dss_tpu_torch.models import rid as ridm
    from dss_tpu_torch.models import scd as scdm
    from dss_tpu_torch.region import federation as fed

    work = os.path.join(state["work"], "federation")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    line = {"card": smi}
    failures = []
    counts = {"a": [0, 0], "b": [0, 0]}  # region -> [launches, replays]

    def fail(msg):
        failures.append(f"federation: {msg}")

    # -- the split, and one WAL per region --------------------------------
    t = time.perf_counter()
    boundary, parts, dropped = fed_split(region_records(state["wal"]))
    wals = {}
    for k, recs in parts.items():
        wals[k] = os.path.join(work, f"region-{k}.wal")
        w = WriteAheadLog(wals[k])
        for rec in recs:
            w.append(rec)
        w.close()
    line["split"] = {
        "boundary": boundary, "left_out": dropped, "seconds":
        time.perf_counter() - t,
        "records": {k: len(v) for k, v in parts.items()},
        "by_class": {k: {c: sum(r["t"] == p for r in v)
                         for c, p in _FED_PUT.items()}
                     for k, v in parts.items()}}
    dev = torch.device(FED_DEVICE)
    entries = [fed.RegionEntry("a", urls=("http://region-a.invalid",)),
               fed.RegionEntry("b", urls=("http://region-b.invalid",))]
    routers, stores = {}, {}
    oracle_store = None

    def transport_to(name):
        def transport(method, path, payload):
            chaos.fault_point("region.federation.request",
                              detail=f"{name}:{path}")
            if path.endswith("/query"):
                return fed.serve_query(routers[name], payload)
            return fed.serve_sync(routers[name])
        return transport

    chaos.clear_plan()
    chaos.registry().reset_counters()
    try:
        # -- 1. both regions boot from their WALs on the card --------------
        alloc0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        boot = {}
        for local, remote in (("a", "b"), ("b", "a")):
            routers[local] = fed.FederationRouter(
                fed.FederationMap(entries, np.array([boundary], np.int32),
                                  local),
                {remote: fed.FederationPeer(remote, transport_to(remote),
                                            fail_threshold=3,
                                            reset_s=FED_RESET_S)})
        for local in ("a", "b"):
            t = time.perf_counter()
            stores[local] = DSSStore(storage="cuda", device=dev,
                                     wal_path=wals[local], clock=Clock())
            boot[local] = {"seconds": time.perf_counter() - t,
                           "records": len(parts[local])}
            # the sync is driven by hand below: no sync loop
            routers[local].start = lambda: None
            stores[local].attach_federation(routers[local])
        for local in ("a", "b"):
            boot[local]["settle_s"] = settle(stores[local], 0.25)
            boot[local]["records_per_s"] = (
                boot[local]["records"] / boot[local]["seconds"])
            boot[local]["classes"] = store_counts(stores[local])
        line["boot"] = boot
        line["card_mib_two_regions"] = (
            (torch.cuda.memory_allocated() - alloc0) / 2**20
            if dev.type == "cuda" else None)
        sa, sb = stores["a"], stores["b"]
        ra, rb = routers["a"], routers["b"]

        # -- 2. the merged oracle ------------------------------------------
        t = time.perf_counter()
        docs = {k: [r["doc"] for r in v if r["t"] == "scd_op_put"]
                for k, v in parts.items()}
        orc = DocOracle(docs["a"] + docs["b"])
        oracle_store = DSSStore(storage="memory", clock=Clock())
        oracle_store.rid.restore_state({
            "isas": [r["doc"] for v in parts.values() for r in v
                     if r["t"] == "isa_put"],
            "subs": [r["doc"] for v in parts.values() for r in v
                     if r["t"] == "rid_sub_put"]})
        oracle_store.scd.restore_state({
            "ops": [], "subs": [],
            "constraints": [r["doc"] for v in parts.values() for r in v
                            if r["t"] == "scd_cst_put"]})
        line["oracle_s"] = time.perf_counter() - t
        shift = state["now"] + HOUR // 2 - NOW

        def held(store, qs, what):
            lat, bad = [], 0
            for i, q in enumerate(qs):
                t = time.perf_counter()
                got = fed_search(store, q)
                lat.append(time.perf_counter() - t)
                good = got == orc.ids(*q)
                bad += not good
                FED_TALLY.check(good, f"{what} {i} != merged oracle")
                fed.take_fed_note()
            return {"queries": len(qs), "mismatches": bad, **lat_ms(lat)}

        # -- 3. local and cross-region op queries --------------------------
        line["local"] = held(sa, fed_queries(61, FED_LOCAL, boundary,
                                             shift, 1), "local op query")
        cross = fed_queries(62, FED_QUERIES, boundary, shift, 2)
        line["cross"] = held(sa, cross[:FED_QUERIES // 2], "cross op query")
        line["cross_from_b"] = held(sb, cross[FED_QUERIES // 2:],
                                    "cross op query from b")
        line["remote_queries"] = {"a": ra.remote_queries,
                                  "b": rb.remote_queries}

        # -- 4. ISAs and constraints over both regions ---------------------
        now_dt = from_nanos(time.time_ns())
        w1 = from_nanos(state["now"] + 6 * HOUR)
        r = np.random.default_rng(63)
        isa_bad = cst_bad = hits = 0
        for i in range(FED_CHECKS):
            area = int(r.integers(0, POLL_AREAS))
            keys = np.concatenate([
                np.arange(area * POLL_CELLS, area * POLL_CELLS + 8),
                np.arange(boundary + 8 * i, boundary + 8 * i + 8)])
            cells = s2cell.dar_key_to_cell(keys.astype(np.int64))
            got = sorted(x.id for x in sa.rid.search_isas(
                cells, now_dt, None, allow_stale=True))
            want = sorted(x.id for x in oracle_store.rid.search_isas(
                cells, now_dt, None))
            isa_bad += got != want
            hits += len(got)
            FED_TALLY.check(got == want, f"ISA query {i} != merged oracle")
            s = int(r.integers(0, boundary - 64))
            keys = np.concatenate([np.arange(s, s + 64),
                                   np.arange(boundary, boundary + 64)
                                   + int(r.integers(0, N_CELLS // 4))])
            cells = s2cell.dar_key_to_cell(keys.astype(np.int64))
            got = sorted(x.id for x in sb.scd.search_constraints(
                cells, None, None, now_dt, w1, allow_stale=True))
            want = sorted(x.id for x in oracle_store.scd.search_constraints(
                cells, None, None, now_dt, w1))
            cst_bad += got != want
            hits += len(got)
            FED_TALLY.check(got == want,
                            f"constraint query {i} != merged oracle")
        fed.take_fed_note()
        line["isa_constraint"] = {"queries": 2 * FED_CHECKS, "hits": hits,
                                  "isa_mismatches": isa_bad,
                                  "constraint_mismatches": cst_bad}

        # -- 5. bulk stale drains through each region's federated store ----
        for store in (sa, sb):
            store.configure_serving(min_batch=BURST_MIN_BATCH)
        drains = {"bursts_per_region": FED_DRAINS, "callers": BURST_CALLERS,
                  "queued": [], "errors": []}
        t = time.perf_counter()
        for j in range(2 * FED_DRAINS):
            entry = "a" if j < FED_DRAINS else "b"
            order = ("a", "b") if entry == "a" else ("b", "a")
            qs = fed_queries(700 + j, BURST_CALLERS, boundary, shift, 2)
            out = fed_drain(stores, order, qs, entry)
            drains["queued"].append(out["queued"])
            drains["errors"] += out["errors"][:2]
            for k in ("a", "b"):
                counts[k][0] += out["launches"].get(k, 0)
                counts[k][1] += out["replays"].get(k, 0)
            for i, (q, g) in enumerate(zip(qs, out["answers"])):
                FED_TALLY.check(g is not None and g == orc.ids(*q),
                                f"drain {j} caller {i} != merged oracle")
        fed.take_fed_note()
        drains["seconds"] = time.perf_counter() - t
        drains["b1_launches"] = {k: v[0] for k, v in counts.items()}
        drains["b1_graph_replays"] = {k: v[1] for k, v in counts.items()}
        drains["route_mix"] = {
            k: {rt: s.scd._op_index.coalescer.stats()[
                f"co_route_{rt}_batches"]
                for rt in ("host", "hostchunk", "device", "resident")}
            for k, s in stores.items()}
        line["drains"] = drains
        if drains["errors"]:
            fail(f"drains: {drains['errors'][:3]}")
        for k in ("a", "b"):
            if counts[k][0] + counts[k][1] <= 0:
                fail(f"B1 never launched on region {k}'s store")

        # -- 6. a write into the other region's airspace -------------------
        w0 = from_nanos(time.time_ns() + 10 * 60 * 10**9)
        b_cells = s2cell.dar_key_to_cell(
            np.arange(boundary + 10, boundary + 14, dtype=np.int64))

        def isa(cells):
            return ridm.IdentificationServiceArea(
                id=str(uuid.uuid4()), owner="smoke",
                url="https://uss.example/f", cells=cells, start_time=w0,
                end_time=from_nanos(time.time_ns() + HOUR),
                altitude_lo=0.0, altitude_hi=120.0)

        guard = {}
        try:
            sa.rid.insert_isa(isa(b_cells))
            fail("a write into b's airspace was accepted at a")
        except errors.StatusError as e:
            guard["healthy_status"] = e.http_status
            guard["names_owner_url"] = "region-b.invalid" in e.message
        FED_TALLY.check(guard.get("healthy_status") == 400
                        and guard.get("names_owner_url", False),
                        f"remote-owned write at a: {guard}")

        # -- 7. the mirror's full-state sync, timed -----------------------
        t = time.perf_counter()
        body = fed.serve_sync(rb)
        serve_s = time.perf_counter() - t
        t = time.perf_counter()
        mib = len(json.dumps(body)) / 2**20
        json_s = time.perf_counter() - t
        t = time.perf_counter()
        ra.mirrors["b"].apply_sync(body)
        apply_s = time.perf_counter() - t
        del body
        t = time.perf_counter()
        ok_sync = ra.sync_peer("b") and rb.sync_peer("a")
        line["sync"] = {
            "serve_sync_s": serve_s, "mib": mib, "json_s": json_s,
            "apply_sync_s": apply_s, "records": len(parts["b"]),
            "both_ways_s": time.perf_counter() - t,
            "mirror_counts": {"a<-b": ra.mirrors["b"].counts(),
                              "b<-a": rb.mirrors["a"].counts()}}
        if not ok_sync:
            fail("a sync failed on a healthy link")

        # -- 8. a seeded partition of b ------------------------------------
        chaos.registry().reset_counters()
        chaos.install_plan({"seed": 17, "events": [
            {"site": "region.federation.request", "match": "b:",
             "action": "partition", "count": -1},
            {"site": "region.federation.sync", "match": "b",
             "action": "partition", "count": -1}]})
        part = {}
        t_part = time.perf_counter()
        syncs = [ra.sync_peer("b") for _ in range(3)]
        part["syncs"] = syncs
        part["degraded_after_syncs"] = sa.health.mode_name()
        if sa.health.mode_name() != "federation_degraded":
            fail(f"the ladder did not enter FEDERATION_DEGRADED: "
                 f"{sa.health.mode_name()}")
        # b keeps writing its own airspace: the mirror does not see it
        new_op = scdm.Operation(
            id=str(uuid.uuid4()), owner="uss-b", version=0,
            start_time=from_nanos(state["now"] + HOUR // 2 - HOUR),
            end_time=from_nanos(state["now"] + 3 * HOUR),
            altitude_lower=0.0, altitude_upper=3000.0,
            uss_base_url="https://uss.example", state="Accepted",
            cells=s2cell.dar_key_to_cell(
                np.arange(boundary + 20, boundary + 28, dtype=np.int64)))
        stored, _ = sb.scd.upsert_operation(new_op, [], key_checked=True)
        stale_qs = fed_queries(64, FED_STALE, boundary, shift, 2)
        stale_qs[0] = (np.concatenate([
            np.arange(boundary - 8, boundary - 4),
            np.arange(boundary + 20, boundary + 24)]).astype(np.int32),
            0.0, 3000.0, NOW + shift - HOUR, NOW + shift + HOUR)
        lat, stale_bad, modes = [], 0, set()
        s0 = ra.stale_served
        for i, q in enumerate(stale_qs):
            t = time.perf_counter()
            got = fed_search(sa, q)
            lat.append(time.perf_counter() - t)
            note = fed.take_fed_note()
            modes.add(note["mode"] if note else None)
            good = got == orc.ids(*q)  # the mirror's state: pre-write
            stale_bad += not good
            FED_TALLY.check(good, f"stale query {i} != the mirror's state")
        part["stale"] = {"queries": len(stale_qs), "mismatches": stale_bad,
                         "served": ra.stale_served - s0,
                         "modes": sorted(str(m) for m in modes),
                         "mirror_lag_s": ra.mirrors["b"].lag_s(),
                         **lat_ms(lat)}
        if modes != {"stale"}:
            fail(f"cross-region reads in the partition were {modes}")
        fed.set_lag_bound(0.0)
        try:
            fed_search(sa, stale_qs[1])
            fail("a lag bound below the mirror's lag was served")
        except fed.FederationUnavailable as e:
            part["overbound"] = {"status": e.http_status,
                                 "retry_after_s": e.retry_after_s}
        finally:
            fed.set_lag_bound(None)
            fed.take_fed_note()
        try:
            sa.rid.insert_isa(isa(b_cells))
            fail("a write into partitioned b's airspace was accepted")
        except errors.StatusError as e:
            part["remote_write"] = {
                "status": e.http_status,
                "retry_after_s": getattr(e, "retry_after_s", None)}
        local_ok = 0
        for q in fed_queries(65, 16, boundary, shift, 1):
            local_ok += fed_search(sa, q) == orc.ids(*q)
        fed.take_fed_note()
        part["local_served"] = {"queries": 16, "exact": local_ok}
        FED_TALLY.check(local_ok == 16, "local queries in the partition")
        FED_TALLY.check(part.get("overbound", {}).get("status") == 503
                        and part["overbound"]["retry_after_s"] > 0,
                        f"over-bound read: {part.get('overbound')}")
        FED_TALLY.check(part.get("remote_write", {}).get("status") == 503,
                        f"remote write in the partition: "
                        f"{part.get('remote_write')}")
        part["injected"] = chaos.registry().injected_by_site()

        # -- 9. the heal: the ladder walks back, the state converges ------
        chaos.clear_plan()
        t_heal = time.perf_counter()
        syncs = 0
        while not ra.sync_peer("b"):
            syncs += 1
            if time.perf_counter() - t_heal > REGION_DEADLINE_S:
                raise RuntimeError("b never re-synced after the heal")
            time.sleep(0.02)
        t_ok = time.perf_counter()
        part["recover_s"] = t_ok - t_heal
        part["failed_syncs_before_recovery"] = syncs
        part["degraded_s"] = t_ok - t_part
        part["ladder_dwell_s"] = sa.health.dwell_s("federation_degraded")
        part["mode_after"] = sa.health.mode_name()
        if sa.health.mode_name() != "healthy":
            fail(f"the ladder did not walk back: {sa.health.mode_name()}")
        orc.add(stored.id, stored.cells, stored.altitude_lower,
                stored.altitude_upper, to_nanos(stored.start_time),
                to_nanos(stored.end_time))
        conv = held(sa, stale_qs, "converged query")
        conv["has_b_write"] = stored.id in fed_search(sa, stale_qs[0])
        FED_TALLY.check(conv["has_b_write"], "b's write not seen after heal")
        conv["mirror_counts"] = ra.mirrors["b"].counts()
        FED_TALLY.check(conv["mirror_counts"]["op"] == sum(
            r["t"] == "scd_op_put" for r in parts["b"]) + 1,
            f"mirror ops after heal {conv['mirror_counts']}")
        fed.take_fed_note()
        part["converged"] = conv
        line["partition"] = part
        line["router_stats"] = {k: {m: v for m, v in r_.stats().items()
                                    if not isinstance(v, dict)}
                                for k, r_ in routers.items()}
    except Exception as e:  # noqa: BLE001 — the phase fails, the run goes on
        fail(f"part A: {e!r}")
    finally:
        chaos.clear_plan()
        fed.take_fed_note()
        fed.set_lag_bound(None)
        for s in stores.values():
            s.close()
        if oracle_store is not None:
            oracle_store.close()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- Part B: the dryrun's sigkill leg, its servers on the card --------
    t = time.perf_counter()
    used0 = card_used_mib()
    os.makedirs(os.path.join(work, "sigkill"), exist_ok=True)
    try:
        verdict = federation_dryrun.run_sigkill_leg(
            os.path.join(work, "sigkill"), device=FED_DEVICE,
            on_ready=lambda: {"card_used_mib": card_used_mib()})
    except Exception as e:  # noqa: BLE001 — reported, fails the phase
        verdict = {"ok": False, "error": repr(e)}
    ready = verdict.pop("on_ready", {}).get("card_used_mib")
    verdict["card_mib_two_servers"] = (
        None if None in (used0, ready) else ready - used0)
    verdict["seconds"] = time.perf_counter() - t
    line["sigkill"] = verdict
    local_5xx = verdict.get("partition", {}).get("local_5xx")
    FED_TALLY.check(bool(verdict.get("ok")) and local_5xx == 0
                    and verdict.get("bit_identical") is True
                    and verdict.get("unexpected_statuses") == 0,
                    f"sigkill leg: {verdict}")
    if not verdict.get("ok"):
        fail(f"sigkill leg: {verdict.get('error')}")
    shutil.rmtree(work, ignore_errors=True)
    line["mismatches"] = FED_TALLY.mismatches
    line["compared"] = FED_TALLY.compared
    return {"federation": line}, failures, {
        "federation_launches": counts["a"][0] + counts["b"][0],
        "federation_graph_replays": counts["a"][1] + counts["b"][1],
        "federation_launches_by_region": {
            k: v[0] for k, v in counts.items()}}


# -- the tuner (scenario/, plan/autotune.py, tune/) --------------------------

TUNER_LINE = {}  # the `tuner` line, filled part by part in its order
TUNER_TALLY = Tally("tuner")  # the cold start's and the server's answers
SWEEP_ENTITIES, SWEEP_CELLS = 50_000, 20_000  # autotune()'s full fixture
SWEEP_ORACLE = 64  # queries of each checked sweep batch against the oracle
COLD_ENTITIES, COLD_CELLS = 100_000, 40_000  # bench.py autotune_leg's size
COLD_THREADS, COLD_SECS, COLD_WIDTH = 8, 8.0, 8
COLD_SAMPLE = 16  # answers per client per pass held against the oracle
TUNE_WINDOWS = 14  # live-loop windows, at most, to the first commit
TUNE_BURSTS = 8  # bulk stale bursts of BURST_CALLERS per window
TUNE_TICK_S = 1e6  # the controller's interval and guard, on a fake clock
#                    the smoke advances by hand: its thread never ticks
TUNE_QUERIES = 32  # op queries through the tuned server, against the oracle
TUNER_DEVICE = "cuda"  # the tuned server's --device
# the coalescer's seeds when nothing is configured (dar/coalesce.py)
DEFAULT_SEEDS = {"est_floor_ms": 20.0, "est_item_ms": 0.02,
                 "est_chunk_ms": 0.3, "est_res_floor_ms": 5.0,
                 "est_res_lat_ms": 20.0}


def b1_counts() -> dict:
    return {"launches": ff.fused_window_filter.launches,
            "graph_replays": ff.fused_window_filter.graph_replays}


def reset_b1() -> None:
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0


def fixture_oracle(table) -> Oracle:
    """The oracle over an autotune fixture's records."""
    recs = list(table.records.values())
    return Oracle(recs, np.stack([r.keys for r in recs]))


def tuner_sweep(dev) -> tuple:
    """Part 1: the full autotune sweep on the card (its 50,000 x 20,000
    fixture, the scenario sweep on), saved, loaded back and printed,
    with B1's eager launches and graph replays counted from zero; then
    the sweep's batches (measure_hit_concentration's query_fused and
    measure_device's 128) on the same seeded fixture through B1 against
    a CPU twin (the plain version) and a sample against the oracle.
    -> (the profile's path, the loaded profile, failures)."""
    import os

    from dss_tpu_torch.plan import autotune as at

    failures = []
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "tuner_smoke")
    os.makedirs(work, exist_ok=True)
    reset_b1()
    t = time.perf_counter()
    profile = at.autotune(quick=False, device=dev)
    wall_s = time.perf_counter() - t
    counts = b1_counts()
    path = at.save_profile(profile, os.path.join(
        work, f"{profile['host_class']}.json"))
    loaded = at.load_profile(path)
    if loaded != profile:
        failures.append("tuner sweep: the saved profile did not load back")
    if set(loaded["knobs"]) != set(at.KNOB_KEYS):
        failures.append("tuner sweep: the profile lacks knobs")
    if loaded["host_class"] != at.host_class(device=dev):
        failures.append(f"tuner sweep: host class {loaded['host_class']}")
    if counts["launches"] <= 0 or counts["graph_replays"] <= 0:
        failures.append(f"tuner sweep: B1 {counts}")
    m = loaded["measurements"]
    line = {
        "host_class": loaded["host_class"],
        "capacity_weight": loaded["capacity_weight"],
        "capacity_basis": loaded["capacity_basis"],
        "knobs": loaded["knobs"],
        "device": m["device"],
        "resident": m["resident"],
        "sweep_s": loaded["sweep_s"], "wall_s": wall_s,
        "fixture": loaded["fixture"],
        "b1": counts,
    }
    # B1's answers in the sweep, on the same fixture and batches
    tally = TALLY["fused_window_filter"]
    c0, m0 = tally.compared, tally.mismatches
    card = at._fixture(SWEEP_ENTITIES, SWEEP_CELLS, device=dev)
    twin = at._fixture(SWEEP_ENTITIES, SWEEP_CELLS, device="cpu")
    try:
        cf, hf = card._state.snap.fast, twin._state.snap.fast
        ids = card._state.snap.ids
        orc = fixture_oracle(card)
        for what, qb in (
                ("hit concentration", at._query_batch(19, 256, SWEEP_CELLS)),
                ("device 128", at._query_batch(13 + 128, 128, SWEEP_CELLS))):
            got = cf.query_fused(*qb, now=at.NOW)
            tally.check(pair_set(*got) == pair_set(
                *hf.query_fused(*qb, now=at.NOW)), f"sweep {what}: card "
                "!= plain version")
            for i in range(SWEEP_ORACLE):
                mine = sorted({ids[s] for s in got[1][got[0] == i]})
                tally.check(mine == orc.ids(*(col[i] for col in qb)),
                            f"sweep {what}: query {i} != oracle")
        tally.check(at.measure_hit_concentration(cf, SWEEP_CELLS)
                    == at.measure_hit_concentration(hf, SWEEP_CELLS),
                    "sweep hit concentration: card != plain version")
    finally:
        card.close()
        twin.close()
    line["checked"] = {"compared": tally.compared - c0,
                       "mismatches": tally.mismatches - m0}
    TUNER_LINE["sweep"] = line
    return path, loaded, failures


def seeds_from_profile(profile) -> dict:
    """QueryCoalescer seeds from a profile's knobs (bench.py:2751)."""
    k = profile["knobs"]
    return {
        "est_floor_ms": float(k["DSS_CO_EST_FLOOR_MS"]),
        "est_item_ms": float(k["DSS_CO_EST_ITEM_MS"]),
        "est_chunk_ms": float(k["DSS_CO_EST_CHUNK_MS"]),
        "est_res_floor_ms": float(k["DSS_CO_EST_RES_FLOOR_MS"]),
        "est_res_lat_ms": float(k["DSS_CO_EST_RES_LAT_MS"]),
        "res_ring": int(k["DSS_CO_RES_RING"]),
        "res_inflight": int(k["DSS_CO_RES_INFLIGHT"]),
    }


def cold_pass(table, orc, seeds, early_frac=0.4) -> dict:
    """bench.py's _cold_start_pass (:2766): a fresh coalescer seeded
    with `seeds` over the warmed table, COLD_THREADS closed-loop clients
    for COLD_SECS with the serving SLO, the early window's p99 apart;
    the first COLD_SAMPLE answers of each client against the oracle."""
    from dss_tpu_torch import errors
    from dss_tpu_torch.dar.coalesce import QueryCoalescer

    co = QueryCoalescer(table, slo_ms=SLO_MS, resident=True, **seeds)
    loop = co.resident_loop()
    if loop is not None:
        table.warm_resident(loop.kernel, batch_buckets=(128,),
                            window_buckets=(4096,))
    st0 = co.stats()
    b0 = b1_counts()
    stop = threading.Event()
    samples = [[] for _ in range(COLD_THREADS)]
    checks = [[] for _ in range(COLD_THREADS)]
    sheds = [0] * COLD_THREADS
    errs = []
    t_start = time.perf_counter()

    def client(i):
        r = np.random.default_rng(7000 + i)
        try:
            while not stop.is_set():
                start = int(r.integers(0, COLD_CELLS - COLD_WIDTH))
                keys = (start + np.arange(COLD_WIDTH)).astype(np.int32)
                alo = float(np.float32(r.uniform(0, 3000)))
                ahi = float(np.float32(alo + 300.0))
                t0 = NOW + int(r.integers(-2, 2)) * HOUR
                t_req = time.perf_counter()
                try:
                    got = co.query(keys, alo, ahi, t0, t0 + HOUR, now=NOW)
                except errors.StatusError:
                    sheds[i] += 1
                    continue
                t_done = time.perf_counter()
                samples[i].append((t_req - t_start, (t_done - t_req) * 1e3))
                if len(checks[i]) < COLD_SAMPLE:
                    checks[i].append((keys, alo, ahi, t0, t0 + HOUR, got))
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errs.append(repr(e))

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(COLD_THREADS)]
    for th in ths:
        th.start()
    time.sleep(COLD_SECS)
    stop.set()
    for th in ths:
        th.join()
    st1 = co.stats()
    b1 = b1_counts()
    co.close()
    for part in checks:
        for *args, got in part:
            TUNER_TALLY.check(sorted(got) == orc.ids(*args),
                              "cold start: answer != oracle")
    all_s = sorted(x for part in samples for x in part)
    lat = np.asarray([v for _, v in all_s])
    early = np.asarray([v for t, v in all_s if t <= early_frac * COLD_SECS])
    late = np.asarray([v for t, v in all_s if t > early_frac * COLD_SECS])

    def p(a, q):
        return float(np.percentile(a, q)) if len(a) else None

    mix = {r: st1[f"co_plan_{r}"] - st0[f"co_plan_{r}"]
           for r in ("hostchunk", "device", "resident", "inline")}
    return {
        "samples": int(len(lat)), "sheds": int(sum(sheds)),
        "errors": errs[:3],
        "p50_ms": p(lat, 50), "p99_ms": p(lat, 99),
        "early_p99_ms": p(early, 99), "early_samples": int(len(early)),
        "late_p99_ms": p(late, 99), "plan_mix": mix,
        "est_floor_ms_end": st1["co_est_device_floor_ms"],
        "est_chunk_ms_end": st1["co_est_host_chunk_ms"],
        "b1": {k: b1[k] - b0[k] for k in b1},
        "checked": sum(len(c) for c in checks),
    }


def tuner_cold_start(dev, profile) -> list:
    """Part 2: bench.py autotune_leg's cold start (:2835-2880) at its
    full size: one warmed 100,000 x 40,000 table on the card, fresh
    coalescers seeded with the defaults and with the profile's seeds,
    in turns (default, profiled, profiled, default), since the host
    varies between runs.  -> failures."""
    from dss_tpu_torch.plan import autotune as at

    t_all = time.perf_counter()
    table = at._fixture(COLD_ENTITIES, COLD_CELLS, seed=3, device=dev)
    failures = []
    try:
        orc = fixture_oracle(table)
        ft = table._state.snap.fast
        ft.query_fused(*at._query_batch(31, 128, COLD_CELLS), now=NOW)
        reset_b1()
        seeds = {"default": {}, "profiled": seeds_from_profile(profile)}
        passes = []
        for arm in ("default", "profiled", "profiled", "default"):
            passes.append(dict(cold_pass(table, orc, seeds[arm]), arm=arm))
        counts = b1_counts()
    finally:
        table.close()
    for p in passes:
        if p["errors"] or not p["samples"]:
            failures.append(f"cold start {p['arm']}: {p['errors']} "
                            f"({p['samples']} samples)")
    TUNER_LINE["cold_start"] = {
        "entities": COLD_ENTITIES, "cells": COLD_CELLS,
        "threads": COLD_THREADS, "secs": COLD_SECS, "slo_ms": SLO_MS,
        "seeds": seeds, "passes": passes,
        "b1": counts, "seconds": time.perf_counter() - t_all,
    }
    return failures


def tuner_live_loop(store, orc, dev, seed) -> list:
    """Part 3, on the store phase's store before it closes: the store
    reseeded to the coalescer's default floor (20 ms) with inline
    callers off (a lone caller's inline decision would make every
    window of the recorder's ring a mixed one, which proposes nothing;
    bench.py's tune world serves drains only), a TuneController
    attached through attach_tuner over a MetricsRegistry fed each
    caller's store time as ("search", "store_ms"), on a fake clock the
    smoke advances one interval per window (bench.py tune_smoke_leg,
    :5115).  Windows of TUNE_BURSTS bulk stale drains of BURST_CALLERS
    (every answer against the oracle) with a tick after each, until the
    first committed proposal or TUNE_WINDOWS windows (the verdict is
    printed: a fit the shadow or the guard refuses is the loop working);
    then the leg's
    three drills with every hot knob pinned in the controller's
    environment (no organic proposal between them): a seeded FaultPlan
    at tune.apply (reverted, nothing half-applied), an injected bad
    estimate (both device floors 8x: shadow-rejected), and a plausible
    lie (an optimistic cold floor, 0.05 ms) whose guard window runs
    with every cold dispatch delayed by a seeded FaultPlan, as the
    leg's world makes the device truly slow (guard-rolled-back, every
    knob back at its pre-injection value).  B1's counts from zero.
    -> failures."""
    from dss_tpu_torch import chaos
    from dss_tpu_torch import tune
    from dss_tpu_torch.obs.metrics import MetricsRegistry

    t_all = time.perf_counter()
    failures = []
    store.configure_serving(resident=True, slo_ms=SLO_MS, inline=False,
                            min_batch=BURST_MIN_BATCH, **DEFAULT_SEEDS)
    co = store.scd._op_index.coalescer
    metrics = MetricsRegistry()
    clock = [0.0]
    env = {}  # the controller's operator environment: pinned for drills

    def actuate(kn):
        store.configure_serving(**{tune.KNOB_TO_CONFIGURE[k]: v
                                   for k, v in kn.items()})

    ctl = tune.TuneController(
        hist_provider=metrics.stage_hist_front, actuator=actuate,
        current_fn=store.tune_knob_values, interval_s=TUNE_TICK_S,
        guard_s=TUNE_TICK_S, env=env, clock=lambda: clock[0], device=dev)
    store.attach_tuner(ctl)
    reset_b1()
    lats = []

    def search(it):
        t = time.perf_counter()
        got = [x[0] for x in op_query(store, *it, allow_stale=True)]
        dt = time.perf_counter() - t
        metrics.observe_stage("search", "store_ms", dt)
        lats.append(dt * 1e3)
        return got

    def window(k):
        del lats[:]
        bursts = []
        for b in range(TUNE_BURSTS):
            q = make_batch(seed + 97 * k + b, BURST_CALLERS, N_CELLS, WIDTH)
            bursts.append([(q, i) for i in range(BURST_CALLERS)])
        c0 = b1_counts()
        res = drain_bursts(store, bursts, search, lambda it: orc.ids(
            *(col[it[1]] for col in it[0])), "tuner")
        c1 = b1_counts()
        if res["client_errors"]:
            failures.append(f"tuner loop: {res['client_errors']}")
        return {"p99_ms": float(np.percentile(lats, 99)),
                "p50_ms": float(np.percentile(lats, 50)),
                "route_mix": res["route_mix"],
                "b1": {k: c1[k] - c0[k] for k in c1}}

    def tick():
        clock[0] += TUNE_TICK_S
        ev = ctl.tick()
        out = {k: v for k, v in ev.items() if k != "proposal"}
        if "proposal" in ev:
            out.update(knobs=ev["proposal"]["knobs"],
                       kind=ev["proposal"]["kind"])
        return out

    walk = []
    for k in range(TUNE_WINDOWS):
        w = window(k)
        ev = tick()
        walk.append({"window": k, **w, "event": ev,
                     "ring_mix": ctl.recorder.route_mix(),
                     "est_floor_ms": store.tune_knob_values()[
                         "DSS_CO_EST_FLOOR_MS"],
                     "op_est_floor_ms": co.stats()["co_est_device_floor_ms"]})
        if ev["event"] == "committed":
            break
    committed = any(w["event"]["event"] == "committed" for w in walk)
    if ctl.stats()["dss_tune_guard_open"]:  # close a guard left open
        walk.append({"window": len(walk), **window(len(walk)),
                     "event": tick()})
    loop_b1 = b1_counts()
    if loop_b1["launches"] + loop_b1["graph_replays"] <= 0:
        failures.append("tuner loop: B1 never launched")

    # -- the drills, every hot knob pinned ------------------------------
    env.update({k: str(v) for k, v in store.tune_knob_values().items()})
    drills = {"baseline": window(TUNE_WINDOWS + 1)}
    drills["baseline"]["event"] = tick()
    if drills["baseline"]["event"]["event"] != "no_proposal":
        failures.append(f"tuner drill: pinned knobs proposed "
                        f"{drills['baseline']['event']}")
    before = store.tune_knob_values()
    chaos.install_plan(chaos.FaultPlan(
        [chaos.FaultEvent("tune.apply", "error", count=1)], seed=11))
    try:
        ev = ctl.inject({"DSS_CO_EST_FLOOR_MS":
                         before["DSS_CO_EST_FLOOR_MS"] / 2},
                        reason="smoke: faulted apply")
    finally:
        chaos.clear_plan()
    drills["faulted_apply"] = {"event": ev["event"],
                               "knobs_restored":
                               store.tune_knob_values() == before}
    if ev["event"] != "apply_failed" or store.tune_knob_values() != before:
        failures.append(f"tuner drill: faulted apply {ev['event']}")
    ev = ctl.inject({
        "DSS_CO_EST_FLOOR_MS": 8 * before["DSS_CO_EST_FLOOR_MS"],
        "DSS_CO_EST_RES_FLOOR_MS": 8 * before["DSS_CO_EST_RES_FLOOR_MS"]},
        reason="smoke: bad estimates")
    drills["bad_estimate"] = {"event": ev["event"],
                              "shadow": ev.get("shadow"),
                              "knobs_unchanged":
                              store.tune_knob_values() == before}
    if (ev["event"] != "shadow_rejected"
            or store.tune_knob_values() != before):
        failures.append(f"tuner drill: bad estimate {ev['event']}")
    ev = ctl.inject({"DSS_CO_EST_FLOOR_MS": 0.05},
                    reason="smoke: optimistic cold floor")
    drills["lie"] = {"event": ev["event"]}
    if ev["event"] != "applied":
        failures.append(f"tuner drill: the lie was {ev['event']}")
    delay_s = max(0.2, 4e-3 * drills["baseline"]["p99_ms"])
    chaos.install_plan(chaos.FaultPlan(
        [chaos.FaultEvent("device.dispatch", "delay", count=-1,
                          delay_s=delay_s)], seed=12))
    try:
        drills["guard_window"] = window(TUNE_WINDOWS + 2)
    finally:
        chaos.clear_plan()
    drills["guard_window"]["dispatch_delay_s"] = delay_s
    ev = tick()
    drills["guard"] = ev
    drills["knobs_restored"] = store.tune_knob_values() == before
    if (ev["event"] != "rollback" or ev.get("reason") != "p99_regression"
            or not drills["knobs_restored"]):
        failures.append(f"tuner drill: guard {ev}, knobs restored "
                        f"{drills['knobs_restored']}")
    drills["recovered"] = window(TUNE_WINDOWS + 3)
    if drills["recovered"]["p99_ms"] >= drills["guard_window"]["p99_ms"]:
        failures.append("tuner drill: p99 did not recover")
    stats = {k: v for k, v in store.stats().items()
             if k.startswith("dss_tune_")}
    if not (stats["dss_tune_proposals_total"] >= 3
            and stats["dss_tune_rollbacks_total"] >= 1
            and stats["dss_tune_shadow_rejected_total"] >= 1
            and stats["dss_tune_apply_failed_total"] == 1):
        failures.append(f"tuner drill: counters {stats}")
    TUNER_LINE["live_loop"] = {
        "windows": walk, "committed": committed, "b1": loop_b1,
        "bursts_per_window": TUNE_BURSTS, "callers": BURST_CALLERS,
        "seconds": time.perf_counter() - t_all,
    }
    TUNER_LINE["drills"] = drills
    TUNER_LINE["stats"] = stats
    return failures


def tuner_server(state, profile_path) -> list:
    """Part 4: the server binary with `--autotune_profile <the sweep's
    file> --self_tune` on the card, booted from the http phase's WAL
    (bench.py autotune_smoke_leg, :2947-3105): /healthy, then /metrics
    with the profile's age, dss_tune_enabled 1, the knob family at the
    profile's values and the co_plan_* counters, TUNE_QUERIES op
    queries against the oracle, SIGTERM exit 0.  -> failures."""
    import os
    import signal
    import urllib.request

    from dss_tpu_torch.plan import autotune as at

    root = os.path.dirname(os.path.abspath(__file__))
    knobs = at.load_profile(profile_path)["knobs"]
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    err_path = os.path.join(state["work"], "tuned_server.log")
    errf = open(err_path, "wb")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DSS_CO_", "DSS_RES_", "DSS_SHARD_",
                                "DSS_SHM_", "DSS_TUNE"))}
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--enable_scd", "--storage", "cuda",
         "--device", TUNER_DEVICE, "--insecure_no_auth",
         "--wal_path", state["wal"], "--shutdown_grace", str(HTTP_GRACE_S),
         "--no_warmup", "--autotune_profile", profile_path, "--self_tune"],
        cwd=root, stdout=subprocess.DEVNULL, stderr=errf, env=env)
    line, failures = {}, []
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"tuned server exited at boot: rc "
                                   f"{proc.returncode}")
            if time.perf_counter() - t_start > 300:
                raise RuntimeError("tuned server never became healthy")
            try:
                with urllib.request.urlopen(base + "/healthy",
                                            timeout=1) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.1)
        boot_s = time.perf_counter() - t_start
        orc = StoreOracle(state["cols"], time.time_ns())
        mism = 0
        for params, args in svc_aois(74, TUNE_QUERIES,
                                     state["now"] + HOUR // 2):
            status, body = http_json(
                base, "POST", "/dss/v1/operation_references/query", params)
            good = status == 200 and sorted(
                o["id"] for o in body["operation_references"]
            ) == orc.ids(*args)
            mism += not good
            TUNER_TALLY.check(good, "tuned server: op query != oracle")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        age = sum(metric_values(text, "dss_autotune_profile_age_s").values())
        enabled = sum(metric_values(text, "dss_tune_enabled").values())
        active = {name.split('knob="', 1)[1].split('"', 1)[0]: v
                  for name, v in metric_values(
                      text, "dss_tune_knob_active").items()}
        want = {k: float(v) for k, v in knobs.items()
                if k.startswith("DSS_CO_")}
        plan = {name: v for name, v in metric_values(text, "").items()
                if "_co_plan_" in name and v}
        line = {"boot_s": boot_s, "profile_age_s": age,
                "tune_enabled": enabled, "knob_active": active,
                "co_plan": plan, "queries": TUNE_QUERIES,
                "mismatches": mism}
        if not age > 0:
            failures.append(f"tuned server: profile age {age}")
        if enabled != 1:
            failures.append(f"tuned server: dss_tune_enabled {enabled}")
        if active != want:
            failures.append(f"tuned server: knobs {active} != {want}")
        if not metric_values(text, "_co_plan_total"):
            failures.append("tuned server: no co_plan_* counters")
    finally:
        t = time.perf_counter()
        rc = None
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=HTTP_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
                failures.append("tuned server: outlived its grace")
        else:
            rc = proc.returncode
            failures.append(f"tuned server: died (rc {rc})")
        errf.close()
        with open(err_path, "rb") as f:
            log_text = f.read().decode(errors="replace")
        line.update(sigterm_exit_s=time.perf_counter() - t, exit_code=rc,
                    seeded_logged="autotune profile" in log_text
                    and "self-tuning armed" in log_text)
        if rc != 0 or not line["seeded_logged"]:
            failures.append(f"tuned server: exit code {rc}: "
                            f"{log_text[-2000:]}")
    TUNER_LINE["server"] = line
    return failures


# -- multihost (parallel/multihost.py, cmds/multihost_dryrun) ---------------

MULTIHOST_TALLY = Tally("multihost")  # every answer of the serving leg
MH_CLASSES = ("ops", "isas", "rid_subs", "scd_subs", "constraints")
MH_BATCHES = 16  # batches of MH_BATCH searches per entity class
MH_BATCH = 64  # the coalescer's mesh offload chunk
MH_AFTER = 4  # batches per class on the local mesh after the kill
MH_HOST = 8  # searches per class from the host map after the kill (each
#              scans every record of its class in Python)
MH_POSITIONS = 2  # mesh positions per process on the card
MH_DEADLINE_S = 180.0  # any one wait of the phase
MH_DEVICE = "cuda"  # every process's --device


def mh_queries(rep, seed=31) -> dict:
    """MH_BATCHES x MH_BATCH searches per entity class, each the cells
    of a seeded live record of that class, so every search finds at
    least its record -> {class: [[keys per query] per batch]}."""
    rng = np.random.default_rng(seed)
    out = {}
    for cls in MH_CLASSES:
        recs = list(rep._records[cls].values())
        picks = rng.integers(0, len(recs), MH_BATCHES * MH_BATCH)
        keys = [np.unique(recs[int(i)].keys).astype(np.int32).tolist()
                for i in picks]
        out[cls] = [keys[b * MH_BATCH:(b + 1) * MH_BATCH]
                    for b in range(MH_BATCHES)]
    return out


def mh_search(rep, keys, now, cls):
    """One batch of unfiltered searches (every altitude and time)."""

    b = len(keys)
    return rep.query_batch(
        [np.asarray(k, np.int32) for k in keys],
        np.full(b, -np.inf, np.float32), np.full(b, np.inf, np.float32),
        np.full(b, NO_TIME_LO, np.int64), np.full(b, NO_TIME_HI, np.int64),
        now=now, cls=cls)


def mh_serve_worker(argv) -> int:
    """One process of the serving leg (spawned by mh_serving_leg):
    `process_id port|0 wal queries.json workdir device`.  Both join a 1 x
    (2 MH_POSITIONS) global mesh on the card through
    parallel/multihost.py and tail their own copy of the WAL.  The
    follower replays the leader's stream (its `report` command writes
    its card memory) until killed.  The leader folds, answers every
    class's batches (timed; the seam's bytes and ms from zero), asks
    for the report, writes serving.json, then keeps answering until the
    mesh degrades under the follower's SIGKILL, answers MH_HOST
    searches per class from its host map, re-homes on a local mesh of
    the card and answers MH_AFTER batches per class there; final.json
    holds it all."""
    import os

    from dss_tpu_torch.parallel import multihost as mh
    from dss_tpu_torch.parallel.mesh import make_global_mesh

    pid, port, wal, qpath, work, device = argv
    pid = int(pid)

    def dump(name, obj):
        tmp = os.path.join(work, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, os.path.join(work, name))

    t0 = time.perf_counter()
    rt = mh.initialize(
        mh.MultihostConfig(f"127.0.0.1:{port}", pid, 2,
                           dryrun_devices=MH_POSITIONS, device=device),
        on_bound=(lambda p: dump("port.json", p)) if pid == 0 else None)
    join_s = time.perf_counter() - t0
    rep = mh.MultihostReplica(rt, make_global_mesh(dp=1), wal_path=wal,
                              warm_batches=(1, 32, 64))
    def memory():
        if device != "cuda":
            return {"kernels": mesh_counts()}
        return {"reserved_mib": torch.cuda.memory_reserved() / 2**20,
                "allocated_mib": torch.cuda.memory_allocated() / 2**20,
                "kernels": mesh_counts()}

    if pid:
        rep.extra_commands["report"] = lambda head: dump(
            "follower.json", memory())
        try:
            rep.run_follower()
            rc = 0
        except mh.MultihostDegradedError:
            rc = 3
        rep.close()
        rt.close()
        return rc
    with open(qpath) as f:
        q = json.load(f)
    now = q["now"]
    degraded_at = []
    rt.on_degraded(lambda: degraded_at.append(time.time()))
    t = time.perf_counter()
    rep.sync()
    fold_s = time.perf_counter() - t
    seam0 = dict(rt.seam.stats())
    answers, lat = {}, []
    for cls in MH_CLASSES:
        for b, keys in enumerate(q["queries"][cls]):
            t = time.perf_counter()
            answers[f"{cls}/{b}"] = mh_search(rep, keys, now, cls)
            lat.append(time.perf_counter() - t)
    seam = {k: v - seam0[k] for k, v in rt.seam.stats().items()}
    rep.broadcast_control("report")
    stats = {k: v for k, v in rep.stats().items()
             if k.startswith("dss_multihost_")
             or k in ("dss_shard_members", "replica_rebuilds")}
    dump("serving.json", {"join_s": join_s, "fold_s": fold_s,
                          "batch_s": lat, "seam": seam, "stats": stats,
                          "memory": memory(), "answers": answers})
    # the parent kills the follower now: answer until the mesh degrades
    during, i = {}, 0
    deadline = time.monotonic() + MH_DEADLINE_S
    while not rt.degraded and time.monotonic() < deadline:
        cls, b = MH_CLASSES[i % len(MH_CLASSES)], i % MH_BATCHES
        during[f"{cls}/{b}/{i}"] = mh_search(rep, q["queries"][cls][b],
                                             now, cls)
        i += 1
    after = {}
    for cls in MH_CLASSES:
        after[f"host/{cls}/0"] = mh_search(
            rep, q["queries"][cls][0][:MH_HOST], now, cls)
    t = time.perf_counter()
    rep.sync()  # re-home on a local mesh of the card
    rehome_s = time.perf_counter() - t
    for cls in MH_CLASSES:
        for b in range(MH_AFTER):
            after[f"local/{cls}/{b}"] = mh_search(
                rep, q["queries"][cls][b], now, cls)
    stats = {k: v for k, v in rep.stats().items()
             if k.startswith("dss_multihost_") or k == "dss_shard_members"}
    dump("final.json", {"degraded_at": degraded_at[:1],
                        "degraded_reason": rt.degraded_reason,
                        "during": during, "after": after,
                        "rehome_s": rehome_s, "stats": stats,
                        "mesh": dict(rep.mesh.shape),
                        "kernels": mesh_counts()})
    rep.close()
    rt.close()
    return 0


def mh_serving_leg(work, state, smi) -> tuple:
    """The serving leg: a single-process 1x4 ShardedReplica on the
    card over the http phase's WAL answers MH_BATCHES batches of
    MH_BATCH searches per class (timed); then two mh_serve_worker
    processes (2 positions each on the card, a global 1x4 mesh) over
    copies of the same WAL answer the same searches, the follower is
    SIGKILLed while the leader serves, and every answer of the leader
    (mesh, during the kill, host map, local mesh) is held against the
    single process's, in MULTIHOST_TALLY.  -> (its line, failures)."""
    import os
    import shutil
    import signal

    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from dss_tpu_torch.parallel.replica import ShardedReplica

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(work)
    line, failures = {}, []
    now = state["now"]
    wals = []
    for name in ("single", "p0", "p1"):
        wals.append(os.path.join(work, f"{name}.wal"))
        shutil.copyfile(state["wal"], wals[-1])
    t = time.perf_counter()
    k0 = mesh_counts()
    mesh = make_mesh(4, dp=1, sp=4, devices=virtual_devices(MH_DEVICE, 4))
    single = ShardedReplica(mesh, wal_path=wals[0], warm_batches=(1, 32, 64))
    single.sync()
    line["single_fold_s"] = time.perf_counter() - t
    qs = mh_queries(single)
    want, lat = {}, []
    for cls in MH_CLASSES:
        for b, keys in enumerate(qs[cls]):
            t = time.perf_counter()
            want[(cls, b)] = mh_search(single, keys, now, cls)
            lat.append(time.perf_counter() - t)
    line["records"] = {c: len(single._records[c]) for c in MH_CLASSES}
    line["hits_per_search"] = sum(
        len(r) for v in want.values() for r in v) / (len(want) * MH_BATCH)
    line["single_batch"] = lat_ms(lat)
    line["kernel_launches"] = {"single_process": {
        k: v - k0[k] for k, v in mesh_counts().items()}}
    single.close()
    del single, mesh
    gc.collect()
    torch.cuda.empty_cache()
    qpath = os.path.join(work, "queries.json")
    with open(qpath, "w") as f:
        json.dump({"now": now, "queries": qs}, f)
    used0 = card_used_mib()
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.mh_serve_worker(sys.argv[1:]))")
    logs = [open(os.path.join(work, f"worker{i}.log"), "wb")
            for i in range(2)]
    procs = []

    def spawn(i, port):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(i), str(port), wals[i + 1],
             qpath, work, MH_DEVICE], cwd=root, stdout=logs[i],
            stderr=logs[i]))

    def wait_for(name, what, alive=None):
        path = os.path.join(work, name)
        deadline = time.monotonic() + MH_DEADLINE_S
        while not os.path.exists(path):
            if any(p.poll() is not None for p in (alive or procs)):
                raise RuntimeError(f"a worker exited before {what}: "
                                   f"{[p.returncode for p in procs]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"never {what}")
            time.sleep(0.02)
        with open(path) as f:
            return json.load(f)

    def tail(i):
        logs[i].flush()
        with open(logs[i].name, "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def hold(got, key, what):
        if not got:
            MULTIHOST_TALLY.check(False, f"multihost {what} {key}: none")
        for j, ids in enumerate(got):
            MULTIHOST_TALLY.check(ids == want[key][j],
                                  f"multihost {what} {key} query {j}")

    t_leg = time.perf_counter()
    try:
        spawn(0, 0)
        spawn(1, wait_for("port.json", "bound its store"))
        serving = wait_for("serving.json", "served its batches")
        used1 = card_used_mib()
        follower = wait_for("follower.json", "reported its memory")
        time.sleep(0.2)  # the leader is answering again
        t_kill = time.time()
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(30)
        final = wait_for("final.json", "finished after the kill",
                         alive=procs[:1])
        rc0 = procs[0].wait(MH_DEADLINE_S)
        for key, rows in serving["answers"].items():
            cls, b = key.split("/")
            hold(rows, (cls, int(b)), "mesh")
        for key, rows in final["during"].items():
            cls, b, _ = key.split("/")
            hold(rows, (cls, int(b)), "during the kill")
        for key, rows in final["after"].items():
            phase, cls, b = key.split("/")
            hold(rows, (cls, int(b)), phase)
        n = len(serving["batch_s"])
        seam = serving["seam"]
        gathers = max(seam["dss_multihost_gathers"], 1)
        line.update({
            "wal_records": state["n_records"], "processes": 2,
            "positions_per_process": MH_POSITIONS, "mesh": "1x4",
            "batches": n, "batch": MH_BATCH,
            "join_s": serving["join_s"], "fold_s": serving["fold_s"],
            "two_process_batch": lat_ms(serving["batch_s"]),
            "cross_process_per_batch": {
                "gathers": seam["dss_multihost_gathers"] / n,
                "sent_bytes": seam["dss_multihost_gather_sent_bytes"] / n,
                "received_bytes":
                    seam["dss_multihost_gather_received_bytes"] / n,
                "local_ms": seam["dss_multihost_gather_local_ms"] / n,
                "gather_ms": seam["dss_multihost_gather_ms"] / n,
            },
            "gather_ms_per_collective":
                seam["dss_multihost_gather_ms"] / gathers,
            "stats": serving["stats"],
            "refresh_bytes_per_refresh": serving["stats"][
                "dss_multihost_refresh_bytes"] / max(
                serving["stats"]["replica_rebuilds"], 1),
            "card_memory": {
                "memory_used_mib_before": used0,
                "memory_used_mib_serving": used1,
                "memory_used_delta_mib": (None if None in (used0, used1)
                                          else used1 - used0),
                "leader_torch": serving["memory"],
                "follower_torch": follower,
            },
            "batches_during_kill": len(final["during"]),
            "kill_to_degraded_s": (final["degraded_at"][0] - t_kill
                                   if final["degraded_at"] else None),
            "degraded_reason": final["degraded_reason"],
            "rehome_s": final["rehome_s"], "mesh_after": final["mesh"],
            "stats_after": final["stats"],
            "follower_rc": procs[1].returncode, "leader_rc": rc0,
        })
        line["kernel_launches"].update(leader=final["kernels"],
                                       follower=follower["kernels"])
        if rc0 != 0:
            failures.append(f"multihost serving: leader rc {rc0}: "
                            f"{tail(0)}")
        if final["stats"].get("dss_multihost_degraded") != 1:
            failures.append("multihost serving: the leader never "
                            "reported dss_multihost_degraded 1")
        if serving["stats"].get("dss_multihost_degraded") != 0:
            failures.append("multihost serving: degraded before the kill")
        if seam["dss_multihost_gathers"] < n:
            failures.append("multihost serving: batches without a "
                            "cross-process gather")
    except Exception as e:  # noqa: BLE001 — reported as the leg's failure
        failures.append(f"multihost serving: {type(e).__name__}: {e}: "
                        f"{tail(0)} {tail(1) if len(procs) > 1 else ''}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs:
            f.close()
    line["seconds"] = time.perf_counter() - t_leg
    line["card"] = smi
    return line, failures


def mh_server_leg(work, state, smi) -> tuple:
    """Two server processes, `python -m dss_tpu_torch.cmds.server
    --storage cuda --sharded_replica 1,4 --jax_coordinator ...
    --process_id i --num_processes 2 --multihost_dryrun 2`, each booted
    from a copy of the http phase's WAL: /healthy on both, the leader's
    /aux/v1/replica/operations held to its store route for 8 of the
    http phase's op queries (a request that waits out the server's
    deadline behind a lockstep fold is counted and asked again), the
    dss_multihost_* gauges on the leader's /metrics, then SIGTERM of the
    leader and of the follower, exit 0 each.  -> (its line,
    failures)."""
    import os
    import shutil
    import urllib.request

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(work)
    line, failures = {}, []
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    t0 = time.perf_counter()
    for i in range(2):
        wal = os.path.join(work, f"p{i}.wal")
        shutil.copyfile(state["wal"], wal)
        port = free_port()
        procs.append(RegionProc(f"mh_server{i}", [
            "dss_tpu_torch.cmds.server", "--addr", f"127.0.0.1:{port}",
            "--enable_scd", "--storage", "cuda", "--device", MH_DEVICE,
            "--insecure_no_auth", "--wal_path", wal,
            "--shutdown_grace", str(HTTP_GRACE_S), "--no_warmup",
            "--sharded_replica", "1,4", "--replica_refresh_interval",
            str(MESH_REFRESH_S), "--jax_coordinator", coord,
            "--process_id", str(i), "--num_processes", "2",
            "--multihost_dryrun", str(MH_POSITIONS)], port, work, root))
    try:
        for p in procs:
            p.wait_healthy(limit=MH_DEADLINE_S)
        line["healthy_s"] = [p.healthy_s for p in procs]
        leader = procs[0].base

        def replica_ops(vol):
            import urllib.parse

            qs = urllib.parse.urlencode({
                "area": area_of(vol),
                "altitude_lo": vol["volume"]["altitude_lower"]["value"],
                "altitude_hi": vol["volume"]["altitude_upper"]["value"],
                "earliest_time": vol["time_start"]["value"],
                "latest_time": vol["time_end"]["value"]})
            for _ in range(3):
                status, body = http_json(
                    leader, "GET", "/aux/v1/replica/operations?" + qs)
                if status != 504:
                    break
                # the request waited out its deadline behind a lockstep
                # fold (a boundary move's major rebuild holds the mesh
                # lock on every process): counted, then asked again
                line["deadline_504s"] = line.get("deadline_504s", 0) + 1
            if status != 200:
                raise RuntimeError(f"replica surface: HTTP {status} {body}")
            return sorted(body["operation_ids"]), body["replica"]

        aois = state["aois"][:8]
        deadline = time.monotonic() + MH_DEADLINE_S
        while True:
            _, st = replica_ops(aois[0][0]["area_of_interest"])
            if (st["replica_applied_records"] >= state["n_records"]
                    and st["replica_ops_snapshot_records"] > 0):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"the mesh never folded: {st}")
            time.sleep(0.1)
        line["first_fold_s"] = time.perf_counter() - t0
        mism = 0
        for params, _ in aois:
            status, body = http_json(
                leader, "POST", "/dss/v1/operation_references/query",
                params)
            if status != 200:
                raise RuntimeError(f"op query: HTTP {status} {body}")
            want = sorted(o["id"] for o in body["operation_references"])
            got, st = replica_ops(params["area_of_interest"])
            MULTIHOST_TALLY.check(got == want, "multihost server: "
                                  "replica surface != store route")
            mism += got != want
        with urllib.request.urlopen(leader + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        gauges = metric_values(metrics, "")
        line.update({
            "searches": len(aois), "mismatches": mism,
            "boundary_moves": st.get("dss_shard_boundary_moves"),
            "multihost_gauges": {k: v for k, v in gauges.items()
                                 if k.startswith("dss_multihost_")},
            "shard_members": st.get("dss_shard_members"),
            "kernel_launches": mesh_counts_of(metrics),
        })
        if st.get("dss_shard_members") != 2:
            failures.append(f"multihost server: {st.get('dss_shard_members')}"
                            " shard members")
        if not any(k.startswith("dss_multihost_commands")
                   for k in gauges):
            failures.append("multihost server: no dss_multihost_* gauges")
    except Exception as e:  # noqa: BLE001 — reported as the leg's failure
        failures.append(f"multihost server: {type(e).__name__}: {e}: "
                        f"{procs[0].tail()} {procs[1].tail()}")
    finally:
        line["exit_codes"] = [p.stop(grace=HTTP_GRACE_S + 10)
                              for p in procs]
    if line["exit_codes"] != [0, 0]:
        failures.append(f"multihost server: exit codes "
                        f"{line['exit_codes']}: {procs[0].tail()} "
                        f"{procs[1].tail()}")
    line["seconds"] = time.perf_counter() - t0
    line["card"] = smi
    return line, failures


def multihost_phase(smi, state) -> tuple:
    """The process-spanning mesh on the card: the reference's dryrun
    legs (cmds/multihost_dryrun.run_dryrun on MH_DEVICE: one process,
    two, peer loss, elastic join/leave, capacity), the serving leg over
    the http phase's WAL, and the multihost server.  -> (the
    `multihost` line, failures)."""
    import os
    import shutil

    from dss_tpu_torch.cmds.multihost_dryrun import run_dryrun

    work = os.path.join(state["work"], "multihost")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    line, failures = {"card": smi}, []
    t = time.perf_counter()
    v = run_dryrun(os.path.join(work, "dryrun"), num_processes=2,
                   devices_per_process=MH_POSITIONS, device=MH_DEVICE,
                   timeout_s=MH_DEADLINE_S)
    el, multi, pl = (v.get("elastic", {}), v.get("multi", {}),
                     v.get("peerloss", {}))
    line["dryrun"] = {
        k: v.get(k) for k in ("ok", "bit_identical", "peerloss_ok",
                              "elastic_ok", "capacity_ok", "stage")}
    line["dryrun"].update({
        "placement": multi.get("placement"),
        "join_placement": el.get("join", {}).get("placement"),
        "refresh_s": multi.get("refresh_s"),
        "query_qps": multi.get("query_qps"),
        "degraded_after_s": pl.get("degraded_after_s"),
        "stats": {k: x for k, x in multi.get("stats", {}).items()
                  if k.startswith("dss_multihost_")},
        "seconds": time.perf_counter() - t,
    })
    for k in ("ok", "bit_identical", "peerloss_ok", "elastic_ok"):
        if not v.get(k):
            failures.append(f"multihost dryrun: {k} false: "
                            f"{json.dumps(v, default=str)[-3000:]}")
    if multi.get("placement") != {"0": [0, 1], "1": [2, 3]}:
        failures.append(f"multihost dryrun placement {multi.get('placement')}")
    if el.get("join", {}).get("placement") != {
            "0": [0, 1], "1": [2, 3], "2": [4, 5]}:
        failures.append(f"multihost dryrun join placement {el.get('join')}")
    line["serving"], bad = mh_serving_leg(os.path.join(work, "serving"),
                                          state, smi)
    failures += bad
    line["server"], bad = mh_server_leg(os.path.join(work, "server"),
                                        state, smi)
    failures += bad
    line["mismatches"] = MULTIHOST_TALLY.mismatches
    line["compared"] = MULTIHOST_TALLY.compared
    parts = (list(line["serving"].get("kernel_launches", {}).values())
             + [line["server"].get("kernel_launches", {})])
    line["kernel_launches"] = {name: sum(p.get(name, 0) for p in parts)
                               for name in MESH_COUNTED}
    MESH_LINE["multihost_kernel_launches"] = line["kernel_launches"]
    return {"multihost": line}, failures


def run(dev, smi) -> tuple:
    """Phases 2-7 on `dev`; -> (the entries of the kernels line, the
    serving phase's failures)."""
    t_all = time.perf_counter()

    t = time.perf_counter()
    lib = cuda_build.build()
    log(f"build: {lib.name} ({len(cuda_build.sources())} sources, one nvcc "
        f"each, in parallel) in {time.perf_counter() - t:.2f} s")
    # the native host halves: no silent numpy run on the card
    from dss_tpu_torch import native

    t = time.perf_counter()
    if not native.ensure_built():
        raise RuntimeError("dss_tpu_torch.native did not build (g++)")
    log(json.dumps({"native_available": native.available(),
                    "library": native.SO_PATH,
                    "seconds": time.perf_counter() - t}))

    t = time.perf_counter()
    recs, keys = make_records(N_ENTITIES, N_CELLS, KPE)
    log(f"records: {len(recs)} in {time.perf_counter() - t:.2f} s")
    idx = CudaSpatialIndex(device=dev, idle_fold_s=0, delta_capacity=1 << 30)
    twin = CudaSpatialIndex(device="cpu", idle_fold_s=0, delta_capacity=1 << 30)
    t = time.perf_counter()
    idx.table.bulk_load(recs)
    torch.cuda.synchronize()
    log(f"load (cuda): {time.perf_counter() - t:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card")
    t = time.perf_counter()
    twin.table.bulk_load(recs)
    log(f"load (cpu twin): {time.perf_counter() - t:.2f} s")
    ft = idx.table._state.snap.fast
    log(f"L0: {ft.n_postings} postings in {ft.n_blocks} blocks; "
        f"p3 {ft.p3.numel() * 4 / 2**20:.1f} MiB, exact columns "
        f"{ft.n_blocks * 128 * 24 / 2**20:.1f} MiB")

    # -- the kernel against its plain version ---------------------------
    max_err = 0
    cases = edge_cases(dev)
    for name, case_ft, q, mw in cases:
        err, n_words = check_kernel(case_ft, q, name, mw)
        max_err = max(max_err, err)
        log(f"kernel case {name}: max abs err {err} ({n_words} words)")
    compaction_checks(cases)
    log("dirty output and 40 back-to-back launches compared")
    hq = make_batch(100, BATCH, N_CELLS, WIDTH)
    err, n_words = check_kernel(ft, hq, "headline")
    max_err = max(max_err, err)
    args, nw, wins = kernel_args(ft, hq)
    mw = pow2_bucket(nw, lo=1 << 16)
    flush = Flush(dev)
    b1_t = timings("fused_window_filter",
                   lambda: ff.fused_window_filter(*args, max_words=mw),
                   lambda: ff.fused_window_filter_torch(*args, max_words=mw),
                   flush)
    b_ms, nbytes = bound_ms(hq, nw, wins, mw)
    log(f"kernel headline: {nw} windows (bucket {wins.shape[1]}), "
        f"{n_words} words, {json.dumps(b1_t)}, bound {b_ms:.6f} ms "
        f"({nbytes} B), {b_ms / b1_t['ms']:.1%} of bound (cold) [{smi}]")
    # -- the main path, launch counts from zero -------------------------
    orc = Oracle(recs, keys)
    ff.fused_window_filter.launches = 0
    run_batch(idx, twin, make_batch(199, BATCH, N_CELLS, WIDTH))  # warm-up
    lat, hits = [], 0
    for i in range(8):
        st, h = run_batch(idx, twin, make_batch(200 + i, BATCH, N_CELLS, WIDTH),
                          orc, sample=64 if i == 0 else 0)
        lat.append(st)
        hits += h
    tally = TALLY["fused_window_filter"]
    log(f"8 batches x {BATCH}: {hits} hits; {tally.mismatches} mismatches "
        f"of {tally.compared} comparisons so far")
    log(json.dumps({"main_path_device_window": busy_window(
        idx, twin, [make_batch(210 + i, BATCH, N_CELLS, WIDTH)
                    for i in range(2)], smi)}))

    rng = np.random.default_rng(1)
    singles = make_batch(300, 32, N_CELLS, WIDTH)
    for i in range(32):
        cells = s2cell.dar_key_to_cell(singles[0][i])
        a = [singles[j][i] for j in range(1, 5)]
        got = idx.query_ids(cells, *a, now=NOW)
        tally.check(got == twin.query_ids(cells, *a, now=NOW),
                    f"single query {i}: card != twin")
        tally.check(got == orc.ids(singles[0][i], *a),
                    f"single query {i}: card != oracle")
    log("32 single query_ids compared with the twin and the oracle")

    n_up, n_rm = 0, 0
    for j in range(1200):
        if j % 4 == 3:
            eid = f"e{int(rng.integers(0, N_ENTITIES))}"
            idx.remove(eid)
            twin.remove(eid)
            orc.changed[eid] = None
            n_rm += 1
            continue
        eid = f"e{int(rng.integers(0, N_ENTITIES))}" if j % 2 else f"n{j}"
        start = int(rng.integers(0, N_CELLS - WIDTH))
        cell_keys = np.arange(start, start + int(rng.integers(1, 9)), dtype=np.int32)
        alo = float(np.float32(rng.uniform(0, 3000)))
        ahi = float(np.float32(alo + 400.0))  # f32 values, as on the card
        t0 = NOW + int(rng.integers(-2, 2)) * HOUR
        args = (alo, ahi, t0, t0 + 2 * HOUR, j)
        cells = s2cell.dar_key_to_cell(cell_keys)
        idx.put(eid, cells, *args)
        twin.put(eid, cells, *args)
        orc.changed[eid] = Record(eid, cell_keys, *args)
        n_up += 1
    hot = make_batch(400, BATCH, N_CELLS, WIDTH)
    run_batch(idx, twin, hot, orc, sample=64)
    log(f"{n_up} upserts + {n_rm} removes; overlay batch compared")
    if not (idx.table.fold() and twin.table.fold()):
        raise AssertionError("minor fold did not publish")
    if idx.table.stats()["tier_count"] != 2:
        raise AssertionError("minor fold did not build an L1 tier")
    lat.append(run_batch(idx, twin, make_batch(401, BATCH, N_CELLS, WIDTH))[0])
    log("minor fold: L0+L1 batch compared")
    if not (idx.table.compact() and twin.table.compact()):
        raise AssertionError("compaction did not publish")
    for i in range(2):
        st, _ = run_batch(idx, twin, make_batch(402 + i, BATCH, N_CELLS, WIDTH),
                          orc, sample=64 if i == 0 else 0)
        lat.append(st)
    launches = ff.fused_window_filter.launches
    log(f"compaction: batches compared; "
        f"stats {json.dumps(idx.table.stats(), sort_keys=True)}")
    total = [sum(st.values()) for st in lat]
    log(json.dumps({"main_path_first_slice": {
        "entities": N_ENTITIES, "batch": BATCH, "batches": len(lat),
        "batches_per_s": len(lat) / sum(total),
        "p50_batch_ms": statistics.median(total) * 1e3,
        "queries_per_s": len(lat) * BATCH / sum(total),
        "p50_stage_ms": {
            k: statistics.median(st[k] for st in lat) * 1e3 for k in lat[0]
        },
        "card": smi,
        "seconds_total": time.perf_counter() - t_all,
    }}))
    nat_line, nat_counts = native_phase(idx, smi)
    log(json.dumps(nat_line))
    legacy = legacy_phase(
        idx, twin, [(name, f, q) for name, f, q, mw in cases if mw is None],
        orc, smi, flush)
    log(f"seconds before the mesh: {time.perf_counter() - t_all:.2f}")
    MESH_LINE["scale"] = mesh_scale(dev, idx, recs, orc, flush, smi,
                                    b1_t["ms"])
    log(json.dumps({"mesh_scale": MESH_LINE["scale"]}))
    MESH_LINE["skew"] = mesh_skew(dev, smi, flush)
    log(json.dumps({"mesh_skew": MESH_LINE["skew"]}))
    failures = mesh_failures(MESH_LINE)
    log(f"seconds before serving: {time.perf_counter() - t_all:.2f}")
    serving, bad = serving_phase(idx, twin, smi)
    failures += bad
    idx.close()
    twin.close()
    log(f"seconds before the store: {time.perf_counter() - t_all:.2f}")
    store, bad = store_phase(dev, smi)
    failures += bad
    log(f"seconds before the tuner: {time.perf_counter() - t_all:.2f}")
    t = time.perf_counter()
    profile_path, profile, bad = tuner_sweep(dev)
    failures += bad
    log(json.dumps({"tuner_sweep": TUNER_LINE["sweep"]}))
    failures += tuner_cold_start(dev, profile)
    log(json.dumps({"tuner_cold_start": TUNER_LINE["cold_start"]}))
    tuner_s = time.perf_counter() - t + TUNER_LINE["live_loop"]["seconds"]
    log(f"seconds before http: {time.perf_counter() - t_all:.2f}")
    http, bad, http_state = http_phase(smi)
    log(json.dumps(http))
    failures += bad
    t = time.perf_counter()
    if http_state is None:
        failures.append("tuner server: the http phase did not run")
    else:
        failures += tuner_server(http_state, profile_path)
    tuner_s += time.perf_counter() - t
    TUNER_LINE.update(mismatches=TUNER_TALLY.mismatches,
                      compared=TUNER_TALLY.compared, seconds=tuner_s,
                      card=smi)
    log(json.dumps({"tuner": TUNER_LINE}))
    log(f"seconds before the shm front: {time.perf_counter() - t_all:.2f}")
    region_counts, fed_counts = {}, {}
    if http_state is None:
        log(json.dumps({"shm_front": {"ran": False,
                                      "why": "the http phase did not run"}}))
    else:
        t = time.perf_counter()
        try:
            shm, bad = shm_front_phase(smi, http_state,
                                       http["http"]["loop_procs"])
            shm["shm_front"]["seconds"] = time.perf_counter() - t
            log(json.dumps(shm))
            failures += bad
            log(f"seconds before the mesh server: "
                f"{time.perf_counter() - t_all:.2f}")
            t = time.perf_counter()
            MESH_LINE["server"], bad = mesh_server(smi, http_state)
            MESH_LINE["server"]["seconds"] = time.perf_counter() - t
            failures += bad
            log(f"seconds before the region: "
                f"{time.perf_counter() - t_all:.2f}")
            t = time.perf_counter()
            region, bad, region_counts = region_phase(smi, http_state)
            region["region"]["seconds"] = time.perf_counter() - t
            log(json.dumps(region))
            failures += bad
            log(f"seconds before the federation: "
                f"{time.perf_counter() - t_all:.2f}")
            t = time.perf_counter()
            fed_line, bad, fed_counts = federation_phase(smi, http_state)
            fed_line["federation"]["seconds"] = time.perf_counter() - t
            log(json.dumps(fed_line))
            failures += bad
            log(f"seconds before multihost: "
                f"{time.perf_counter() - t_all:.2f}")
            t = time.perf_counter()
            mh_line, bad = multihost_phase(smi, http_state)
            mh_line["multihost"]["seconds"] = time.perf_counter() - t
            log(json.dumps(mh_line))
            failures += bad
        finally:
            import shutil

            shutil.rmtree(http_state["work"], ignore_errors=True)
    MESH_LINE["mismatches"] = MESH_TALLY.mismatches
    MESH_LINE["compared"] = MESH_TALLY.compared
    MESH_LINE["card"] = smi
    log(json.dumps({"mesh": MESH_LINE}))
    log(f"seconds before push: {time.perf_counter() - t_all:.2f}")
    push, push_counts, bad = push_phase(dev, smi)
    log(json.dumps(push))
    failures += bad
    log(f"seconds_total: {time.perf_counter() - t_all:.2f}")
    b1 = entry("fused_window_filter", launches, max_err, b1_t, b_ms)
    b1.update(serving)
    b1.update(store)
    b1.update(nat_counts)
    b1.update(push_counts)
    b1.update(region_counts)
    b1.update(fed_counts)
    parts = ("sweep", "cold_start", "live_loop")
    b1.update({f"tuner_{k}_{part}": TUNER_LINE[part]["b1"][k]
               for part in parts for k in ("launches", "graph_replays")})
    b1.update({f"tuner_{k}": sum(TUNER_LINE[part]["b1"][k]
                                 for part in parts)
               for k in ("launches", "graph_replays")})
    return [b1] + legacy + mesh_kernel_entries(), failures


def main() -> int:
    # importing the port starts the native library's build on a thread
    # when it is stale: let that g++ finish, whatever follows
    for th in threading.enumerate():
        if th.name == "dss-native-build":
            th.join()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    kernels, failures = run(torch.device("cuda"), smi)
    print(json.dumps({"device_time_by_kernel": DEVICE_BY_NAME, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        print(f"chip_smoke: never launched on its path: {idle}",
              file=sys.stderr)
        return 1
    if failures:
        print(f"chip_smoke: a serving, store, tuner, services, http, shm "
              f"front, push, mesh, region, federation or multihost phase "
              f"failed: {failures}",
              file=sys.stderr)
        return 1
    # K1's and K2's comparisons are on MESH_TALLY as well
    tallies = [t for name, t in TALLY.items() if name not in MESH_COUNTED]
    tallies += [STORE_TALLY, NATIVE_TALLY, PUSH_TALLY, MESH_TALLY,
                REGION_TALLY, FED_TALLY, TUNER_TALLY, MULTIHOST_TALLY]
    bad = sum(t.mismatches for t in tallies)
    if bad:
        print(f"chip_smoke: {bad} of "
              f"{sum(t.compared for t in tallies)} comparisons "
              "disagreed", file=sys.stderr)
        return 1
    # the smoke drives card 0 alone, whatever else the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

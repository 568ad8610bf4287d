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
     oracle; B3's and B4's own entries driven on each batch's first 512
     windows against the twin; then B3 and B4 against their plain
     versions, with times and bounds;
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
  8. the store: a WAL of 500k SCD operational intents (8 contiguous
     level-13 cells each, 10-600 m bands, 1-5 h windows), the RID poll
     recipe's 4,000 ISAs over 512 areas, and a few hundred RID
     subscriptions, SCD subscriptions and constraints, written with
     the port's codec and WriteAheadLog; DSSStore(storage="cuda")
     booted from it (`store_boot`: records, seconds, records/s, each class's tiers and
     live records, MiB on the card); the resident graph grid warmed;
     with B1's counts from zero, 512 seeded search_operations held
     against the oracle at the store clock (`store_oracle`), the bulk
     stale drain through the store (8 bursts of 128 allow_stale
     callers, `store_burst`), 1,200 writes (OVN-keyed upserts keyed
     from a prior search, a third of the new ones one OVN short and
     refused, fenced updates, deletes, subscriptions; `store_writes`),
     a reboot from the same WAL compared with the live store
     (`store_reboot`: the time to recover), and the RID poll recipe
     through store.rid.search_isas, cache on then off, against a
     memory twin that takes the same writes (`store_poll`);
  9. the device time of each kernel by device kernel name, the kernels
     line (four kernels; B1's entry with its graph replays and its
     store-phase counts), with each kernel's count of comparisons made
     and of those that disagreed; then the ok line, or exit 1 if any
     comparison disagreed, a kernel of a path never launched, or the
     serving or store phase failed (a caller error other than
     OverloadedError or DEADLINE_EXCEEDED, an absorbed device loss, no
     resident batch at 32 threads, no graph replay in the bulk bursts,
     a refused write that should have passed, no B1 launch or replay
     in the store phase).
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
# DSSStore(storage="cuda").  Half the north star's 1M (BASELINE.json):
# the boot and the reboot replay one record at a time on the host, and
# at 1M on an H100 host (about 1,700 records/s) the whole smoke took
# 1,471 s, past its 1,200 s limit (PERF.md §4).
STORE_OPS = 500_000
STORE_SUBS = 300  # SCD subscriptions; as many RID subscriptions
STORE_CSTS = 200
POLL_ISAS, POLL_AREAS, POLL_CELLS = 4000, 512, 64
POLL_RATIO, POLL_ZIPF, POLL_THREADS, POLL_SECS = 100, 1.1, 8, 3.0
ORACLE_SAMPLE = 512  # store searches held against the oracle
STORE_BURSTS = 8
STORE_WRITES = 1200
REBOOT_SAMPLE = 256  # searches compared between the live and rebooted store
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
}


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

    def ids(self, keys_row, alo, ahi, ts, te):
        rows = np.flatnonzero(np.isin(self.keys, keys_row).any(axis=1))
        cands = [self.recs[r] for r in rows
                 if self.recs[r].entity_id not in self.changed]
        cands += [r for r in self.changed.values() if r is not None]
        recs = dict(enumerate(cands))
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
    b3_err = check_mask("filter_windows_gridless",
                        fc.filter_windows_gridless(ft.p3, *b3),
                        fc.filter_windows_torch(ft.p3, *b3), "B3 headline")
    mask4 = fc.fused_filter_gridless(*cols4, *b4)
    b4_err = max(
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


def store_columns(n, seed=5):
    """The store phase's operational intents as columns: KPE contiguous
    level-13 cells over the N_CELLS metro region, 10-600 m altitude
    bands, 1-5 h windows."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, N_CELLS - KPE, n)
    keys = (start[:, None] + np.arange(KPE)[None, :]).astype(np.int32)
    alo = rng.uniform(0, 3000, n).astype(np.float32)
    ahi = alo + rng.uniform(10, 600, n).astype(np.float32)
    t0 = NOW + rng.integers(-4, 4, n) * HOUR
    t1 = t0 + rng.integers(1, 6, n) * HOUR
    return keys, alo, ahi, t0, t1


def write_store_wal(path, cols) -> dict:
    """The store phase's WAL, written with the port's codec and
    WriteAheadLog: the format record, then one `scd_op_put` per
    operation, the poll recipe's ISAs, RID subscriptions over its
    areas, and SCD subscriptions and constraints.  Commit stamps are
    one microsecond apart, ending at the store clock's NOW.  ->
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
    base = from_nanos(NOW)
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


def store_bursts(store, orc, seed) -> dict:
    """The reference's bulk stale drain (bench.py:1157-1186) through
    store.scd.search_operations(..., allow_stale=True): STORE_BURSTS
    bursts of BURST_CALLERS callers, the op table's submit held until
    BURST_QUEUED queue; every answer held against the oracle."""
    index = store.scd._op_index
    co, table = index.coalescer, index.table
    submit = table.query_many_submit
    errors_seen, queued = [], []
    st0 = co.stats()
    for k in range(STORE_BURSTS):
        q = make_batch(seed + k, BURST_CALLERS, N_CELLS, WIDTH)
        got = [None] * BURST_CALLERS
        gate = threading.Event()

        def gated(*a, **kw):
            gate.wait(10.0)
            return submit(*a, **kw)

        def client(i):
            try:
                got[i] = op_query(store, q, i, allow_stale=True)
            except Exception as e:  # noqa: BLE001 — fails the phase below
                errors_seen.append(repr(e))

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
        for i, g in enumerate(got):
            STORE_TALLY.check(
                g is not None and [x[0] for x in g] == orc.ids(
                    q[0][i], q[1][i], q[2][i], q[3][i], q[4][i]),
                f"store burst {k}: caller {i} != oracle")
    st1 = co.stats()
    return {
        "bursts": STORE_BURSTS, "callers": BURST_CALLERS,
        "queued_at_release": queued, "client_errors": errors_seen[:3],
        "route_mix": {r: st1[f"co_route_{r}_batches"]
                      - st0[f"co_route_{r}_batches"]
                      for r in ("host", "hostchunk", "device", "resident")},
        "device_loss_absorbed": st1["co_device_loss_absorbed"],
    }


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

    def boot():
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        t = time.perf_counter()
        s = DSSStore(storage="cuda", device=dev, wal_path=path,
                     clock=FakeClock(from_nanos(NOW)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        mem = (torch.cuda.memory_allocated() - mem0) if dev.type == "cuda" else 0
        return s, secs, mem / 2**20

    store, boot_s, mib = boot()
    log(json.dumps({"store_boot": {
        "records": n_records, "seconds": boot_s,
        "records_per_s": n_records / boot_s, "classes": store_counts(store),
        "mib_on_card": mib, "card": smi}}))
    freeze_boot_heap()

    # the resident loops and their graph grid, as a server boots them
    store.configure_serving(resident=True, slo_ms=SLO_MS)
    t = time.perf_counter()
    built = store.warm_resident()
    log(json.dumps({"store_graph_warm": {
        "entries": built, "seconds": time.perf_counter() - t}}))

    orc = StoreOracle(cols, NOW)
    ff.fused_window_filter.launches = 0
    ff.fused_window_filter.graph_replays = 0
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
    counts = store_counts(store)
    store.close()
    del store  # its tables leave the card before the reboot's measure
    gc.collect()
    store, reboot_s, mib = boot()
    recounts = store_counts(store)
    for cls in STORE_CLASSES:
        for k in ("records", "live_records"):
            STORE_TALLY.check(recounts[cls][k] == counts[cls][k],
                              f"reboot {cls} {k}: {recounts[cls][k]} != "
                              f"{counts[cls][k]}")
    for i in range(REBOOT_SAMPLE):
        STORE_TALLY.check(op_query(store, q, i) == live[i],
                          f"reboot search {i} != live store")
    log(json.dumps({"store_reboot": {
        "records": store.wal.seq, "seconds": reboot_s,
        "records_per_s": store.wal.seq / reboot_s, "classes": recounts,
        "mib_on_card": mib, "searches_compared": REBOOT_SAMPLE,
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
    if launches + replays <= 0:
        failures.append("store phase: B1 never launched")
    twin.close()
    store.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    return {"store_launches": launches, "store_graph_replays": replays,
            "store_boot_s": boot_s, "store_reboot_s": reboot_s}, failures


def run(dev, smi) -> tuple:
    """Phases 2-7 on `dev`; -> (the entries of the kernels line, the
    serving phase's failures)."""
    t_all = time.perf_counter()

    t = time.perf_counter()
    lib = cuda_build.build()
    log(f"build: {lib.name} ({len(cuda_build.sources())} sources, one nvcc "
        f"each, in parallel) in {time.perf_counter() - t:.2f} s")

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
    legacy = legacy_phase(
        idx, twin, [(name, f, q) for name, f, q, mw in cases if mw is None],
        orc, smi, flush)
    log(f"seconds before serving: {time.perf_counter() - t_all:.2f}")
    serving, failures = serving_phase(idx, twin, smi)
    idx.close()
    twin.close()
    log(f"seconds before the store: {time.perf_counter() - t_all:.2f}")
    store, bad = store_phase(dev, smi)
    failures += bad
    log(f"seconds_total: {time.perf_counter() - t_all:.2f}")
    b1 = entry("fused_window_filter", launches, max_err, b1_t, b_ms)
    b1.update(serving)
    b1.update(store)
    return [b1] + legacy, failures


def main() -> int:
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
        print(f"chip_smoke: serving or store phase failed: {failures}",
              file=sys.stderr)
        return 1
    tallies = list(TALLY.values()) + [STORE_TALLY]
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

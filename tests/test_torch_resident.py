"""The port's resident route (dss_tpu_torch/ops/resident.py) on the CPU.

On the CPU a GraphCache entry holds the same static buffers, busy
flags and keys as on the card and captures nothing: a replay runs the
plain version into the buffers.  So the plumbing is held here — bucket
grids and max_words_for against the reference, the cache key and its
LRU and death-drop bounds, busy units, answers equal to the fused and
host routes and to the reference's resident route, results that are
never aliased, the feeder loop's ring, backpressure and drain, and the
coalescer's resident route.  Graph capture and replay themselves are
held on the card (tests/test_torch_kernel_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import gc
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.coalesce import QueryCoalescer as RefQueryCoalescer
from dss_tpu.dar.snapshot import DarTable as RefDarTable
from dss_tpu.ops import resident as ref_resident

from dss_tpu_torch.dar.coalesce import QueryCoalescer
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.ops import fused_filter as ff
from dss_tpu_torch.ops import resident
from dss_tpu_torch.ops.resident import (
    GraphCache,
    ResidentKernel,
    ResidentLoop,
    max_words_for,
)

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
WAIT_S = 20.0


def _fill(table, n, key_space, rng, prefix="e"):
    for i in range(n):
        nk = int(rng.integers(1, 6))
        keys = np.unique(rng.integers(0, key_space, nk).astype(np.int32))
        alo, ahi = sorted(rng.uniform(0, 3000, 2))
        table.upsert(f"{prefix}{i}", keys, float(alo), float(ahi),
                     NOW - HOUR, NOW + HOUR, i % 5)


def _query_args(rng, b, key_space, width=4):
    return (
        [np.unique(rng.integers(0, key_space, width).astype(np.int32))
         for _ in range(b)],
        rng.uniform(0, 2000, b).astype(np.float32),
        rng.uniform(2000, 4000, b).astype(np.float32),
        np.full(b, NOW - HOUR, np.int64),
        np.full(b, NOW + HOUR, np.int64),
    )


def _padded(keys_list, width=8):
    qk = np.full((len(keys_list), width), -1, np.int32)
    for i, k in enumerate(keys_list):
        qk[i, : len(k)] = k
    return qk


def _table(n=600, key_space=50, seed=11):
    t = DarTable(device="cpu", idle_fold_s=0)
    _fill(t, n, key_space, np.random.default_rng(seed))
    t.fold()
    return t


def _wait(pred, what):
    end = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


# -- grids ---------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "4096,128, 1024,128", "64"])
def test_bucket_grids_and_max_words_match_reference(monkeypatch, env):
    for name in ("DSS_RES_BATCH_BUCKETS", "DSS_RES_WINDOW_BUCKETS"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    assert resident.batch_bucket_grid() == ref_resident.batch_bucket_grid()
    assert resident.window_bucket_grid() == ref_resident.window_bucket_grid()
    for wb in [1 << k for k in range(8, 20)] + [3, 70000]:
        assert max_words_for(wb) == ref_resident.max_words_for(wb)


# -- the graph cache -----------------------------------------------------------


def test_graph_cache_key_hits_and_lru_eviction():
    """The key names the table, not its block count: two tables of
    equal block count get different entries.  warm() is idempotent;
    lookups hit warmed buckets and count misses; the LRU bound evicts
    the least recently used of the unreserved (miss-driven) entries; on
    the CPU nothing is captured."""
    t1, t2 = _table(seed=1), _table(seed=2)
    try:
        ft1 = t1._state.tiers[0].snap.fast
        ft2 = t2._state.tiers[0].snap.fast
        assert ft1.n_blocks == ft2.n_blocks
        cache = GraphCache(max_entries=3)
        k1 = cache.key_for(ft1, 256, 128, max_words_for(256))
        assert k1 == cache.key_for(ft1, 256, 128, max_words_for(256))
        assert k1 != cache.key_for(ft2, 256, 128, max_words_for(256))
        assert k1[1:] == (256, 128, 1 << 16)
        kern = ResidentKernel(cache, autocompile=False)
        # a miss-driven build, unreserved
        assert cache.compile(ft1, 256, 128, max_words_for(256), 2)
        assert not cache.compile(ft1, 256, 128, max_words_for(256), 2)
        assert cache.compiles == 1 and cache.captures == 0
        assert cache.reserved() == 0
        unit = kern.lookup(ft1, 256, 128, max_words_for(256))
        assert unit is not None and kern.hits == 1
        unit.release()
        assert kern.lookup(ft2, 256, 128, max_words_for(256)) is None
        assert kern.misses == 1
        # LRU: ft1's entry is the oldest use once three more land
        for bb in (16, 32, 64):
            cache.compile(ft2, 256, bb, max_words_for(256), 2)
        assert cache.size() == 3 and cache.evictions == 1
        assert kern.lookup(ft1, 256, 128, max_words_for(256)) is None
        assert kern.lookup(ft2, 256, 64, max_words_for(256)) is not None
        # a warm reserves its grid: past the bound, only unreserved
        # entries go
        assert kern.warm(ft1, (128, 512), (256,)) == 2
        assert kern.warm(ft1, (128, 512), (256,)) == 0
        assert cache.reserved() == 2 and cache.cap() == 5
        assert cache.size() == 5 and cache.evictions == 1
        cache.compile(ft2, 1024, 16, max_words_for(1024), 2)
        assert cache.size() == 5 and cache.evictions == 2
        assert kern.lookup(ft1, 256, 512, max_words_for(256)) is not None
    finally:
        t1.close()
        t2.close()


def test_graph_cache_drops_entries_of_a_dead_table():
    """A fold that replaces a table frees its entries at once (their
    buffers and the columns they hold), not at LRU eviction."""
    t = _table()
    try:
        cache = GraphCache()
        kern = ResidentKernel(cache, autocompile=False, instances=3)
        ft = t._state.tiers[0].snap.fast
        kern.warm(ft, batch_buckets=(16, 128), window_buckets=(256,))
        assert cache.size() == 2 and cache.instances() == 6
        _fill(t, 300, 50, np.random.default_rng(5), prefix="n")
        assert t.compact()  # a fresh L0 replaces ft
        del ft
        gc.collect()
        assert cache.size() == 0 and cache.dropped == 2
    finally:
        t.close()


def test_busy_units_fall_back_and_count():
    """A hit whose units are all in flight returns None (submit launches
    B1 eagerly) and counts as busy; a released unit is taken again."""
    t = _table()
    try:
        ft = t._state.tiers[0].snap.fast
        kern = ResidentKernel(GraphCache(), autocompile=False, instances=2)
        kern.warm(ft, batch_buckets=(128,), window_buckets=(256,))
        mw = max_words_for(256)
        a = kern.lookup(ft, 256, 128, mw)
        b = kern.lookup(ft, 256, 128, mw)
        assert a is not None and b is not None and a is not b
        assert kern.lookup(ft, 256, 128, mw) is None
        assert (kern.hits, kern.busy) == (2, 1)
        a.release()
        assert kern.lookup(ft, 256, 128, mw) is a
    finally:
        t.close()


def test_miss_schedules_background_build():
    t = _table()
    try:
        ft = t._state.tiers[0].snap.fast
        cache = GraphCache()
        kern = ResidentKernel(cache, autocompile=True)
        mw = max_words_for(256)
        assert kern.lookup(ft, 256, 128, mw) is None
        _wait(lambda: cache.size() == 1, "the background build")
        unit = kern.lookup(ft, 256, 128, mw)
        assert unit is not None and (kern.hits, kern.misses) == (1, 1)
        unit.release()
    finally:
        t.close()


# -- differential --------------------------------------------------------------


def test_resident_matches_fused_host_and_reference():
    """Resident answers == fused == forced host chunks == the reference's
    resident route, across tiers, overlay, tombstones and owner
    filters, with the device tiers really served by cache units."""
    rng = np.random.default_rng(23)
    port = DarTable(device="cpu", delta_capacity=256, idle_fold_s=0)
    ref = RefDarTable(delta_capacity=256, idle_fold_s=0)
    try:
        for t in (port, ref):
            r = np.random.default_rng(23)
            _fill(t, 400, 60, r)
            t.fold()
            _fill(t, 80, 60, r, prefix="late")
            for i in range(0, 40, 7):
                t.remove(f"e{i}")
        b = 200  # past the 64-query host cutoff: device tiers
        args = _query_args(rng, b, 60)
        owners = np.where(np.arange(b) % 3 == 0, np.arange(b) % 5,
                          -1).astype(np.int32)
        kern = ResidentKernel(GraphCache(), autocompile=False)
        ref_kern = ref_resident.ResidentKernel(ref_resident.AotCache(),
                                               autocompile=False)
        grid = dict(batch_buckets=(256,),
                    window_buckets=(256, 512, 1024, 2048, 4096))
        assert port.warm_resident(kern, **grid) >= 1
        ref.warm_resident(ref_kern, **grid)
        fused = port.query_many(*args, now=NOW, owner_ids=owners)
        host = port.query_many(*args, now=NOW, owner_ids=owners,
                               host_route=True)
        res = port.query_many(*args, now=NOW, owner_ids=owners, kernel=kern)
        want = ref.query_many(*args, now=NOW, owner_ids=owners,
                              kernel=ref_kern)
        assert res == fused == host == want
        assert kern.hits >= 1 and ref_kern.hits >= 1
    finally:
        port.close()
        ref.close()


def test_overflow_retry_keeps_the_selector_and_stays_exact():
    t = DarTable(device="cpu", idle_fold_s=0)
    for i in range(500):
        t.upsert(f"e{i}", np.asarray([i % 3], np.int32), 0.0, 100.0,
                 NOW - HOUR, NOW + HOUR, 0)
    t.fold()
    try:
        ft = t._state.tiers[0].snap.fast
        kern = ResidentKernel(GraphCache(), autocompile=False)
        b = 96
        args = (np.tile(np.asarray([0, 1, 2], np.int32), (b, 1)),
                np.zeros(b, np.float32), np.full(b, 200.0, np.float32),
                np.full(b, NOW - HOUR, np.int64),
                np.full(b, NOW + HOUR, np.int64))
        pend = ft.submit(*args, now=NOW, max_words=16, kernel=kern)
        assert pend is not None and pend.kernel is kern
        qidx, slots = ft.collect(pend)
        ref_q, ref_s = ft.query_fused(*args, now=NOW)
        np.testing.assert_array_equal(qidx, ref_q)
        np.testing.assert_array_equal(slots, ref_s)
        assert kern.misses == 2  # the first bucket, then the hard bound
    finally:
        t.close()


def test_results_are_never_aliased():
    """A replay unit's static output is reused by the next batch in its
    bucket: a result collected from batch A must stay bit-stable (and
    correct) after batches B, C... ran through the same unit."""
    rng = np.random.default_rng(11)
    t = _table()
    try:
        ft = t._state.tiers[0].snap.fast
        kern = ResidentKernel(GraphCache(), autocompile=False, instances=1)
        kern.warm(ft, batch_buckets=(128,), window_buckets=(256, 512, 1024))
        b = 128
        a = _query_args(rng, b, 50)
        a_in = (_padded(a[0]),) + a[1:]
        qidx_a, slots_a = ft.collect(ft.submit(*a_in, now=NOW, kernel=kern))
        snap_q, snap_s = qidx_a.copy(), slots_a.copy()
        for seed in range(6):
            bq = _query_args(np.random.default_rng(100 + seed), b, 50)
            ft.collect(ft.submit(_padded(bq[0]), *bq[1:], now=NOW,
                                 kernel=kern))
        np.testing.assert_array_equal(qidx_a, snap_q)
        np.testing.assert_array_equal(slots_a, snap_s)
        ref_q, ref_s = ft.query_fused(*a_in, now=NOW)
        np.testing.assert_array_equal(qidx_a, ref_q)
        np.testing.assert_array_equal(slots_a, ref_s)
        assert kern.hits == 7 and kern.busy == 0
        assert ff.fused_window_filter.graph_replays == 0  # the CPU
    finally:
        t.close()


# -- the loop ------------------------------------------------------------------


class _GatedTable:
    """DarTable wrapper whose submit blocks until the gate opens;
    `submits` counts the submits entered."""

    def __init__(self, table):
        self._table = table
        self.gate = threading.Event()
        self.submits = 0

    def query_many_submit(self, *a, **kw):
        self.submits += 1
        self.gate.wait(WAIT_S)
        return self._table.query_many_submit(*a, **kw)

    def query_many_collect(self, pq):
        return self._table.query_many_collect(pq)

    def set_resident_warm(self, fn):
        pass


def _payload(keys=(3,)):
    return (
        [np.asarray(keys, np.int32)],
        np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32),
        np.full(1, NOW - HOUR, np.int64), np.full(1, NOW + HOUR, np.int64),
        np.full(1, NOW, np.int64), np.full(1, -1, np.int32),
    )


def _one_entity_table():
    inner = DarTable(device="cpu", idle_fold_s=0)
    inner.upsert("e0", np.asarray([3], np.int32), None, None,
                 NOW - HOUR, NOW + HOUR, 0)
    return inner


def test_loop_ring_backpressure_and_delivery():
    """Ring of 2, one batch in flight: the wait is for the feeder to be
    inside its first submit (the ring empty again), not for a nonzero
    ring depth, which the first enqueue shows before the feeder has
    taken it; then two more fill the ring and a fourth is rejected."""
    inner = _one_entity_table()
    gated = _GatedTable(inner)
    loop = ResidentLoop(gated, ring_capacity=2, max_inflight=1)
    got = []
    ev = threading.Event()

    def done(results, err, gap_ms, lat_ms, used_device):
        got.append((results, err))
        if len(got) == 3:
            ev.set()

    try:
        assert loop.enqueue(_payload(), done)
        _wait(lambda: gated.submits == 1 and loop.stats()["ring_depth"] == 0,
              "the feeder inside its first submit")
        assert loop.enqueue(_payload(), done)
        assert loop.enqueue(_payload(), done)
        assert not loop.enqueue(_payload(), done)
        st = loop.stats()
        assert (st["rejected"], st["ring_depth"], st["enqueued"]) == (1, 2, 3)
        gated.gate.set()
        assert ev.wait(WAIT_S)
        assert all(err is None for _, err in got)
        assert all(res == [["e0"]] for res, _ in got)
        assert loop.stats()["submitted"] == 3
    finally:
        gated.gate.set()
        loop.close()
        inner.close()


def test_loop_close_drains_queued_ring():
    inner = _one_entity_table()
    gated = _GatedTable(inner)
    loop = ResidentLoop(gated, ring_capacity=8, max_inflight=1)
    got = []

    def done(results, err, gap_ms, lat_ms, used_device):
        got.append((results, err))

    try:
        for _ in range(4):
            assert loop.enqueue(_payload(), done)
        _wait(lambda: gated.submits == 1 and loop.stats()["ring_depth"] == 3,
              "three batches queued behind the first")
        closer = threading.Thread(target=loop.close)
        closer.start()
        time.sleep(0.05)
        gated.gate.set()
        closer.join(WAIT_S)
        assert not closer.is_alive()
        assert len(got) == 4 and all(err is None for _, err in got)
        assert loop.stats()["ring_depth"] == 0
        assert not loop._feeder.is_alive() and not loop._collector.is_alive()
        assert not loop.enqueue(_payload(), done)
    finally:
        gated.gate.set()
        loop.close()
        inner.close()


# -- through the coalescer -----------------------------------------------------


def test_coalescer_resident_route_counted_and_exact():
    """A burst through a resident-enabled coalescer rides the loop, as
    on the reference: answers equal the serial ones and the
    reference's, co_route_resident_batches > 0, no cold-device batch,
    and the cold floor keeps its seed."""
    rng = np.random.default_rng(7)
    cases = [np.unique(rng.integers(0, 50, 3).astype(np.int32))
             for _ in range(128)]
    kw = dict(min_batch=1, max_batch=256, inline=False, queue_depth=64,
              slo_ms=0.0, resident=True, est_floor_ms=10_000.0,
              est_res_floor_ms=0.05, est_chunk_ms=1e6)
    got = {}
    for side, mk_t, mk_co in (
            ("port", lambda: DarTable(device="cpu"), QueryCoalescer),
            ("ref", lambda: RefDarTable(), RefQueryCoalescer)):
        t = mk_t()
        _fill(t, 300, 50, np.random.default_rng(7))
        co = mk_co(t, **kw)
        try:
            assert co.resident_loop() is not None
            with ThreadPoolExecutor(max_workers=32) as pool:
                got[side] = list(pool.map(lambda k, co=co: co.query(k, now=NOW),
                                          cases, timeout=WAIT_S))
            assert got[side] == [t.query(k, now=NOW) for k in cases]
            _wait(lambda co=co: co.stats()["co_inflight"] == 0, "the drain")
            st = co.stats()
            assert st["co_route_resident_batches"] >= 1
            assert st["co_route_device_batches"] == 0
            assert st["co_est_device_floor_ms"] == 10_000.0
            assert st["co_res_enqueued"] >= 1
        finally:
            co.close()
            t.close()
    assert got["port"] == got["ref"]


def test_coalescer_close_resolves_resident_queued_callers():
    inner = _one_entity_table()
    gated = _GatedTable(inner)
    co = QueryCoalescer(gated, min_batch=1, inline=False, queue_depth=64,
                        slo_ms=0.0, resident=True, est_floor_ms=10_000.0,
                        est_res_floor_ms=0.05, est_chunk_ms=1e6)
    results = []
    ths = [threading.Thread(target=lambda: results.append(
        co.query(np.asarray([3], np.int32), now=NOW))) for _ in range(5)]
    try:
        for th in ths:
            th.start()
            time.sleep(0.02)
        _wait(lambda: gated.submits >= 1, "the first resident submit")
        closer = threading.Thread(target=co.close)
        closer.start()
        time.sleep(0.05)
        gated.gate.set()
        closer.join(WAIT_S)
        for th in ths:
            th.join(WAIT_S)
        assert results == [["e0"]] * 5
    finally:
        gated.gate.set()
        co.close()
        inner.close()


def test_configure_toggles_resident_loop_and_fold_hook():
    t = _table()
    co = QueryCoalescer(t)
    try:
        assert co.resident_loop() is None and t._resident_warm is None
        assert co.stats()["co_res_ring_cap"] == 0
        co.configure(resident=True)
        loop = co.resident_loop()
        assert loop is not None and co.stats()["co_res_ring_cap"] > 0
        assert loop.kernel.instances == 4 + 2
        assert t._resident_warm is not None
        co.configure(resident=False)
        assert co.resident_loop() is None
    finally:
        co.close()
        t.close()


# -- a store's warm grid against the cache's bound ------------------------------


def _warm_a_five_class_store(cache):
    """Warm a 5-class, two-tier-per-class store twice and look up its
    grid; returns the cache tokens of its tables."""
    from dss_tpu_torch.dar.dss_store import DSSStore

    store = DSSStore(storage="cuda", device="cpu")
    try:
        store.configure_serving(resident=True)
        tables = []
        for i, (index, _) in enumerate(store._class_indexes()):
            t = index.table
            rng = np.random.default_rng(40 + i)
            _fill(t, 300, 50, rng, prefix="a")
            assert t.compact()
            _fill(t, 40, 50, rng, prefix="b")
            assert t.fold()
            tiers = [tier.snap.fast for tier in t._state.tiers]
            assert len(tiers) == 2
            tables += tiers
        grid = [(wb, bb) for bb in resident.batch_bucket_grid()
                for wb in resident.window_bucket_grid()]
        evictions = cache.evictions
        assert store.warm_resident() == len(tables) * len(grid) == 160
        assert cache.evictions == evictions
        assert cache.cap() >= 160 + resident.MISS_HEADROOM
        assert store.warm_resident() == 0
        kern = ResidentKernel(cache, autocompile=False)
        for ft in tables:
            for wb, bb in grid:
                unit = kern.lookup(ft, wb, bb, max_words_for(wb))
                assert unit is not None, (wb, bb)
                unit.release()
        assert (kern.hits, kern.misses, kern.busy) == (160, 0, 0)
        assert cache.capture_failures == 0
        # the reference keys by block count: its grid is no larger
        ref_n = resident.reference_grid_entries(tables)
        assert ref_n % len(grid) == 0 and ref_n <= 160
        return {cache.key_for(ft, 256, 16, 1 << 16)[0] for ft in tables}
    finally:
        store.close()


def test_store_warm_grid_survives_its_own_warm(monkeypatch):
    """A 5-class store with two tiers per class warms more entries than
    DSS_RES_AOT_CAP's default 128: the warm reserves its keys, so none
    is evicted, a second warm builds nothing, and every bucket of every
    tier then hits.  The reference's grid for the same tables (one
    entry per block count) is counted beside it.  The reservations go
    with the tables."""
    monkeypatch.delenv("DSS_RES_AOT_CAP", raising=False)
    monkeypatch.setenv("DSS_RES_BATCH_BUCKETS",
                       "16,32,64,128,512,1024,2048,4096")
    monkeypatch.setenv("DSS_RES_WINDOW_BUCKETS", "256,1024")
    monkeypatch.setenv("DSS_CO_RES_INFLIGHT", "1")  # 3 units an entry
    cache = resident._CACHE
    assert cache._max == 128
    toks = _warm_a_five_class_store(cache)
    gc.collect()
    assert not any(k[0] in toks for k in cache._reserved)
    assert not any(k[0] in toks for k in cache._entries)

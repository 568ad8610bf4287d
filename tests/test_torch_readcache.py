"""The port's version-fenced read cache against the reference's.

The scenarios of tests/test_readcache.py run on both packages: the
ReadCache and CellClock units on the same call sequences, and the
store-level scenarios (repeat polls, fence invalidation by writes and
deletes, disjoint writes, expiry re-filtering, owner scope, covering
canonicalization, the cache toggle, reset_state) on the reference's
store and the port's `memory` and `cuda`-on-CPU stores, cache on and
cache off.  Every answer and every cache counter after every step must
be equal.  A hit must not touch the port's coalescer either.
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import timedelta

import numpy as np
import pytest

from dss_tpu.dar import readcache as r_rcache
from dss_tpu.dar.tiers import CellClock as RCellClock
from dss_tpu.geo.covering import canonical_cells as r_canonical
from dss_tpu.geo.s2cell import dar_key_to_cell as r_dar_key_to_cell
from dss_tpu_torch.dar import readcache as p_rcache
from dss_tpu_torch.dar.tiers import CellClock as PCellClock
from dss_tpu_torch.geo.covering import canonical_cells as p_canonical
from dss_tpu_torch.geo.s2cell import dar_key_to_cell as p_dar_key_to_cell
from tests.test_torch_store_contract import PORT, REF, T0, norm

# -- units on the same call sequences -----------------------------------------


def cell_clock_log(CellClock):
    c = CellClock()
    out = []
    keys = np.arange(5, dtype=np.int32)
    out.append(c.fence(keys)[1:])
    c.bump(np.asarray([1, 2], np.int32))
    out.append(c.fence(keys)[1:])
    out.append(c.fence(np.asarray([3, 4], np.int32))[1:])
    c.bump(np.asarray([3], np.int32), np.asarray([4], np.int32))
    out.append(c.fence(np.asarray([3], np.int32))[1:])
    out.append(c.fence(np.asarray([4], np.int32))[1:])
    out.append((c.high_water, c.generation))
    c.bump_all()
    out.append(c.fence(np.asarray([99], np.int32))[1:])
    out.append((c.high_water, c.generation))
    out.append(CellClock().incarnation != CellClock().incarnation)
    return out


def test_cell_clock_equals_reference():
    assert cell_clock_log(PCellClock) == cell_clock_log(RCellClock)


def read_cache_log(rc_mod):
    out = []
    rc = rc_mod.ReadCache(capacity=4, shards=1)
    for i in range(8):
        rc.insert("isa", ("k", i), (1, 0, 0, 0), "", 0, [f"id{i}"], [10])
    out.append(rc.stats())
    rc = rc_mod.ReadCache(enabled=False)
    rc.insert("isa", "k", (1, 0, 0, 0), "", 0, ["a"], [10])
    out += [rc.lookup("isa", "k", (1, 0, 0, 0), "", 0), rc.stats()]
    rc = rc_mod.ReadCache()
    rc.insert("isa", "k", (1, 0, 0, 0), "", 0, ["a"], [10])
    rc.configure(enabled=False)
    rc.configure(enabled=True)
    out += [rc.lookup("isa", "k", (1, 0, 0, 0), "", 0), rc.stats()]
    # fence rejections: epoch, incarnation, one cell's clock
    for fence, epoch in (((1, 5, 5, 0), "epoch-b"), ((2, 5, 5, 0), "a"),
                         ((1, 6, 6, 0), "a")):
        rc = rc_mod.ReadCache()
        rc.insert("isa", "k", (1, 5, 5, 0), "a", 0, ["a"], [10])
        out += [rc.lookup("isa", "k", fence, epoch, 0), rc.stats()]
    # the stale lag, and a floor no lag crosses
    rc = rc_mod.ReadCache(stale_lag=2)
    rc.insert("isa", "k", (1, 5, 5, 0), "", 0, ["a"], [10])
    out.append(rc.lookup("isa", "k", (1, 6, 6, 0), "", 0))
    rc.insert("isa", "k", (1, 5, 5, 0), "", 0, ["a"], [10])
    out.append(rc.lookup("isa", "k", (1, 6, 7, 0), "", 0, allow_stale=True))
    out.append(rc.lookup("isa", "k", (1, 9, 8, 0), "", 0, allow_stale=True))
    rc = rc_mod.ReadCache(stale_lag=100)
    rc.insert("isa", "k", (1, 5, 5, 0), "", 0, ["a"], [10])
    out.append(rc.lookup("isa", "k", (1, 6, 6, 0), "", 0, allow_stale=True))
    rc.insert("isa", "k", (1, 5, 5, 0), "", 0, ["a"], [10])
    out.append(rc.lookup("isa", "k", (1, 6, 6, 6), "", 0, allow_stale=True))
    out.append(rc.stats())
    # time only expires records out of an entry, never resurrects them
    rc = rc_mod.ReadCache()
    rc.insert("isa", "k", (1, 0, 0, 0), "", 100, ["a", "b", "c"],
              [150, 200, 300])
    for now in (100, 180, 50):
        out.append(rc.lookup("isa", "k", (1, 0, 0, 0), "", now))
    rc.insert("isa", "k", (1, 0, 0, 0), "", 50, ["a", "b", "c", "z"],
              [150, 200, 300, 60])
    out += [rc.lookup("isa", "k", (1, 0, 0, 0), "", 180), rc.stats(),
            rc.class_stats("isa"), rc.class_stats("op")]
    return out


def test_read_cache_unit_equals_reference():
    assert read_cache_log(p_rcache) == read_cache_log(r_rcache)


def test_env_knobs_equal_reference(monkeypatch):
    assert p_rcache.env_knobs() == r_rcache.env_knobs()
    for k, v in (("DSS_CACHE_CAP", "17"), ("DSS_CACHE_SHARDS", "3"),
                 ("DSS_CACHE_STALE_LAG", "2"), ("DSS_CACHE_ENABLE", "0")):
        monkeypatch.setenv(k, v)
    assert p_rcache.env_knobs() == r_rcache.env_knobs()
    monkeypatch.setenv("DSS_CACHE_ENABLE", "maybe")
    for mod in (r_rcache, p_rcache):
        with pytest.raises(ValueError, match="DSS_CACHE_ENABLE"):
            mod.env_knobs()


def test_canonical_cells_equal_reference():
    rng = np.random.default_rng(3)
    for a in (np.asarray([3, 1, 2, 2], np.uint64),
              rng.integers(0, 2**63, 50, dtype=np.uint64),
              np.asarray([], np.uint64)):
        assert p_canonical(a).tolist() == r_canonical(a).tolist()
    srt = np.asarray([1, 2, 3], np.uint64)
    assert np.shares_memory(p_canonical(srt), srt)


def notes_log(mod):
    mod.take_note()
    mod.note_search("isa", "e", 4, True)
    out = [mod.take_note(), mod.take_note()]
    mod.note_mesh_served()
    out += [mod.take_mesh_served(), mod.take_mesh_served()]
    mod.note_last_search_meshed(True)
    out += [mod.take_last_search_meshed(), mod.take_last_search_meshed()]
    return out


def test_freshness_notes_equal_reference():
    log = notes_log(p_rcache)
    assert log == notes_log(r_rcache)
    assert log[0]["hit"] is True and log[1] is None


# -- store-level scenarios ------------------------------------------------------


def _uuid(i: int) -> str:
    return str(uuid.UUID(int=i, version=4))


class Poll:
    """One package's store for the cache scenarios: every observed
    answer is logged with the cache counters right after it."""

    def __init__(self, p, backend, cache):
        self.p = p
        kw = {"device": "cpu"} if p is PORT and backend == "cuda" else {}
        storage = backend if p is PORT else (
            "tpu" if backend == "cuda" else "memory")
        self.clock = p.FakeClock(T0)
        self.store = p.Store(storage=storage, clock=self.clock, **kw)
        self.store.configure_serving(cache=cache)
        self.key_to_cell = (
            p_dar_key_to_cell if p is PORT else r_dar_key_to_cell
        )
        self.log = []

    def cells(self, lo, hi):
        return self.key_to_cell(np.arange(lo, hi, dtype=np.int64))

    def isa(self, i, cells, *, end=None, owner="u1"):
        return self.p.ridm.IdentificationServiceArea(
            id=_uuid(i), owner=owner, url="https://uss.example/f",
            cells=np.asarray(cells, np.uint64), start_time=T0,
            end_time=end or (T0 + timedelta(hours=12)),
            altitude_lo=0.0, altitude_hi=3000.0,
        )

    def see(self, out):
        self.log.append((norm(self.p, out), self.store.cache.stats()))
        return out


def repeat_poll_and_write_fences(w):
    s = w.store
    cells = w.cells(100, 140)
    w.see(s.rid.insert_isa(w.isa(1, cells)))
    w.see(s.rid.insert_isa(w.isa(2, cells[:10])))
    e = T0 + timedelta(minutes=5)
    for _ in range(2):
        w.see(s.rid.search_isas(cells, e, None))
    # a write touching ONE cell of the covering invalidates the line
    w.see(s.rid.insert_isa(w.isa(3, cells[-1:])))
    for _ in range(2):
        w.see(s.rid.search_isas(cells, e, None))
    # a disjoint write keeps it
    w.see(s.rid.insert_isa(w.isa(4, w.cells(9000, 9010))))
    w.see(s.rid.search_isas(cells, e, None))
    # a delete is fenced like any write
    a = s.rid.get_isa(_uuid(3))
    w.see(s.rid.delete_isa(dataclasses.replace(a, owner="u1")))
    w.see(s.rid.search_isas(cells, e, None))


def advancing_earliest_and_expiry(w):
    s = w.store
    cells = w.cells(700, 732)
    w.see(s.rid.insert_isa(w.isa(81, cells)))
    w.see(s.rid.insert_isa(w.isa(82, cells,
                                 end=T0 + timedelta(minutes=10))))
    w.see(s.rid.search_isas(cells, T0 + timedelta(minutes=5), None))
    e1 = T0 + timedelta(minutes=15)
    w.see(s.rid.search_isas(cells, e1, None))
    w.see(s.rid.search_isas(cells, e1, T0 + timedelta(hours=24)))


def scd_wallclock_expiry(w):
    s = w.store
    cells = w.cells(600, 616)
    op = w.p.scdm.Operation(
        id=_uuid(10), owner="u1", version=0, start_time=T0,
        end_time=T0 + timedelta(minutes=30), altitude_lower=0.0,
        altitude_upper=100.0, cells=cells, uss_base_url="https://u",
        subscription_id=_uuid(99), state="Accepted",
    )
    w.see(s.scd.upsert_operation(op, [], key_checked=True))
    for _ in range(2):
        w.see(s.scd.search_operations(cells, None, None, None, None))
    w.clock.advance(minutes=45)
    w.see(s.scd.search_operations(cells, None, None, None, None))
    s.configure_serving(cache=False)
    w.see(s.scd.search_operations(cells, None, None, None, None))


def owner_scope_and_canonical_covering(w):
    s = w.store
    cells = w.cells(700, 716)
    w.see(s.rid.insert_subscription(w.p.ridm.Subscription(
        id=_uuid(11), owner="alice", url="https://a", cells=cells,
        start_time=T0, end_time=T0 + timedelta(hours=1),
    )))
    for _ in range(2):
        w.see(s.rid.search_subscriptions_by_owner(cells, "alice"))
        w.see(s.rid.search_subscriptions_by_owner(cells, "bob"))
    w.see(s.rid.insert_isa(w.isa(12, cells)))
    e = T0 + timedelta(minutes=5)
    for c in (cells, cells[::-1].copy(),
              np.concatenate([cells, cells[:4]])):
        w.see(s.rid.search_isas(c, e, None))


def toggle_and_reset(w):
    s = w.store
    cells = w.cells(900, 916)
    w.see(s.rid.insert_isa(w.isa(13, cells)))
    e = T0 + timedelta(minutes=5)
    w.see(s.rid.search_isas(cells, e, None))
    s.configure_serving(cache=False)
    w.see(s.rid.search_isas(cells, e, None))
    s.configure_serving(cache=True)
    for _ in range(2):
        w.see(s.rid.search_isas(cells, e, None))
    s.rid.reset_state()
    w.see(s.rid.search_isas(cells, e, None))


SCENARIOS = [
    repeat_poll_and_write_fences,
    advancing_earliest_and_expiry,
    scd_wallclock_expiry,
    owner_scope_and_canonical_covering,
    toggle_and_reset,
]


@pytest.mark.parametrize("cache", [True, False], ids=["cache_on", "cache_off"])
@pytest.mark.parametrize("backend", ["memory", "cuda"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_cache_scenario_equals_reference(scenario, backend, cache):
    ref, port = Poll(REF, backend, cache), Poll(PORT, backend, cache)
    try:
        scenario(ref)
        scenario(port)
        assert port.log == ref.log
        if cache:
            assert port.store.cache.stats()["hits"] > 0
    finally:
        ref.store.close()
        port.store.close()


def test_hit_performs_zero_coalescer_enqueues():
    w = Poll(PORT, "cuda", True)
    s = w.store
    try:
        cells = w.cells(1100, 1132)
        s.rid.insert_isa(w.isa(15, cells))
        e = T0 + timedelta(minutes=5)
        s.rid.search_isas(cells, e, None)  # populate (fresh path)

        def co_counters():
            return {
                k: v for k, v in s.stats().items()
                if k.endswith(("co_batches", "co_items", "co_inline",
                               "co_route_device_batches"))
            }

        pre, c0 = co_counters(), s.cache.stats()
        got = s.rid.search_isas(cells, e, None)
        assert [x.id for x in got] == [_uuid(15)]
        assert s.cache.stats()["hits"] == c0["hits"] + 1
        assert co_counters() == pre
        assert s.stats()["dss_dar_isa_co_cache_hits"] >= 1
    finally:
        s.close()


def test_reset_retires_swapped_out_indexes_and_close_ends_them():
    """A state reset (a region resync's) swaps every index out: the old
    index's folder stops at once, a reader that took the old index
    before the swap still gets its answer, and the store's close
    closes the old indexes, so none of their threads outlives it.  The
    reference drops them with their folders still running."""
    w = Poll(PORT, "cuda", True)
    s = w.store
    try:
        cells = w.cells(1300, 1316)
        s.rid.insert_isa(w.isa(21, cells))
        old = s.rid._isa_index
        old.table._ensure_folder()
        folder = old.table._fold_thread
        assert folder.is_alive()
        s.rid.reset_state()
        assert s.rid._isa_index is not old and old in s.rid._retired
        folder.join(10)
        assert not folder.is_alive()
        keys = np.asarray(cells, np.uint64)
        assert old.query_ids(keys, now=0) == [_uuid(21)]
        assert s.rid._isa_index.query_ids(keys, now=0) == []
    finally:
        s.close()
    assert s.rid._retired == () and s.scd._retired == ()
    co = old.coalescer
    assert co._closed
    assert not any(th is not None and th.is_alive()
                   for th in (co._pack_thread, co._collect_thread))

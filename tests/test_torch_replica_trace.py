"""The phase spans and counters inside the port's mesh replica route
(parallel/replica.py, parallel/sharded.py): with tracing off nothing is
recorded and nothing allocated, with it on flat spans in code order
cover a `ShardedReplica.query_batch` call, the served counters equal a
direct count, and the coalescer's mesh route shows the phases under its
`mesh` span.

The replica holds a base tier, a delta tier and shadowed base ids: it
is built on 2x2 CPU positions, some of its base records then updated
(shadowed and re-written to the delta), some deleted and some added,
and refreshed without a major rebuild.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from dss_tpu_torch.dar import coalesce, oracle
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.obs import trace
from dss_tpu_torch.parallel import make_mesh
from dss_tpu_torch.parallel.mesh import virtual_devices
from dss_tpu_torch.parallel.replica import ShardedReplica

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
TIER = ("mesh.pad", "mesh.launch", "mesh.wait", "mesh.decode",
        "replica.ids")
PHASES = ("replica.pad",) + TIER + TIER + ("replica.sort", "replica.load")


@pytest.fixture(autouse=True)
def _trace_off():
    """Tracing off with a fresh recorder before and after (other tests
    rely on the zero-cost default)."""
    trace.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                    max_pending=1024)
    yield
    trace.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                    max_pending=1024)


def _record(rng, eid: str) -> Record:
    lo = float(rng.uniform(0, 2000))
    t0 = NOW + int(rng.integers(-2, 2)) * HOUR
    return Record(eid, np.unique(rng.integers(0, 40, 4)).astype(np.int32),
                  lo, lo + 500.0, t0, t0 + 2 * HOUR, 0)


@pytest.fixture
def replica(tmp_path):
    rng = np.random.default_rng(20)
    wal = tmp_path / "dss.wal"
    wal.touch()
    rep = ShardedReplica(
        make_mesh(4, dp=2, sp=2, devices=virtual_devices("cpu", 4)),
        wal_path=str(wal), max_results=64, tier_ratio=10.0)
    with rep._mu:
        for i in range(300):
            rep._put("ops", _record(rng, f"b{i}"))
    rep.refresh(plan=False)
    with rep._mu:
        for i in range(0, 300, 7):
            rep._put("ops", _record(rng, f"b{i}"))  # shadowed, re-written
        for i in range(3, 300, 11):
            rep._del("ops", f"b{i}")
        for i in range(40):
            rep._put("ops", _record(rng, f"d{i}"))
    rep.refresh(plan=False)
    snap = rep._snapshots["ops"]
    assert snap.base is not None and snap.delta is not None and snap.shadow
    yield rep
    rep.close()


def _batch(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    keys = [np.unique(rng.integers(0, 40, 6)).astype(np.int32)
            for _ in range(n)]
    lo = rng.uniform(0, 2500, n).astype(np.float32)
    return (keys, lo, lo + np.float32(400.0),
            np.full(n, NOW - HOUR, np.int64),
            np.full(n, NOW + HOUR, np.int64))


def _query(rep, batch):
    return rep.query_batch(*batch, now=NOW, cls="ops")


def test_tracing_off_records_nothing_and_answers_alike(replica):
    batch = _batch(1)
    off = _query(replica, batch)
    assert trace.stats()["dss_trace_allocs_total"] == 0
    assert trace.stats()["dss_trace_started_total"] == 0
    assert trace.recorder().traces() == []
    trace.configure(sample=1.0)
    tok = trace.begin_collect(TRACE_ID)
    try:
        on = _query(replica, batch)
    finally:
        spans = trace.end_collect(tok)
    assert spans and on == off
    assert trace.stats()["dss_trace_allocs_total"] == 0
    assert off == replica.query_batch_host(*batch, now=NOW, cls="ops")
    assert any(off)


def test_phase_spans_are_flat_in_order_and_inside_the_call(replica):
    trace.configure(sample=1.0)
    tok = trace.begin_collect(TRACE_ID)
    try:
        t0 = time.time_ns()
        rows = _query(replica, _batch(2))
        t1 = time.time_ns()
    finally:
        spans = trace.end_collect(tok)
    assert tuple(s[2] for s in spans) == PHASES
    root = spans[0][1]
    assert all(s[1] == root for s in spans)  # flat: one parent
    # the recorder keeps durations to the microsecond
    slack = 1000
    ends = [s[3] + int(s[4] * 1e6) for s in spans]
    assert t0 <= spans[0][3] and ends[-1] <= t1 + slack
    for (_, _, _, start, _, _), end_prev in zip(spans[1:], ends):
        assert start >= end_prev - slack
    tiers = [s[5]["tier"] for s in spans if s[2] in TIER]
    assert tiers == ["base"] * 5 + ["delta"] * 5
    attrs = {s[2]: s[5] for s in spans}
    assert attrs["replica.pad"] == {"queries": 24}
    decode = [s[5] for s in spans if s[2] == "mesh.decode"]
    ids = [s[5] for s in spans if s[2] == "replica.ids"]
    assert [d["hits"] for d in decode] == [i["hits"] for i in ids]
    assert [d["queries"] for d in decode] == [24, 24]
    # some searches pass max_results and take the exact host fallback
    assert sum(d["overflow_fallbacks"] for d in decode) == (
        replica.stats()["replica_ops_overflow_fallbacks"]) > 0
    assert ids[1]["shadow_drops"] == 0 and ids[0]["shadow_drops"] > 0
    assert sum(map(len, rows)) == sum(
        i["hits"] - i["shadow_drops"] for i in ids)


def test_served_counters_equal_a_direct_count(replica):
    snap = replica._snapshots["ops"]
    want = [0, 0, 0]
    for seed in (3, 4, 5):
        batch = _batch(seed)
        _query(replica, batch)
        keys, lo, hi, ts, te = batch
        for i, k in enumerate(keys):
            want[0] += 1
            for dar, ids, drop in ((snap.base, snap.base_ids, snap.shadow),
                                   (snap.delta, snap.delta_ids, ())):
                slots = oracle.search(dar.records, k, float(lo[i]),
                                      float(hi[i]), int(ts[i]), int(te[i]),
                                      NOW)
                want[1] += len(slots)
                want[2] += sum(ids[s] in drop for s in slots)
    st = replica.stats()
    assert want[2] > 0
    assert [st["replica_ops_queries"], st["replica_ops_hits"],
            st["replica_ops_shadow_drops"]] == want
    assert st["replica_isas_queries"] == st["replica_isas_hits"] == 0


def test_served_counters_lose_no_update_across_threads(replica):
    batch = _batch(6, n=4)
    _query(replica, batch)
    one = replica.stats()  # the counts of one call
    calls, threads = 5, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(
            target=lambda: [_query(replica, batch) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    st = replica.stats()
    assert one["replica_ops_hits"] > 0
    for k in ("queries", "hits", "shadow_drops"):
        key = f"replica_ops_{k}"
        assert st[key] == one[key] * (calls * threads + 1), key


def test_coalescer_mesh_span_holds_the_phase_spans(replica):
    table = DarTable(device="cpu", idle_fold_s=0)
    co = coalesce.QueryCoalescer(table)
    co.set_mesh_delegate(
        lambda *a: replica.query_batch(*a[:5], now=a[5], cls="ops"),
        lambda: True, min_batch=1)
    keys, lo, hi, ts, te = _batch(7, n=1)
    try:
        untraced = co.query(keys[0], float(lo[0]), float(hi[0]), int(ts[0]),
                            int(te[0]), now=NOW, allow_stale=True)
        assert trace.stats()["dss_trace_allocs_total"] == 0
        trace.configure(sample=1.0)
        ctx = trace.new_trace()
        with trace.use(trace.SpanHandle(ctx, ctx.root_span_id)):
            got = co.query(keys[0], float(lo[0]), float(hi[0]), int(ts[0]),
                           int(te[0]), now=NOW, allow_stale=True)
        trace.finish_root(ctx, "http GET /search", 9.0, status=200)
    finally:
        co.close()
        table.close()
    assert got == untraced and co.mesh_offloads == 2
    root = trace.recorder().find(ctx.trace_id)["root"]
    mesh = [c for c in root["children"] if c["name"] == "mesh"]
    assert len(mesh) == 1
    assert [c["name"] for c in mesh[0]["children"]] == list(PHASES)
    assert all(not c["children"] for c in mesh[0]["children"])

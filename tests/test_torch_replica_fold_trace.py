"""The spans and counters of the port's mesh replica on its write path
(parallel/replica.py, parallel/sharded.py): with tracing on, a sync
records `replica.poll`, `replica.plan` and one `replica.refresh` a
folded class, which holds its `ShardedDar`'s `dar.pack` and
`dar.upload` and the `replica.warm` after them, each inside the step
that ran it; `replica_fold_h2d_bytes` is the sum of the built dars'
`nbytes` and `replica_minor_fold_records` the records the minor folds
built; with tracing off nothing is recorded.

The replica tails a write-ahead log of op records on a virtual 1x2 mesh
of the CPU: a base of intents, then rounds of updates, inserts and
deletes, each followed by a sync and a traced search.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from dss_tpu_torch.clock import from_nanos
from dss_tpu_torch.dar import codec
from dss_tpu_torch.dar.wal import WriteAheadLog
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.models import scd
from dss_tpu_torch.obs import trace
from dss_tpu_torch.parallel import make_mesh
from dss_tpu_torch.parallel.mesh import virtual_devices
from dss_tpu_torch.parallel.replica import ShardedReplica

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
TRACE_ID = "0af7651916cd43dd8448eb211c80319d"
FOLD = ("dar.pack", "dar.upload", "replica.warm")


@pytest.fixture(autouse=True)
def _trace_off():
    """Tracing off with a fresh recorder before and after (other tests
    rely on the zero-cost default)."""
    trace.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                    max_pending=1024)
    yield
    trace.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                    max_pending=1024)


def _put(wal, rng, eid: str) -> None:
    lo = float(rng.integers(0, 2000))
    t0 = NOW + int(rng.integers(-2, 2)) * HOUR
    op = scd.Operation(
        id=eid, owner="uss1", version=1, start_time=from_nanos(t0),
        end_time=from_nanos(t0 + 2 * HOUR), altitude_lower=lo,
        altitude_upper=lo + 400.0,
        cells=s2cell.dar_key_to_cell(
            np.unique(rng.integers(0, 40, 4)).astype(np.int32)))
    wal.append({"t": "scd_op_put", "doc": codec.op_to_doc(op)})


def _round(wal, rng, k: int) -> None:
    """Updates of base intents and of an earlier insert, an insert and
    a delete."""
    for i in range(3):
        _put(wal, rng, f"b{(7 * k + i) % 200}")
    if k:
        _put(wal, rng, f"n{k - 1}")
    _put(wal, rng, f"n{k}")
    wal.append({"t": "scd_op_del", "id": f"b{100 + k}"})


@pytest.fixture
def replica(tmp_path):
    rng = np.random.default_rng(23)
    wal = WriteAheadLog(str(tmp_path / "dss.wal"))
    rep = ShardedReplica(
        make_mesh(2, dp=1, sp=2, devices=virtual_devices("cpu", 2)),
        wal_path=wal.path, max_results=64, tier_ratio=0.5,
        warm_batches=(1, 8), move_interval_s=0.0)
    for i in range(200):
        _put(wal, rng, f"b{i}")
    rep.sync()
    yield rep, wal, rng
    rep.close()
    wal.close()


def _batch(seed: int, n: int = 16):
    rng = np.random.default_rng(seed)
    keys = [np.unique(rng.integers(0, 40, 6)).astype(np.int32)
            for _ in range(n)]
    lo = rng.uniform(0, 2500, n).astype(np.float32)
    return (keys, lo, lo + np.float32(400.0),
            np.full(n, NOW - HOUR, np.int64),
            np.full(n, NOW + HOUR, np.int64))


def _collect(call):
    """call() in collect mode -> (wall ns before, after, its spans)."""
    tok = trace.begin_collect(TRACE_ID)
    try:
        t0 = time.time_ns()
        call()
        t1 = time.time_ns()
    finally:
        spans = trace.end_collect(tok)
    return t0, t1, spans


def test_fold_spans_nest_inside_the_sync_that_ran_them(replica):
    rep, wal, rng = replica
    rep.query_batch(*_batch(1), now=NOW)  # load for the plan to scan
    _round(wal, rng, 0)
    trace.configure(sample=1.0)
    t0, t1, spans = _collect(rep.sync)
    q0, q1, query = _collect(
        lambda: rep.query_batch(*_batch(2), now=NOW, cls="ops"))
    # the recorder keeps durations to the microsecond
    slack = 1000
    for a, b, got in ((t0, t1, spans), (q0, q1, query)):
        for s in got:
            assert a <= s[3] and s[3] + int(s[4] * 1e6) <= b + slack
    root = spans[0][1]
    top = [s for s in spans if s[1] == root]
    assert [s[2] for s in top] == ["replica.poll", "replica.plan",
                                   "replica.refresh"]
    poll, _, fold = top
    assert poll[5] == {"records": 5, "errors": 0}
    snap = rep._snapshots["ops"]
    assert fold[5] == {"cls": "ops", "major": 0,
                       "records": len(snap.delta_ids),
                       "bytes": snap.delta.nbytes}
    inner = [s for s in spans if s[1] == fold[0]]
    assert [s[2] for s in inner] == list(FOLD)
    # each inside the fold, in order
    end = fold[3]
    for s in inner:
        assert s[3] >= end - slack
        end = s[3] + int(s[4] * 1e6)
    assert end <= fold[3] + int(fold[4] * 1e6) + slack
    # the warm-up's searches record their own phases under replica.warm
    warm = inner[2][0]
    assert {s[2] for s in spans if s[1] == warm} >= {"mesh.launch"}
    assert len(spans) == 3 + 3 + sum(s[1] == warm for s in spans)
    # the search reads both tiers, tagged on its query phases
    tiers = {s[5]["tier"] for s in query if s[5] and "tier" in s[5]}
    assert tiers == {"base", "delta"}
    assert not {s[2] for s in query} & {"replica.refresh", "replica.poll"}


def test_plan_span_only_when_the_rate_limit_lets_the_scan_through(replica):
    rep, wal, rng = replica
    rep.query_batch(*_batch(3), now=NOW)
    rep.move_interval_s = 3600.0
    _round(wal, rng, 0)
    trace.configure(sample=1.0)
    _, _, spans = _collect(rep.sync)
    names = [s[2] for s in spans]
    assert "replica.plan" not in names and "replica.refresh" in names
    # a sync with nothing to fold records its poll alone
    _, _, spans = _collect(rep.sync)
    assert [s[2] for s in spans] == ["replica.poll"]
    assert spans[0][5] == {"records": 0, "errors": 0}


def test_fold_counters_equal_the_built_dars(replica):
    rep, wal, rng = replica
    snap = rep._snapshots["ops"]
    built, minor = [snap.base.nbytes], 0
    for k in range(4):
        _round(wal, rng, k)
        rep.sync()
        snap = rep._snapshots["ops"]
        built.append(snap.delta.nbytes)
        minor += len(snap.delta_ids)
    st = rep.stats()
    assert st["replica_delta_refreshes"] == 4
    assert st["replica_fold_h2d_bytes"] == sum(built) == (
        rep.device_bytes_built)
    assert st["replica_minor_fold_records"] == minor > 0


def test_poll_span_counts_records_that_fail_to_apply(replica):
    rep, wal, rng = replica
    _put(wal, rng, "n0")
    wal.append({"t": "scd_op_put", "doc": {"owner": "uss1"}})  # no id
    trace.configure(sample=1.0)
    _, _, spans = _collect(rep.poll_once)
    assert [(s[2], s[5]) for s in spans] == [
        ("replica.poll", {"records": 2, "errors": 1})]
    assert rep.stats()["replica_apply_errors"] == 1


def test_tracing_off_records_nothing_on_the_write_path(replica):
    rep, wal, rng = replica
    rep.query_batch(*_batch(4), now=NOW)
    _round(wal, rng, 0)
    _, _, spans = _collect(rep.sync)
    assert spans == []
    st = trace.stats()
    assert st["dss_trace_allocs_total"] == 0
    assert st["dss_trace_started_total"] == 0
    assert rep.stats()["replica_delta_refreshes"] == 1

"""The port's ShardedReplica under live filing: it tails a write-ahead
log of the store's op records (`scd_op_put` with `codec.op_to_doc`,
`scd_op_del`) through rounds of writes and `sync()`, and every answer
equals the reference's ShardedReplica (dss_tpu/parallel/replica.py)
tailing the same log and synced with it, and a plain brute-force 4D
test over the records the log holds, sorted id for sorted id.  After
every sync the two replicas' gauges agree too (their tiers, shadow sets
and folds), so the port cannot fold otherwise than the reference.

Each case loads a base of intents through the log (the first sync
folds them into the base tier), then writes and syncs: an update that
moves a base intent out of a search (its base copy still matches and is
dropped by the shadow set), a delete of a base intent, an update and a
delete of an intent that lives in the delta tier, an insert, a major
fold forced by a low tier ratio, and rounds of the benchmark's
stationary mix (updates of delta-resident intents, inserts, deletes of
the oldest insert), which leave the delta tier and the shadow set at
their sizes.  On virtual 1x1 and 1x2 meshes of the CPU.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.parallel import make_mesh as r_make_mesh
from dss_tpu.parallel import replica as rr
from tests.test_torch_replica import _same_stats

from dss_tpu_torch.clock import from_nanos
from dss_tpu_torch.dar import codec
from dss_tpu_torch.dar.wal import WriteAheadLog
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.models import scd
from dss_tpu_torch.parallel import make_mesh
from dss_tpu_torch.parallel.mesh import virtual_devices
from dss_tpu_torch.parallel.replica import ShardedReplica

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
BASE = 240  # intents loaded before the writes
CELLS = 40  # DAR keys 0..39


class Log:
    """The store's side: op records appended to a write-ahead log, and
    the records it holds (id -> keys, alt_lo, alt_hi, t_start, t_end)."""

    def __init__(self, path, seed: int):
        self.wal = WriteAheadLog(str(path))
        self.rng = np.random.default_rng(seed)
        self.live = {}

    def draw(self):
        r = self.rng
        keys = np.unique(r.integers(0, CELLS, 4)).astype(np.int32)
        lo = float(r.integers(0, 2000))
        t0 = NOW + int(r.integers(-3, 2)) * HOUR
        return keys, lo, lo + float(r.integers(100, 600)), t0, \
            t0 + int(r.integers(1, 4)) * HOUR

    def put(self, eid: str, rec=None) -> None:
        keys, lo, hi, t0, t1 = rec if rec is not None else self.draw()
        self.live[eid] = (keys, lo, hi, t0, t1)
        op = scd.Operation(
            id=eid, owner="uss1", version=1, ovn=f"ovn-{eid}",
            start_time=from_nanos(t0), end_time=from_nanos(t1),
            altitude_lower=lo, altitude_upper=hi,
            state=scd.OperationState.ACCEPTED,
            cells=s2cell.dar_key_to_cell(keys))
        self.wal.append({"t": "scd_op_put", "doc": codec.op_to_doc(op)})

    def delete(self, eid: str) -> None:
        del self.live[eid]
        self.wal.append({"t": "scd_op_del", "id": eid})

    def answer(self, keys, lo, hi, t0, t1) -> list:
        """The brute-force 4D test over the records the log holds."""
        return sorted(
            eid for eid, (k, a, b, s, e) in self.live.items()
            if np.intersect1d(k, keys).size and b >= lo and a <= hi
            and e >= t0 and s <= t1 and e >= NOW)


def _queries(seed: int, n: int = 32):
    r = np.random.default_rng(seed)
    keys = [np.unique(r.integers(0, CELLS, 6)).astype(np.int32)
            for _ in range(n)]
    lo = r.integers(0, 2500, n).astype(np.float32)
    return (keys, lo, lo + np.float32(500.0),
            np.full(n, NOW - HOUR, np.int64),
            np.full(n, NOW + HOUR, np.int64))


class Replicas:
    """The port's replica and the reference's on one log, synced
    together; everything else is the port's."""

    def __init__(self, port: ShardedReplica, ref):
        self.port, self.ref = port, ref

    def sync(self) -> None:
        self.port.sync()
        self.ref.sync()
        _same_stats(self.ref, self.port)

    def close(self) -> None:
        self.port.close()
        self.ref.close()

    def __getattr__(self, name):
        return getattr(self.port, name)


def _agree(rep: Replicas, log: Log, batch) -> list:
    got = rep.query_batch(*batch, now=NOW, cls="ops")
    assert got == rep.ref.query_batch(*batch, now=NOW, cls="ops")
    want = [log.answer(*q) for q in zip(*batch)]
    assert got == want
    return got


def _target(log: Log, eid: str):
    """A search that the intent `eid` answers."""
    keys, lo, hi, t0, t1 = log.live[eid]
    return ([keys], np.array([lo], np.float32), np.array([hi], np.float32),
            np.array([max(t0, NOW)], np.int64),
            np.array([max(t0, NOW)], np.int64))


@pytest.fixture(params=[(1, 1), (1, 2)], ids=["1x1", "1x2"])
def mesh(request):
    """(dp, sp): the replicas' mesh shape."""
    return request.param


def _loaded(tmp_path, mesh, tier_ratio: float = 0.25):
    """Both replicas tailing a log that holds BASE intents, folded into
    their base tiers by the first sync; the plan never moves a
    boundary."""
    log = Log(tmp_path / "dss.wal", seed=22)
    dp, sp = mesh
    kw = dict(wal_path=log.wal.path, max_results=64, tier_ratio=tier_ratio,
              move_interval_s=3600.0)
    rep = Replicas(
        ShardedReplica(make_mesh(dp * sp, dp=dp, sp=sp,
                                 devices=virtual_devices("cpu", dp * sp)),
                       **kw),
        rr.ShardedReplica(r_make_mesh(dp * sp, dp=dp, sp=sp), **kw))
    for i in range(BASE):
        eid = f"b{i:04d}"
        keys, lo, hi, t0, t1 = log.draw()
        log.put(eid, (keys, lo, hi, max(t0, NOW - HOUR), t1 + HOUR))
    rep.sync()
    snap = rep._snapshots["ops"]
    assert snap.base is not None and snap.delta is None
    assert rep.stats()["replica_delta_refreshes"] == 0
    return rep, log


def _update_moves_a_base_intent_out(rep, log):
    eid = "b0007"
    search = _target(log, eid)
    assert _agree(rep, log, search) and eid in _agree(rep, log, search)[0]
    keys, lo, hi, t0, t1 = log.live[eid]
    log.put(eid, (keys, 9000.0, 9100.0, t0, t1))  # above every search
    drops = rep.stats()["replica_ops_shadow_drops"]
    rep.sync()
    assert eid not in _agree(rep, log, search)[0]
    st = rep.stats()
    # the base copy still matched the search, and the shadow dropped it
    assert st["replica_ops_shadow_drops"] > drops
    assert st["replica_ops_shadowed"] == 1
    assert st["replica_ops_delta_records"] == 1


def _delete_of_a_base_intent(rep, log):
    eid = "b0011"
    search = _target(log, eid)
    assert eid in _agree(rep, log, search)[0]
    log.delete(eid)
    rep.sync()
    assert eid not in _agree(rep, log, search)[0]
    st = rep.stats()
    assert st["replica_ops_shadowed"] == 1
    assert st["replica_ops_delta_records"] == 0


def _update_and_delete_of_a_delta_insert(rep, log):
    log.put("n0")
    log.put("n1")
    rep.sync()
    assert rep.stats()["replica_ops_delta_records"] == 2
    search = _target(log, "n0")
    assert "n0" in _agree(rep, log, search)[0]
    keys, lo, hi, t0, t1 = log.live["n0"]
    log.put("n0", (keys, 9000.0, 9100.0, t0, t1))
    log.delete("n1")
    rep.sync()
    assert "n0" not in _agree(rep, log, search)[0]
    st = rep.stats()
    # an insert is no base copy: neither its update nor its delete
    # shadows anything
    assert st["replica_ops_shadowed"] == 0
    assert st["replica_ops_delta_records"] == 1


def _insert(rep, log):
    keys, lo, hi, t0, t1 = log.draw()
    log.live["n0"] = (keys, lo, hi, NOW, NOW + HOUR)
    search = _target(log, "n0")
    del log.live["n0"]
    before = _agree(rep, log, search)[0]
    log.put("n0", (keys, lo, hi, NOW, NOW + HOUR))
    rep.sync()
    assert _agree(rep, log, search)[0] == sorted(before + ["n0"])
    assert rep.stats()["replica_ops_delta_records"] == 1


def _major_fold_forced_by_a_low_tier_ratio(rep, log):
    # 0.02 x 240 = 4.8 churn entries (delta records and shadowed ids):
    # two updates of base intents fold minor, two more a new base
    majors = rep.stats()["replica_major_rebuilds"]
    for i in range(2):
        log.put(f"b{i:04d}")
    rep.sync()
    st = rep.stats()
    assert st["replica_major_rebuilds"] == majors
    assert st["replica_ops_delta_records"] == 2
    for i in range(2, 4):
        log.put(f"b{i:04d}")
    log.put("n0")
    log.delete("b0009")
    rep.sync()
    st = rep.stats()
    assert st["replica_major_rebuilds"] == majors + 1
    assert st["replica_ops_delta_records"] == st["replica_ops_shadowed"] == 0
    assert st["replica_ops_records"] == BASE
    assert rep._snapshots["ops"].delta is None


def _stationary_mix(rep, log):
    """The backlog, then rounds of 8 updates of delta-resident intents,
    4 inserts and 4 deletes of the oldest live insert."""
    r = np.random.default_rng(5)
    majors = rep.stats()["replica_major_rebuilds"]
    base = [f"b{i:04d}" for i in r.permutation(BASE)[:24]]
    resident, fifo = base[:16], deque()
    for eid in base[:16]:
        log.put(eid)
    for eid in base[16:]:
        log.delete(eid)
    for i in range(8):
        log.put(f"n{i}")
        resident.append(f"n{i}")
        fifo.append(f"n{i}")
    rep.sync()
    sizes = None
    new = 8
    for rnd in range(6):
        kinds = r.permutation([0] * 8 + [1] * 4 + [2] * 4)
        for k in kinds:
            if k == 0:
                log.put(resident[r.integers(len(resident))])
            elif k == 1:
                eid = f"n{new}"
                new += 1
                log.put(eid)
                resident.append(eid)
                fifo.append(eid)
            else:
                eid = fifo.popleft()
                resident.remove(eid)
                log.delete(eid)
        rep.sync()
        _agree(rep, log, _queries(100 + rnd))
        st = rep.stats()
        got = (st["replica_ops_delta_records"], st["replica_ops_shadowed"])
        assert got == (24, 24)
        assert sizes in (None, got)
        sizes = got
    st = rep.stats()
    assert st["replica_major_rebuilds"] == majors
    assert st["replica_delta_refreshes"] == 7


CASES = {
    "update_moves_base_out": (_update_moves_a_base_intent_out, 0.25),
    "delete_base": (_delete_of_a_base_intent, 0.25),
    "update_delete_delta_insert": (_update_and_delete_of_a_delta_insert,
                                   0.25),
    "insert": (_insert, 0.25),
    "major_fold": (_major_fold_forced_by_a_low_tier_ratio, 0.02),
    "stationary_mix": (_stationary_mix, 0.25),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replica_answers_the_log_after_every_sync(tmp_path, mesh, case):
    scenario, ratio = CASES[case]
    rep, log = _loaded(tmp_path, mesh, ratio)
    try:
        batch = _queries(1)
        assert any(_agree(rep, log, batch))
        scenario(rep, log)
        _agree(rep, log, batch)
        _agree(rep, log, _queries(2))
        assert rep.stats()["replica_apply_errors"] == 0
    finally:
        rep.close()
        log.wal.close()

"""Differential fuzz: the port's DSSStore against the reference's.

The random-op generator of tests/test_store_fuzz.py (ISA create, update
and delete, RID subscription writes and owner-scoped searches, SCD
operation puts keyed with every OVN seen so far, alternating constraint
awareness, operation deletes and searches, constraint writes and
queries, plus SCD subscriptions), driven at the store's own surface:
the port has no services yet.  Both stores run under FakeClocks that
start at the same instant and advance by the same seeded steps, so
commit timestamps, versions and OVNs are deterministic, and every
return value, error code, version and OVN must be EQUAL — not just the
id sets the reference's own fuzz compares across backends.

The port's `cuda` backend on `device="cpu"` (the plain versions of the
kernels) meets the reference's `DSSStore(storage="tpu")`, and the
port's `memory` backend the reference's, each pair with the read cache
on and aggressive tiering.  Folds and major compactions are forced every sixth
step on both sides.  The fault case installs a seeded FaultPlan in the
port's own chaos registry (device loss at the dispatch seam, dropped
cache populations): the answers must stay equal to the fault-free
reference through the window, and after it the port's ladder walks back
to healthy.
"""

from __future__ import annotations

import uuid
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from dss_tpu_torch import chaos as p_chaos
from tests.test_torch_store_contract import PORT, REF, T0, norm

BASE_LAT, BASE_LNG = 40.0, -100.0


def _square(lat, lng, h):
    return [(lat, lng), (lat + h, lng), (lat + h, lng + h), (lat, lng + h)]


class Side:
    """One package's store and the per-store state the generator
    tracks (versions and OVNs come back from that store)."""

    def __init__(self, p, store, clock):
        self.p, self.store, self.clock = p, store, clock
        self.isa_versions = {}
        self.rid_sub_versions = {}
        self.op_versions = {}
        self.op_ovns = {}
        self.cst_versions = {}
        self.cst_ovns = {}
        self.scd_sub_versions = {}

    def cells(self, poly):
        return self.p.covering.covering_polygon(poly)

    def outcome(self, fn, *a, **kw):
        try:
            return ("ok", norm(self.p, fn(*a, **kw)))
        except self.p.errors.StatusError as e:
            return norm(self.p, e)


def _draw(rng):
    """One coherent extent draw: a footprint near the base, an altitude
    band and a time window after the clock's current instant."""
    lat = BASE_LAT + float(rng.uniform(0, 0.3))
    lng = BASE_LNG + float(rng.uniform(0, 0.3))
    half = float(rng.uniform(0.01, 0.05))
    poly = [
        (lat - half, lng - half), (lat - half, lng + half),
        (lat + half, lng + half), (lat + half, lng - half),
    ]
    return {
        "poly": poly,
        "alt_lo": float(rng.uniform(0, 200)),
        "alt_hi": float(rng.uniform(250, 500)),
        "t0_min": int(rng.integers(1, 30)),
        "dur_min": int(rng.integers(10, 120)),
    }


def _area(rng):
    """A search area on a small quantized grid, so repeat polls hit the
    read cache (as in the reference's fuzz)."""
    lat = BASE_LAT + 0.05 * int(rng.integers(0, 6))
    lng = BASE_LNG + 0.05 * int(rng.integers(0, 6))
    return _square(lat, lng, (0.045, 0.09)[int(rng.integers(0, 2))])


def _window(side, ext):
    now = side.clock.now()
    t0 = now + timedelta(minutes=ext["t0_min"])
    return t0, t0 + timedelta(minutes=ext["dur_min"])


def step_once(side, op, sid, ext, area, owner, step):
    """Apply generator op `op` to one side -> the list of observed
    outcomes (the same call sequence on both sides)."""
    p, s = side.p, side.store
    ridm, scdm = p.ridm, p.scdm
    outs = []
    if op in (0, 8):  # ISA create / fenced update, then the RID fan-out
        t0, t1 = _window(side, ext)
        isa = ridm.IdentificationServiceArea(
            id=sid, owner="u1", url="https://u/f",
            cells=side.cells(ext["poly"]), start_time=t0, end_time=t1,
            altitude_lo=ext["alt_lo"], altitude_hi=ext["alt_hi"],
        )
        if op == 8 or sid in side.isa_versions:
            isa.version = side.isa_versions.get(sid) or p.Version.from_time(
                T0 - timedelta(days=1)
            )
        out = side.outcome(s.rid.insert_isa, isa)
        outs.append(out)
        if out[0] == "ok" and out[1] is not None:
            side.isa_versions[sid] = s.rid.get_isa(sid).version
            outs.append(side.outcome(
                s.rid.update_notification_idxs_in_cells, isa.cells
            ))
    elif op == 1:  # ISA delete (maybe missing, maybe stale)
        isa = ridm.IdentificationServiceArea(
            id=sid, owner="u1",
            version=side.isa_versions.get(sid)
            or p.Version.from_time(T0 - timedelta(days=2)),
        )
        out = side.outcome(s.rid.delete_isa, isa)
        outs.append(out)
        if out[0] == "ok" and out[1] is not None:
            side.isa_versions.pop(sid, None)
    elif op == 2:  # RID search
        outs.append(side.outcome(
            s.rid.search_isas, side.cells(area),
            earliest=side.clock.now(), latest=None,
        ))
    elif op == 3:  # SCD op put, keyed with every OVN seen so far
        t0, t1 = _window(side, ext)
        aware = step % 2 == 0
        key = list(side.op_ovns.values()) + (
            list(side.cst_ovns.values()) if aware else []
        )
        if step % 5 == 0:
            key = key[1:]  # one OVN short: a conflict when it overlaps
        o = scdm.Operation(
            id=sid, owner=owner, version=side.op_versions.get(sid, 0),
            start_time=t0, end_time=t1, altitude_lower=50.0,
            altitude_upper=200.0, uss_base_url="https://u.example",
            state=scdm.OperationState.ACCEPTED,
            cells=side.cells(ext["poly"]), subscription_id=f"sub-{sid}",
            constraint_aware=aware,
        )
        out = side.outcome(s.scd.upsert_operation, o, key)
        outs.append(out)
        if out[0] == "ok":
            stored = s.scd.get_operation(sid)
            side.op_versions[sid] = stored.version
            side.op_ovns[sid] = stored.ovn
    elif op == 4:  # SCD op delete
        out = side.outcome(s.scd.delete_operation, sid, owner)
        outs.append(out)
        if out[0] == "ok":
            side.op_versions.pop(sid, None)
            side.op_ovns.pop(sid, None)
    elif op == 5:  # SCD op search
        t0, t1 = _window(side, ext)
        outs.append(side.outcome(
            s.scd.search_operations, side.cells(ext["poly"]),
            ext["alt_lo"], ext["alt_hi"], t0, t1,
        ))
    elif op == 6:  # RID subscription create or fenced update + quota
        t0, t1 = _window(side, ext)
        cells = side.cells(ext["poly"])
        outs.append(side.outcome(
            s.rid.max_subscription_count_in_cells_by_owner, cells, "u1"
        ))
        sub = ridm.Subscription(
            id=sid, owner="u1", url="https://u/i", cells=cells,
            start_time=t0, end_time=t1,
            version=side.rid_sub_versions.get(sid),
        )
        out = side.outcome(s.rid.insert_subscription, sub)
        outs.append(out)
        if out[0] == "ok" and out[1] is not None:
            side.rid_sub_versions[sid] = s.rid.get_subscription(sid).version
    elif op == 7:  # RID subscription delete (maybe stale)
        sub = ridm.Subscription(
            id=sid, owner="u1",
            version=side.rid_sub_versions.get(sid)
            or p.Version.from_time(T0 - timedelta(days=2)),
        )
        out = side.outcome(s.rid.delete_subscription, sub)
        outs.append(out)
        if out[0] == "ok" and out[1] is not None:
            side.rid_sub_versions.pop(sid, None)
    elif op == 9:  # owner-scoped RID subscription search
        outs.append(side.outcome(
            s.rid.search_subscriptions_by_owner, side.cells(area), owner
        ))
    elif op == 10:  # constraint put (create, fenced update, or stale)
        t0, t1 = _window(side, ext)
        c = scdm.Constraint(
            id=sid, owner="u1", version=side.cst_versions.get(sid, 0),
            start_time=t0, end_time=t1, altitude_lower=ext["alt_lo"],
            altitude_upper=ext["alt_hi"],
            uss_base_url="https://authority.example",
            cells=side.cells(ext["poly"]),
        )
        out = side.outcome(s.scd.upsert_constraint, c)
        outs.append(out)
        if out[0] == "ok":
            stored = s.scd.get_constraint(sid)
            side.cst_versions[sid] = stored.version
            side.cst_ovns[sid] = stored.ovn
    elif op == 11:  # constraint delete
        out = side.outcome(s.scd.delete_constraint, sid, "u1")
        outs.append(out)
        if out[0] == "ok":
            side.cst_versions.pop(sid, None)
            side.cst_ovns.pop(sid, None)
    elif op == 12:  # constraint query
        outs.append(side.outcome(
            s.scd.search_constraints, side.cells(area), None, None,
            side.clock.now(), None,
        ))
    elif op == 13:  # SCD subscription put
        t0, t1 = _window(side, ext)
        sub = scdm.Subscription(
            id=sid, owner=owner, version=side.scd_sub_versions.get(sid, 0),
            start_time=t0, end_time=t1, altitude_lo=ext["alt_lo"],
            altitude_hi=ext["alt_hi"], base_url="https://u.example",
            notify_for_operations=True,
            notify_for_constraints=step % 3 == 0,
            cells=side.cells(ext["poly"]),
        )
        out = side.outcome(s.scd.upsert_subscription, sub)
        outs.append(out)
        if out[0] == "ok":
            side.scd_sub_versions[sid] = out[1][0][1]["version"]
    elif op == 14:  # SCD subscription search (owner-scoped)
        outs.append(side.outcome(
            s.scd.search_subscriptions, side.cells(area), owner
        ))
    else:  # SCD subscription delete
        out = side.outcome(
            s.scd.delete_subscription, sid, owner,
            side.scd_sub_versions.get(sid, 0),
        )
        outs.append(out)
        if out[0] == "ok":
            side.scd_sub_versions.pop(sid, None)
    return outs


def _tables(store):
    out = []
    for index, _ in (
        (store.rid._isa_index, 0), (store.rid._sub_index, 0),
        (store.scd._op_index, 0), (store.scd._sub_index, 0),
        (store.scd._cst_index, 0),
    ):
        t = getattr(index, "table", None)
        if t is not None:
            out.append(t)
    return out


def _pair(monkeypatch, backend, wal_paths=(None, None)):
    """The reference's store and the port's `backend` store, both with
    the read cache on and tiering aggressive."""
    monkeypatch.setenv("DSS_CACHE_ENABLE", "1")
    monkeypatch.setenv("DSS_CACHE_CAP", "512")
    monkeypatch.setenv("DSS_TIER_RATIO", "5")
    start = T0 - timedelta(hours=1)
    rc, pc = REF.FakeClock(start), PORT.FakeClock(start)
    # the memory indexes list ids in insertion order and the DAR
    # indexes sorted, in both packages: each port backend meets the
    # reference backend of its kind
    ref = REF.Store(storage="tpu" if backend == "cuda" else "memory",
                    clock=rc, wal_path=wal_paths[0])
    kw = {"device": "cpu"} if backend == "cuda" else {}
    port = PORT.Store(storage=backend, clock=pc, wal_path=wal_paths[1],
                      **kw)
    return Side(REF, ref, rc), Side(PORT, port, pc)


def run_sequence(ref, port, seed, steps, on_step=None):
    rng = np.random.default_rng(seed)
    max_tiers = 0
    for step in range(steps):
        if on_step is not None:
            on_step(step)
        op = int(rng.integers(0, 16))
        sid = str(uuid.UUID(int=int(rng.integers(0, 40)), version=4))
        owner = ("u1", "u2")[int(rng.integers(0, 2))]
        ext, area = _draw(rng), _area(rng)
        a = step_once(ref, op, sid, ext, area, owner, step)
        b = step_once(port, op, sid, ext, area, owner, step)
        assert b == a, (seed, step, op)
        # the same seeded clock step on both sides: expiry and the
        # commit timestamps move together
        dt = int(rng.integers(0, 90))
        ref.clock.advance(seconds=dt)
        port.clock.advance(seconds=dt)
        if step % 6 == 5:
            major = (step // 6) % 2 == 1
            for side in (ref, port):
                for t in _tables(side.store):
                    if major:
                        t.compact()
                    else:
                        t.fold()
            if _tables(port.store):
                max_tiers = max(max_tiers, max(
                    t.stats()["tier_count"] for t in _tables(port.store)
                ))
    return max_tiers


def sweep(ref, port):
    """Every quantized poll area, every class: equal answers."""
    for i in range(6):
        for j in range(6):
            for h in (0.045, 0.09):
                poly = _square(BASE_LAT + 0.05 * i, BASE_LNG + 0.05 * j, h)
                for side_out in (
                    lambda sd: sd.outcome(
                        sd.store.rid.search_isas, sd.cells(poly),
                        earliest=sd.clock.now(), latest=None),
                    lambda sd: sd.outcome(
                        sd.store.scd.search_constraints, sd.cells(poly),
                        None, None, sd.clock.now(), None),
                    lambda sd: sd.outcome(
                        sd.store.scd.search_operations, sd.cells(poly),
                        None, None, sd.clock.now(), None),
                ):
                    assert side_out(port) == side_out(ref), poly


@pytest.mark.parametrize("backend", ["cuda", "memory"])
@pytest.mark.parametrize("seed", list(range(1, 7)))
def test_port_store_equals_reference_under_random_ops(seed, backend,
                                                      monkeypatch):
    ref, port = _pair(monkeypatch, backend)
    try:
        max_tiers = run_sequence(ref, port, seed, steps=90)
        sweep(ref, port)
        if backend == "cuda":
            assert max_tiers >= 2, "the fuzz never reached the tier stack"
        # the cache served hits on both sides, equally often
        rs, ps = ref.store.cache.stats(), port.store.cache.stats()
        assert ps["hits"] > 0
        assert (ps["hits"], ps["misses"]) == (rs["hits"], rs["misses"])
        assert port.store.wal.seq == ref.store.wal.seq
    finally:
        ref.store.close()
        port.store.close()


@pytest.mark.parametrize("seed", [3, 11])
def test_port_store_equals_reference_through_a_fault_schedule(seed,
                                                             monkeypatch):
    """Modelled on tests/test_store_fuzz.py::test_fuzz_with_fault_schedule,
    with the fault-free reference store as the oracle."""
    p_chaos.clear_plan()
    p_chaos.registry().reset_counters()
    ref, port = _pair(monkeypatch, "cuda")
    plan = p_chaos.FaultPlan.from_dict({
        "seed": seed,
        "events": [
            {"site": "device.dispatch", "action": "device_lost",
             "count": 2},
            {"site": "device.dispatch", "action": "device_lost",
             "after": 5, "count": 2},
            {"site": "cache.populate", "action": "error", "count": 3},
            {"site": "cache.populate", "action": "error", "after": 3,
             "count": 4, "p": 0.5},
        ],
    })
    def on_step(step):
        if step == 12:
            p_chaos.install_plan(plan)
        if step == 56:
            p_chaos.clear_plan()
            port.store.health.exit("device_lost")

    try:
        run_sequence(ref, port, seed, steps=72, on_step=on_step)
        injected = p_chaos.registry().injected_by_site()
        assert injected.get("device.dispatch", 0) >= 1, injected
        assert injected.get("cache.populate", 0) >= 1, injected
        assert port.store.health.mode() == p_chaos.HEALTHY
        sweep(ref, port)
    finally:
        p_chaos.clear_plan()
        p_chaos.registry().reset_counters()
        ref.store.close()
        port.store.close()

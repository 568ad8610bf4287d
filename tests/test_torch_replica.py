"""The port's ShardedReplica, attach_mesh_replica and mesh offload
against the reference's.

The cases of tests/test_sharded.py:183-446 and
tests/test_shard_rebalance.py:270-696 run on both packages side by
side — the reference's replica on its 8 virtual CPU devices, the
port's on 8 CPU positions of one device — fed the same WAL (a
reference store writes it; the port's WAL format is the reference's)
or the same records, with equal answers, boundaries, effective
capacities and gauges required.  The three `test_global_mesh_*` cases
wait for the multihost slice.

One divergence is pinned on purpose: the port's close() waits until
its tail thread has stopped, where the reference's joins for 5 s and
returns with the thread still inside a refresh.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.dar.oracle import Record as RRecord
from dss_tpu.dar.tiers import RangeLoad as RRangeLoad
from dss_tpu.geo import covering as geo_covering
from dss_tpu.geo import s2cell
from dss_tpu.parallel import make_mesh as r_make_mesh
from dss_tpu.parallel import replica as rr
from dss_tpu.services.rid import RIDService as RRID
from dss_tpu.services.scd import SCDService as RSCD
from tests import test_shard_rebalance as ref_rebalance
from tests import test_sharded as ref_sharded

from dss_tpu_torch.dar import follower as p_follower
from dss_tpu_torch.dar.oracle import Record as PRecord
from dss_tpu_torch.dar.tiers import RangeLoad as PRangeLoad
from dss_tpu_torch.parallel import make_mesh as p_make_mesh
from dss_tpu_torch.parallel import replica as pr
from dss_tpu_torch.parallel.mesh import virtual_devices


def _meshes(dp=1, sp=8):
    return (r_make_mesh(dp * sp, dp=dp, sp=sp),
            p_make_mesh(dp * sp, dp=dp, sp=sp,
                        devices=virtual_devices("cpu", dp * sp)))


def _pair(wal, dp=2, sp=4, **kw):
    rmesh, pmesh = _meshes(dp, sp)
    return (rr.ShardedReplica(rmesh, wal_path=str(wal), **kw),
            pr.ShardedReplica(pmesh, wal_path=str(wal), **kw))


def _precord(r) -> PRecord:
    return PRecord(**dataclasses.asdict(r))


def _seeded_pair(tmp_path, records, name, **kw):
    """tests/test_shard_rebalance.py's _mk_replica on both packages:
    1x8 meshes, max_results 256, shard_results 48, the isas class
    seeded with `records` and refreshed without planning."""
    wal = tmp_path / f"{name}.wal"
    wal.touch()
    reps = []
    for mod, mesh, conv in ((rr, _meshes()[0], lambda r: r),
                            (pr, _meshes()[1], _precord)):
        rep = mod.ShardedReplica(mesh, wal_path=str(wal), max_results=256,
                                 shard_results=48, **kw)
        with rep._mu:
            rep._records["isas"] = {
                r.entity_id: conv(r) for r in records
            }
            rep._dirty["isas"] = True
        rep.refresh(plan=False)
        reps.append(rep)
    return reps


def _same_placement(ref, port):
    if ref.boundaries is None:
        assert port.boundaries is None
    else:
        np.testing.assert_array_equal(port.boundaries, ref.boundaries)
        assert port.boundaries.dtype == np.int32
    assert port.boundary_gen == ref.boundary_gen
    assert port.boundary_moves == ref.boundary_moves
    assert port.moved_bytes == ref.moved_bytes
    assert port.shard_results_effective == ref.shard_results_effective
    assert port._imbalance == ref._imbalance


def _same_stats(ref, port):
    """Equal gauges, but for the ones that hold times.  The port also
    counts, per class, the searches it answered, the slots it decoded
    and the shadow's drops, and the folds' host->device bytes and
    minor-fold records, which the reference has no gauge for."""
    a, b = ref.stats(), port.stats()
    served = {f"replica_{c}_{k}" for c in pr.CLASSES
              for k in ("queries", "hits", "shadow_drops")}
    served |= {"replica_fold_h2d_bytes", "replica_minor_fold_records"}
    assert set(a) == set(b) - served and served <= set(b)
    for k in a:
        if k in ("replica_warm_ms_total", "replica_staleness_s"):
            continue
        assert b[k] == a[k], k


def _area_keys(lat):
    cells = geo_covering.covering_polygon(
        [(lat, -100.0), (lat + 0.02, -100.0),
         (lat + 0.02, -99.98), (lat, -99.98)]
    )
    return s2cell.cell_to_dar_key(cells)


def test_follower_tails_with_the_replica_wal_tail():
    assert p_follower._WalTail is pr._WalTail
    # a region-log replica tails the region log (tests/test_torch_region.py
    # drives one against a live log server)
    client = object()
    rep = pr.ShardedReplica(_meshes()[1], region_client=client)
    assert isinstance(rep._tail, pr._RegionTail)
    assert rep._tail.client is client and rep._tail.position == 0
    with pytest.raises(ValueError, match="exactly one"):
        pr.ShardedReplica(_meshes()[1])
    with pytest.raises(ValueError, match="exactly one"):
        pr.ShardedReplica(_meshes()[1], wal_path="x.wal",
                          region_client=client)


def test_replica_tails_live_wal_into_sharded_dar(tmp_path):
    """A live store's WAL replays into both packages' serving replicas
    on a 2x4 mesh; answers and gauges agree after every sync, and the
    port's readers only ever see complete snapshots."""
    wal = tmp_path / "dss.wal"
    store = RStore(storage="memory", wal_path=str(wal))
    scd = RSCD(store.scd, store.clock)
    ref, port = _pair(wal)
    try:
        ids1 = [str(uuid.uuid4()) for _ in range(5)]
        for i, op_id in enumerate(ids1):
            scd.put_operation(
                op_id, ref_sharded._op_params_at(40.0 + i * 0.1), "uss1")
        ref.sync()
        port.sync()
        now = int(time.time() * 1e9)
        for i, op_id in enumerate(ids1):
            got = port.query(_area_keys(40.0 + i * 0.1), now=now)
            assert op_id in got
            assert got == ref.query(_area_keys(40.0 + i * 0.1), now=now)

        valid_counts = {len(ids1), len(ids1) + 1, len(ids1) + 2}
        stop = threading.Event()
        seen = []
        wide = np.unique(
            np.concatenate([_area_keys(40.0 + i * 0.1) for i in range(7)])
        )

        def reader():
            while not stop.is_set():
                got = port.query(wide, now=now)
                if len(got) not in valid_counts:
                    seen.append(len(got))

        th = threading.Thread(target=reader)
        th.start()
        ids2 = [str(uuid.uuid4()) for _ in range(2)]
        for j, op_id in enumerate(ids2):
            scd.put_operation(
                op_id, ref_sharded._op_params_at(40.5 + j * 0.1), "uss1")
            port.sync()
        stop.set()
        th.join(timeout=10)
        assert not th.is_alive()
        assert not seen, f"partial snapshots observed: {seen}"
        ref.sync()
        assert port.query(wide, now=now) == ref.query(wide, now=now) == (
            sorted(ids1 + ids2))

        scd.delete_operation(ids1[0], "uss1")
        ref.sync()
        port.sync()
        got = port.query(wide, now=now)
        assert got == ref.query(wide, now=now) == sorted(ids1[1:] + ids2)
        st = port.stats()
        assert st["replica_rebuilds"] >= 3
        assert st["replica_ops_snapshot_records"] == len(ids1) - 1 + len(ids2)
        assert port.tail_position() == ref.tail_position() > 0
        assert port.state_fingerprint() == ref.state_fingerprint()
    finally:
        ref.close()
        port.close()
        store.close()


def test_replica_serves_every_entity_class(tmp_path):
    """ISAs, RID subs, SCD subs and ops replicate alike in both
    packages; subscription ids are owner-scoped; deletes propagate."""
    wal = tmp_path / "dss.wal"
    store = RStore(storage="memory", wal_path=str(wal))
    rid = RRID(store.rid, store.clock)
    scd = RSCD(store.scd, store.clock)
    ref, port = _pair(wal)
    try:
        def iso(off):
            return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                 time.gmtime(time.time() + off))

        box = {"vertices": [
            {"lat": 40.0, "lng": -100.0}, {"lat": 40.02, "lng": -100.0},
            {"lat": 40.02, "lng": -99.98}, {"lat": 40.0, "lng": -99.98},
        ]}
        isa_id, sub_id, op_id = (str(uuid.uuid4()) for _ in range(3))
        rid.create_isa(isa_id, {
            "extents": {"spatial_volume": {"footprint": box,
                                           "altitude_lo": 10.0,
                                           "altitude_hi": 300.0},
                        "time_start": iso(60), "time_end": iso(3600)},
            "flights_url": "https://u1.example.com/f",
        }, "uss1")
        rid.create_subscription(sub_id, {
            "extents": {"spatial_volume": {"footprint": box,
                                           "altitude_lo": 0.0,
                                           "altitude_hi": 3000.0},
                        "time_start": iso(60), "time_end": iso(3600)},
            "callbacks": {
                "identification_service_area_url": "https://u1.example.com"
            },
        }, "uss1")
        scd.put_operation(op_id, ref_sharded._op_params_at(40.0), "uss1")
        ref.sync()
        port.sync()
        keys = _area_keys(40.0)
        now = int(time.time() * 1e9) + int(120e9)
        got = {}
        for cls, owner in (("isas", None), ("rid_subs", None),
                           ("rid_subs", "uss1"), ("rid_subs", "uss2"),
                           ("ops", None), ("scd_subs", None),
                           ("constraints", None)):
            got[cls, owner] = port.query(keys, now=now, cls=cls,
                                         owner=owner)
            assert got[cls, owner] == ref.query(keys, now=now, cls=cls,
                                                owner=owner)
        assert got["isas", None] == [isa_id]
        assert got["rid_subs", None] == got["rid_subs", "uss1"] == [sub_id]
        assert got["rid_subs", "uss2"] == [] == got["constraints", None]
        assert op_id in got["ops", None]
        assert len(got["scd_subs", None]) == 1
        _same_stats(ref, port)
        v = rid.get_isa(isa_id)["service_area"]["version"]
        rid.delete_isa(isa_id, v, "uss1")
        ref.sync()
        port.sync()
        assert port.query(keys, now=now, cls="isas") == ref.query(
            keys, now=now, cls="isas") == []
        _same_stats(ref, port)
        # the exact host path answers from the same record map
        args = ([keys], np.asarray([-np.inf], np.float32),
                np.asarray([np.inf], np.float32),
                np.asarray([pr.NO_TIME_LO], np.int64),
                np.asarray([pr.NO_TIME_HI], np.int64))
        assert port.query_batch_host(*args, now=now, cls="ops") == (
            port.query_batch(*args, now=now, cls="ops"))
    finally:
        ref.close()
        port.close()
        store.close()


def test_mesh_offload_for_oversized_stale_ok_batches():
    """Batches of >= min_batch allow_stale queries route to the mesh
    delegate when fresh; conflict prechecks (allow_stale=False),
    owner-filtered queries and small batches never do — the port's
    coalescer as the reference's, step for step."""
    from dss_tpu.dar import coalesce as rco
    from dss_tpu.dar.snapshot import DarTable as RTable

    from dss_tpu_torch.dar import coalesce as pco
    from dss_tpu_torch.dar.snapshot import DarTable as PTable

    runs = []
    for co_mod, table in ((rco, RTable()), (pco, PTable(device="cpu"))):
        table.upsert("local", np.asarray([5], np.int32), None, None, 0,
                     10**18, 0)
        co = co_mod.QueryCoalescer(table)
        calls = []

        def mesh_fn(keys_list, alo, ahi, ts, te, now_arr, calls=calls):
            calls.append(len(keys_list))
            return [["mesh-answer"] for _ in keys_list]

        co.set_mesh_delegate(mesh_fn, lambda: True, min_batch=2)

        def item(allow_stale, owner=None, co_mod=co_mod):
            return co_mod._Item(np.asarray([5], np.int32), None, None,
                                None, None, 1, owner, allow_stale)

        out = []
        for b in ([item(True), item(True)],
                  [item(True), item(False)],
                  [item(True, owner=0), item(True, owner=0)],
                  [item(True)]):
            co._execute(b)
            out.append(([it.result for it in b],
                        [it.via_mesh for it in b], co.mesh_offloads))
        co.close()
        runs.append((out, calls))
    assert runs[0] == runs[1]
    out, calls = runs[1]
    assert out[0] == ([["mesh-answer"]] * 2, [True, True], 1)
    assert [o[0] for o in out[1:]] == [[["local"]] * 2] * 2 + [[["local"]]]
    assert out[-1][2] == 1 and calls == [2]


def test_store_attach_mesh_replica_offloads_stale_drains(tmp_path):
    """The port's DSSStore.attach_mesh_replica: one delegate per class
    on each coalescer, bgen from the replica, the store's RangeLoad
    shared; a bounded-stale drain of >= min_batch is answered by the
    replica (equal to the local answer) and counted; prechecks and
    owner-filtered queries stay local."""
    from dss_tpu_torch.dar import coalesce as pco
    from dss_tpu_torch.dar.dss_store import DSSStore as PStore
    from dss_tpu_torch.services.scd import SCDService as PSCD

    wal = tmp_path / "dss.wal"
    store = PStore(storage="cuda", device="cpu", wal_path=str(wal))
    rep = pr.ShardedReplica(_meshes(1, 2)[1], wal_path=str(wal))
    try:
        scd = PSCD(store.scd, store.clock)
        for i in range(6):
            scd.put_operation(str(uuid.uuid4()),
                              ref_sharded._op_params_at(40.0 + i * 0.1),
                              "uss1")
        rep.sync()
        store.attach_mesh_replica(rep, min_batch=4)
        assert rep.load is store.range_load
        co = store.scd._op_index.coalescer
        assert co._mesh_fn is not None and co._mesh_min == 4
        assert co._mesh_bgen() == rep.boundary_gen == 0
        for index in (store.rid._isa_index, store.rid._sub_index,
                      store.scd._sub_index, store.scd._cst_index):
            assert index.coalescer._mesh_fn is not None
        keys = np.unique(np.concatenate(
            [_area_keys(40.0 + i * 0.1) for i in range(6)]))
        now = int(time.time() * 1e9)

        def item(allow_stale, owner=None):
            return pco._Item(keys, None, None, None, None, now, owner,
                             allow_stale)

        local = [item(False) for _ in range(4)]
        co._execute(local)
        assert co.mesh_offloads == 0 and len(local[0].result) == 6
        stale = [item(True) for _ in range(4)]
        co._execute(stale)
        assert co.mesh_offloads == 1
        assert [it.via_mesh for it in stale] == [True] * 4
        assert [it.result for it in stale] == [it.result for it in local]
        owned = [item(True, owner=0) for _ in range(4)]
        co._execute(owned)
        assert co.mesh_offloads == 1 and not owned[0].via_mesh
        assert store.stats()["dss_dar_op_mesh_offloads"] == 1
    finally:
        rep.close()
        store.close()


def test_replica_demand_paced_refresh(tmp_path):
    """The background loop's rebuild gate on both packages: rebuild in
    the boot grace, idle once the pace window passes with no freshness
    probe, resume on the next fresh(); pace <= 0 always rebuilds."""
    wal = tmp_path / "dss.wal"
    wal.touch()
    for rep in _pair(wal):
        rep.demand_pace_s = 5.0
        now = time.monotonic()
        rep._started_at = now
        assert rep._refresh_due()
        rep._started_at = now - 60.0
        assert not rep._refresh_due()
        assert rep.stats()["replica_demand_idle"] == 1
        rep.fresh()
        assert rep._refresh_due()
        assert rep.stats()["replica_demand_idle"] == 0
        rep.demand_pace_s = 0.0
        rep._demand_last = 0.0
        assert rep._refresh_due()


def test_background_refresh_reaches_fresh(tmp_path):
    """start(): the port's tail thread folds a live WAL until fresh()
    holds, then close() joins it."""
    wal = tmp_path / "dss.wal"
    store = RStore(storage="memory", wal_path=str(wal))
    scd = RSCD(store.scd, store.clock)
    rep = pr.ShardedReplica(_meshes(1, 2)[1], wal_path=str(wal))
    try:
        op_id = str(uuid.uuid4())
        scd.put_operation(op_id, ref_sharded._op_params_at(41.0), "uss1")
        rep.start(0.05)
        deadline = time.monotonic() + 20
        while not rep.fresh() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rep.fresh()
        assert rep.query(_area_keys(41.0), now=int(time.time() * 1e9)) == [
            op_id]
        assert 0 <= rep.staleness_s() < 20
    finally:
        rep.close()
        store.close()
    assert not rep._thread.is_alive()


def test_close_waits_for_the_tail_where_the_reference_join_times_out(
        tmp_path):
    """Both packages' replicas tail a WAL, and each one's refresh is
    held on an Event while close() runs: after 6.5 s the reference's
    close has returned with its thread still in the refresh (a timed
    join of 5 s), and the port's is still waiting; once the refresh is
    released, the port's close returns with its thread stopped."""
    wal = tmp_path / "dss.wal"
    wal.touch()
    reps = dict(zip(("ref", "port"), _pair(wal, dp=1, sp=2)))
    entered = {name: threading.Event() for name in reps}
    release = threading.Event()
    for name, rep in reps.items():
        def refresh(*, plan=True, _name=name):
            entered[_name].set()
            release.wait(30)
            return False

        rep.refresh = refresh
        rep.demand_pace_s = 0.0
        rep.start(0.01)
    for name in reps:
        assert entered[name].wait(10), name
    alive_at_return = {}

    def close(name):
        reps[name].close()
        alive_at_return[name] = reps[name]._thread.is_alive()

    closers = [threading.Thread(target=close, args=(name,))
               for name in reps]
    for c in closers:
        c.start()
    try:
        time.sleep(6.5)
        assert alive_at_return == {"ref": True}
        assert reps["port"]._thread.is_alive()
    finally:
        release.set()
        for c in closers:
            c.join(30)
    assert alive_at_return == {"ref": True, "port": False}
    reps["ref"]._thread.join(30)  # released, it ends on its own
    assert not reps["ref"]._thread.is_alive()


# -- the rebalancer (tests/test_shard_rebalance.py:270-696) ---------------------


def _load(shift, stamps):
    out = []
    for cls in (RRangeLoad, PRangeLoad):
        load = cls(shift=shift)
        for keys, work in stamps:
            load.record(keys, work=work)
        out.append(load)
    return out


@pytest.mark.parametrize("case", ["below_threshold", "uniform_load"])
def test_rebalancer_stays_silent_on_both(tmp_path, case):
    """Hysteresis: mild imbalance under the ratio is a strict no-op;
    uniform load over uniform data never moves a boundary across
    write/fold cycles (plan=True, the serving path)."""
    rng = np.random.default_rng(5 if case == "below_threshold" else 8)
    recs = ref_rebalance._mk_records(rng, 300 if case ==
                                     "below_threshold" else 250)
    kw = (dict(rebalance_ratio=10.0, move_interval_s=0.0)
          if case == "below_threshold"
          else dict(rebalance_ratio=1.5, move_interval_s=0.0))
    reps = _seeded_pair(tmp_path, recs, case, **kw)
    try:
        if case == "below_threshold":
            loads = _load(3, [(np.arange(1000, 1100, dtype=np.int32), 5.0)]
                          * 20)
            for rep, load in zip(reps, loads):
                rep.load = load
                assert rep.plan_rebalance() is False
                assert rep.boundary_moves == 0 and rep.boundaries is None
                assert rep._imbalance > 1.0
        else:
            for phase in range(3):
                adds = ref_rebalance._mk_records(rng, 15, prefix=f"u{phase}_")
                stamps = []
                for _ in range(40):
                    k0 = int(rng.integers(0, 8000 - 32))
                    stamps.append((np.arange(k0, k0 + 32, dtype=np.int32),
                                   2.0))
                for rep, conv in zip(reps, (lambda r: r, _precord)):
                    with rep._mu:
                        for r in adds:
                            rep._put("isas", conv(r))
                    for keys, work in stamps:
                        rep.load.record(keys, work=work)
                    rep.refresh()
            for rep in reps:
                assert rep.boundary_moves == 0 and rep.boundaries is None
                assert rep.shard_stats()["dss_shard_boundary_moves"] == 0
        _same_placement(*reps)
    finally:
        for rep in reps:
            rep.close()


def test_move_rate_cap_blocks_back_to_back_moves(tmp_path):
    rng = np.random.default_rng(6)
    reps = _seeded_pair(tmp_path, ref_rebalance._mk_records(rng, 300), "cap",
                        rebalance_ratio=1.2, move_interval_s=3600.0)
    try:
        first = _load(3, [(np.arange(1000, 1200, dtype=np.int32), 100.0)]
                      * 20)
        for rep, load in zip(reps, first):
            rep.load = load
            assert rep.plan_rebalance(now=1000.0) is True
            rep.refresh(plan=False)
            for _ in range(40):
                rep.load.record(np.arange(6000, 6200, dtype=np.int32),
                                work=200.0)
            assert rep.plan_rebalance(now=1001.0) is False
            assert rep.boundary_moves == 1
        _same_placement(*reps)
        for rep in reps:
            assert rep.plan_rebalance(now=1000.0 + 3601.0) is True
            assert rep.boundary_moves == 2
        _same_placement(*reps)
        for rep in reps:
            rep.refresh(plan=False)
        _same_stats(*reps)
    finally:
        for rep in reps:
            rep.close()


def test_differential_fuzz_rebalanced_vs_static(tmp_path):
    """The reference's correctness bar across packages: a rebalanced
    replica of each package and the port's static replica, fed one
    write stream (adds, shadowing updates, deletes, a forced major
    compaction, a mid-sequence boundary move), answer alike after every
    phase and match the exact host answer; both packages move to the
    same boundaries."""
    rng = np.random.default_rng(7)
    base = ref_rebalance._mk_records(rng, 250)
    reb_ref, reb_port = _seeded_pair(tmp_path, list(base), "reb",
                                     rebalance_ratio=1.3,
                                     move_interval_s=0.0)
    _, static = _seeded_pair(tmp_path, list(base), "static",
                             rebalance_ratio=0.0)
    reps = (reb_ref, reb_port, static)
    try:
        for phase in range(5):
            adds = ref_rebalance._mk_records(rng, 30, prefix=f"p{phase}_")
            live_ids = list(reb_ref._records["isas"])
            upd = [reb_ref._records["isas"][i] for i in rng.choice(
                live_ids, size=min(10, len(live_ids)), replace=False)]
            dels = [str(i) for i in rng.choice(
                live_ids, size=min(6, len(live_ids)), replace=False)]
            for rep, conv in zip(reps, (lambda r: r, _precord, _precord)):
                with rep._mu:
                    for r in adds:
                        rep._put("isas", conv(r))
                    for r in upd:
                        moved = dataclasses.replace(
                            r, keys=np.unique((r.keys + 37) % 8000).astype(
                                np.int32))
                        rep._put("isas", conv(moved))
                    for eid in dels:
                        rep._del("isas", eid)
                if phase == 1:
                    with rep._mu:
                        rep._force_major["isas"] = True
            if phase == 2:
                hot = _load(3, [(np.arange(3000, 3300, dtype=np.int32),
                                 150.0)] * 30)
                for rep, load in zip(reps[:2], hot):
                    rep.load = load
                    assert rep.plan_rebalance() is True
                _same_placement(reb_ref, reb_port)
            for rep in reps:
                rep.refresh(plan=False)
            q = 8
            areas = []
            for _ in range(q):
                k0 = int(rng.integers(0, 8000 - 32))
                areas.append(np.arange(k0, k0 + 32, dtype=np.int32))
            args = (np.full(q, -np.inf, np.float32),
                    np.full(q, np.inf, np.float32),
                    np.full(q, -(2**62), np.int64),
                    np.full(q, 2**62, np.int64))
            a, b, c = (rep.query_batch(areas, *args, now=0, cls="isas")
                       for rep in reps)
            host = reb_port.query_batch_host(areas, *args, now=0, cls="isas")
            assert b == a, f"phase {phase}: port != reference"
            assert b == c, f"phase {phase}: rebalanced != static"
            assert b == host, f"phase {phase}: mesh != host oracle"
            _same_stats(reb_ref, reb_port)
        assert reb_port.boundary_moves >= 1
        assert reb_port.shard_stats()["dss_shard_boundary_moves"] >= 1
        assert static.boundary_moves == 0
    finally:
        for rep in reps:
            rep.close()


def test_capacity_vector_validation(tmp_path):
    wal = str(tmp_path / "capval.wal")
    open(wal, "w").close()
    for mod, mesh in zip((rr, pr), _meshes()):
        for bad in ([1.0] * 7 + [0.0], [1.0] * 7 + [float("nan")]):
            with pytest.raises(ValueError, match="finite and > 0"):
                mod.ShardedReplica(mesh, wal_path=wal, capacity_weights=bad)


def test_replica_capacity_normalized_hysteresis(tmp_path):
    """The same measured load is a hot spot on a homogeneous mesh (a
    move) and balanced when the loaded shard is the high-capacity host
    (a no-op) — in both packages alike."""
    rng = np.random.default_rng(14)
    records = ref_rebalance._mk_records(rng, 400)
    stamps = []
    for _ in range(10):
        stamps.append((np.arange(0, 8000, 4, dtype=np.int32), 1.0))
        stamps.append((np.arange(0, 900, 2, dtype=np.int32), 4.0))
    hom = _seeded_pair(tmp_path, records, "hom", rebalance_ratio=1.5,
                       move_interval_s=0.0)
    try:
        for rep, load in zip(hom, _load(3, stamps)):
            rep.load = load
        keys = hom[1]._all_posting_keys()
        w = hom[1].load.weights_for(keys)
        cur = hom[1]._predicted_shard_loads(keys, w, None)
        cap = cur / cur.min()
        for rep in hom:
            assert rep.plan_rebalance(now=10.0) is True
        _same_placement(*hom)
        raw = hom[1]._imbalance
        assert raw > 1.5
    finally:
        for rep in hom:
            rep.close()
    het = _seeded_pair(tmp_path, records, "het", rebalance_ratio=1.5,
                       move_interval_s=0.0, capacity_weights=cap)
    try:
        for rep, load in zip(het, _load(3, stamps)):
            rep.load = load
            assert rep.plan_rebalance(now=10.0) is False
            assert rep._imbalance < raw and rep.boundary_moves == 0
        _same_placement(*het)
    finally:
        for rep in het:
            rep.close()


def test_shard_results_raises_after_forced_hot_move(tmp_path):
    """A flat shard_results overflows the hot shard into the exact
    fallback (counted alike); after a forced hot move the effective
    capacity rises alike in both packages and the hot query fits."""
    records = ref_rebalance._hot_records()
    flat = _seeded_pair(tmp_path, records, "flat", rebalance_ratio=0.0,
                        move_interval_s=0.0)
    try:
        got = [ref_rebalance._one_query(rep, [5000]) for rep in flat]
        assert got[0] == got[1] and len(got[1]) == 120
        fb = [rep._snapshots["isas"].base.overflow_fallbacks for rep in flat]
        assert fb[0] == fb[1] >= 1
        _same_stats(*flat)
    finally:
        for rep in flat:
            rep.close()
    auto = _seeded_pair(tmp_path, records, "auto", rebalance_ratio=1.2,
                        move_interval_s=0.0)
    try:
        stamps = ([(np.arange(0, 8000, 8, dtype=np.int32), 1.0)] * 10
                  + [(np.asarray([5000], np.int32), 50.0)] * 40)
        for rep, load in zip(auto, _load(3, stamps)):
            rep.load = load
            assert rep.plan_rebalance(now=5.0) is True
            assert rep.shard_results_effective > 48
            rep.refresh(plan=False)
            assert (rep._snapshots["isas"].base.shard_results
                    == rep.shard_results_effective)
        _same_placement(*auto)
        got = [ref_rebalance._one_query(rep, [5000]) for rep in auto]
        assert got[0] == got[1] == sorted(f"hot{i}" for i in range(120))
        _same_stats(*auto)
    finally:
        for rep in auto:
            rep.close()


def test_shard_results_env_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("DSS_SHARD_RESULTS", "96")
    wal = str(tmp_path / "env.wal")
    open(wal, "w").close()
    for mod, mesh in zip((rr, pr), _meshes()):
        rep = mod.ShardedReplica(mesh, wal_path=wal, max_results=256)
        assert rep.shard_results == 96
        rep.close()
        rep = mod.ShardedReplica(mesh, wal_path=wal, max_results=256,
                                 shard_results=40)
        assert rep.shard_results == 40
        rep.close()


def test_apply_boundaries_adopts_broadcast_shard_results(tmp_path):
    rng = np.random.default_rng(30)
    reps = _seeded_pair(tmp_path, ref_rebalance._mk_records(rng, 100), "fol")
    try:
        for rep in reps:
            rep.apply_boundaries(
                np.asarray([100, 200, 300, 400, 500, 600, 700], np.int32),
                bgen=3, shard_results=200)
            assert rep._build_shard_results() == 200
            rep.apply_boundaries(None, bgen=3, shard_results=None)
            assert rep.shard_results_effective == 200
        _same_placement(*reps)
        for rep in reps:
            rep.refresh(plan=False)
        _same_stats(*reps)
        for rep in reps:
            rep.reset_boundaries()
            assert rep.shard_results_effective is None
            assert rep._build_shard_results() == 48
        _same_placement(*reps)
    finally:
        for rep in reps:
            rep.close()


def test_env_knobs_parse_alike(monkeypatch):
    for name, fn in (("DSS_SHARD_REBALANCE_RATIO", "env_rebalance_ratio"),
                     ("DSS_SHARD_MOVE_INTERVAL_S", "env_move_interval_s")):
        monkeypatch.delenv(name, raising=False)
        assert getattr(pr, fn)() == getattr(rr, fn)()
        monkeypatch.setenv(name, "2.25")
        assert getattr(pr, fn)() == getattr(rr, fn)() == 2.25
        monkeypatch.setenv(name, "x")
        with pytest.raises(ValueError, match="not a float"):
            getattr(pr, fn)()
    assert pr.CLASSES == rr.CLASSES
    assert RRecord.__dataclass_fields__.keys() == (
        PRecord.__dataclass_fields__.keys())

"""The shared-memory serving front on the port: tests/test_shmring.py's
cases on the port's modules, then the port held to the reference byte
for byte and answer for answer.

The reference test file is compiled anew with its imports pointed at
the port (`dss_tpu.` -> `dss_tpu_torch.`), and every test function of
that copy is collected here under its own name, with its own fixtures
and assertions: region geometry and slot codecs, the fence broadcast,
the owner/worker round trips and their failure arms, the route
decision and cost model (plan/shmroute.py), and the in-process front
harness (leader DSSStore + WAL-tail replica + ring client).  Its
stores are the port's: `storage="tpu"` becomes `storage="cuda"` on
`device="cpu"` (the kernels' plain versions).

Then the cross-package checks:
  - a region that either package creates opens in the other, and the
    two packages' files are equal byte for byte (bar the owner's
    heartbeat and pid words);
  - a request or response that one package writes decodes to the same
    fields in the other, for every class and for the `None` fields,
    and both packages write the same slot bytes;
  - a reference worker client is served by a port owner over one
    region file, and the other way round;
  - the differential: both packages' leader + worker fronts on the same
    seeded writes, across folds, compactions and tombstones.  The
    worker-served answers equal each other and the leaders', with no
    tolerance.
"""

from __future__ import annotations

import re
import sys
import threading
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

from dss_tpu import chaos as r_chaos
from dss_tpu.parallel import shmring as R
from dss_tpu_torch import chaos as p_chaos
from dss_tpu_torch.dar.dss_store import DSSStore as PStore
from dss_tpu_torch.parallel import shmring as P

TESTS = Path(__file__).resolve().parent
SRC = TESTS / "test_shmring.py"


def _cpu_store(storage="memory", **kw):
    """The reference's DSSStore call on the port: the `tpu` backend is
    the port's `cuda` backend, here on the CPU."""
    if storage == "tpu":
        storage = "cuda"
    if storage == "cuda":
        kw.setdefault("device", "cpu")
    return PStore(storage=storage, **kw)


def _port_copy() -> dict:
    src = SRC.read_text()
    src = re.sub(r"\bdss_tpu\.", "dss_tpu_torch.", src)
    src = re.sub(r"\bfrom dss_tpu import\b", "from dss_tpu_torch import",
                 src)
    assert "dss_tpu." not in src.replace("dss_tpu_torch.", "")
    ns = {"__name__": "tests.test_shmring_on_the_port",
          "__file__": str(SRC)}
    exec(compile(src, str(SRC), "exec"), ns)
    ns["DSSStore"] = _cpu_store
    return ns


def _ref_module() -> dict:
    ns = {"__name__": "tests.test_shmring_reference", "__file__": str(SRC)}
    exec(compile(SRC.read_text(), str(SRC), "exec"), ns)
    return ns


PN = _port_copy()
RN = _ref_module()

_COPIED = []
for _k, _fn in PN.items():
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = _fn
        _COPIED.append(_k)
# the copy's fixtures: the autouse fault-plan reset and the front harness
front = PN["front"]
_port_clean_faults = PN["_clean_faults"]


@pytest.fixture(autouse=True)
def _clean_reference_faults():
    r_chaos.clear_plan()
    r_chaos.registry().reset_counters()
    yield
    r_chaos.clear_plan()
    r_chaos.registry().reset_counters()


def test_the_copied_cases_are_all_here():
    want = set(re.findall(r"^def (test_\w+)\(", SRC.read_text(), re.M))
    assert set(_COPIED) == want
    assert len(_COPIED) == 42


# -- the wire format, byte for byte --------------------------------------------

WIRE = (
    "MAGIC", "VERSION", "HEADER_BYTES", "WSTAT_BYTES", "FENCE_HDR_BYTES",
    "FREE", "REQ", "BUSY", "RESP", "ST_OK", "ST_OVERLOADED", "ST_DEADLINE",
    "ST_ERROR", "ST_OVERFLOW", "RESP_F_MESH_SERVED", "F_ALLOW_STALE",
    "F_HAS_ALT_LO", "F_HAS_T0", "F_HAS_T1", "F_HAS_OWNER", "F_HAS_ALT_HI",
    "WS_HEARTBEAT_NS", "WS_ENQUEUED", "WS_SERVED", "WS_CACHE_HITS",
    "WS_CACHE_MISSES", "WS_RING_FULL", "WS_TIMEOUTS", "WS_OVERSIZE",
    "WS_PROXY_FALLBACKS", "WS_ASSEMBLY_MISSES", "WS_WAIT_NS", "WS_ERRORS",
    "WS_PLAN_SHM", "WS_PLAN_PROXY", "WSTAT_NAMES", "_OWNER_MAX",
    "_OHDR_OFF", "OH_SERVED", "OH_ERRORS", "OH_DEADLINE_DROPS",
    "OH_OVERLOADED", "OH_RECLAIMED", "OH_SERVE_NS", "OH_DEAD_WORKERS",
    "_TRACE_OFF", "_TRACE_RESP_WORDS", "_TRACE_RESP_OFF", "_TRACE_BYTES",
    "TRACE_F_SAMPLED", "TRACE_F_PRESENT", "_PAYLOAD_OFF", "_REQ_FIXED",
    "_RESP_FIXED", "_SHIST_ROW", "_SHIST_WORDS", "SHIST_BLOCK_BYTES",
    "SHM_CLASSES",
)


def test_wire_constants_equal_the_reference():
    for name in WIRE:
        assert getattr(P, name) == getattr(R, name), name
    for name in ("_TRACE_REQ", "_TRACE_RESP", "_REQ_HDR", "_RESP_HDR"):
        assert getattr(P, name).format == getattr(R, name).format, name
    assert P.env_knobs() == R.env_knobs()
    assert P.empty_stats() == R.empty_stats()
    for tid in ("0" * 32, "f" * 32, "0af7651916cd43dd8448eb211c80319c"):
        assert P.tid_split(tid) == R.tid_split(tid)
        assert P.tid_join(*R.tid_split(tid)) == tid


# owner heartbeat (40) and pid (48): time and process, not format
_VOLATILE = (40, 56)


def _file_bytes(path) -> bytes:
    b = bytearray(Path(path).read_bytes())
    b[_VOLATILE[0]:_VOLATILE[1]] = bytes(_VOLATILE[1] - _VOLATILE[0])
    return bytes(b)


@pytest.mark.parametrize("geometry", [
    {"nworkers": 1},
    {"nworkers": 3, "depth": 8, "slot_bytes": 4096, "fence_slots": 1 << 10},
    {"nworkers": 2, "depth": 4, "fence_slots": 1 << 8, "nclasses": 3},
])
def test_region_files_are_byte_identical_and_open_across(tmp_path,
                                                          geometry):
    rp, pp = str(tmp_path / "ref.shm"), str(tmp_path / "port.shm")
    r = R.ShmRegion.create(rp, **geometry)
    p = P.ShmRegion.create(pp, **geometry)
    try:
        assert _file_bytes(rp) == _file_bytes(pp)
        for (mod, path), other in (((P, rp), r), ((R, pp), p)):
            o = mod.ShmRegion.open_existing(path)
            try:
                for attr in ("nworkers", "depth", "slot_bytes",
                             "fence_slots", "nclasses", "wstats_off",
                             "shist_off", "fence_off", "rings_off"):
                    assert getattr(o, attr) == getattr(other, attr), attr
                assert o.epoch_token == other.epoch_token == 0
                assert o.owner_heartbeat_age_s() < 60
            finally:
                o.close()
    finally:
        r.close()
        p.close()


def _requests():
    """Every class, all fields set, and every optional field unset."""
    out = []
    for i, cls in enumerate(R.SHM_CLASSES):
        out.append(dict(
            cls_idx=i, cells=np.asarray([5, 7 + i, (1 << 60) + i], np.uint64),
            alt_lo=10.5 + i, alt_hi=99.25, t0_ns=123 + i, t1_ns=456,
            now_ns=789, deadline_ns=1000 + i, owner=f"owner-{cls}",
            allow_stale=bool(i % 2),
            trace_id="0af7651916cd43dd8448eb211c80319c",
            trace_sampled=bool(i % 2 == 0),
        ))
        out.append(dict(
            cls_idx=i, cells=np.zeros(0, np.uint64), alt_lo=None,
            alt_hi=None, t0_ns=None, t1_ns=None, now_ns=5,
            deadline_ns=0, owner="", allow_stale=False,
        ))
    # one optional field at a time
    for field in ("alt_lo", "alt_hi", "t0_ns", "t1_ns"):
        kw = dict(cls_idx=2, cells=np.asarray([9], np.uint64), alt_lo=None,
                  alt_hi=None, t0_ns=None, t1_ns=None, now_ns=1,
                  deadline_ns=2, owner="", allow_stale=False)
        kw[field] = 0 if field.startswith("t") else 0.0
        out.append(kw)
    return out


def _req_fields(req) -> dict:
    d = {k: getattr(req, k) for k in req.__slots__}
    d["cells"] = np.asarray(d["cells"]).tolist()
    return d


def _pair(tmp_path, **geometry):
    rp, pp = str(tmp_path / "ref.shm"), str(tmp_path / "port.shm")
    return (R.ShmRegion.create(rp, **geometry), rp,
            P.ShmRegion.create(pp, **geometry), pp)


@pytest.mark.parametrize("k", range(len(_requests())))
def test_request_slots_are_byte_identical_and_decode_across(tmp_path, k):
    kw = _requests()[k]
    r, rp, p, pp = _pair(tmp_path, nworkers=2, depth=4)
    try:
        r.write_request(1, 2, 40 + k, **kw)
        p.write_request(1, 2, 40 + k, **kw)
        assert _file_bytes(rp) == _file_bytes(pp)
        # each package reads the other's file
        pr = P.ShmRegion.open_existing(rp)
        rr = R.ShmRegion.open_existing(pp)
        try:
            want = _req_fields(r.read_request(1, 2))
            assert _req_fields(pr.read_request(1, 2)) == want
            assert _req_fields(rr.read_request(1, 2)) == want
            assert want["cls"] == R.SHM_CLASSES[kw["cls_idx"]]
            assert want["req_id"] == 40 + k
        finally:
            pr.close()
            rr.close()
    finally:
        r.close()
        p.close()


def _responses():
    ids = [f"{i:08d}-0000-4000-8000-000000000000" for i in range(5)]
    return [
        dict(status=R.ST_OK, ids=ids, t1s=[10, 20, 30, 40, 50], wal_seq=77,
             gen=9, retry_after_s=1.5, flags=R.RESP_F_MESH_SERVED,
             trace_ns=[1, 2, 3, 4, 5, 6, 7, 8]),
        dict(status=R.ST_OK, ids=["ü-é"], t1s=[np.iinfo(np.int64).max],
             wal_seq=1, gen=2),
        dict(status=R.ST_OK),
        dict(status=R.ST_OVERLOADED, retry_after_s=2.25),
        dict(status=R.ST_DEADLINE, trace_ns=[5]),
        dict(status=R.ST_ERROR),
        # too large for a 4096-byte slot: both publish ST_OVERFLOW
        dict(status=R.ST_OK, ids=[f"id-{i:040d}" for i in range(200)],
             t1s=list(range(200))),
    ]


def _resp_fields(resp) -> dict:
    d = {k: getattr(resp, k) for k in resp.__slots__}
    d["t1s"] = np.asarray(d["t1s"]).tolist()
    d["trace_ns"] = list(d["trace_ns"])
    return d


@pytest.mark.parametrize("k", range(len(_responses())))
def test_response_slots_are_byte_identical_and_decode_across(tmp_path, k):
    kw = _responses()[k]
    r, rp, p, pp = _pair(tmp_path, nworkers=1, depth=2, slot_bytes=4096)
    try:
        r.write_response(0, 1, **kw)
        p.write_response(0, 1, **kw)
        assert _file_bytes(rp) == _file_bytes(pp)
        pr = P.ShmRegion.open_existing(rp)
        rr = R.ShmRegion.open_existing(pp)
        try:
            want = _resp_fields(r.read_response(0, 1))
            assert _resp_fields(pr.read_response(0, 1)) == want
            assert _resp_fields(rr.read_response(0, 1)) == want
            assert pr.read_response(0, 1).mesh_served == bool(
                kw.get("flags", 0)
            )
        finally:
            pr.close()
            rr.close()
    finally:
        r.close()
        p.close()


def test_fence_and_stats_segments_are_byte_identical(tmp_path):
    r, rp, p, pp = _pair(tmp_path, nworkers=2, depth=2, fence_slots=1 << 8)
    try:
        keys = np.asarray([3, 9, 300, 1 << 40], np.int64)
        for reg in (r, p):
            reg.fence_write_meta(1, inc=4, gen=0, floor=0, high=0)
            reg.fence_stamp(1, keys, 7)
            reg.fence_poison(3)
            reg.stat_add(0, R.WS_ENQUEUED, 3)
            reg.stat_add(1, R.WS_RING_FULL, 2)
            reg.bump_epoch_token()
        assert _file_bytes(rp) == _file_bytes(pp)
        # a worker of either package reads the other's fence
        pv = P.WorkerFenceView(P.ShmRegion.open_existing(rp))
        rv = R.WorkerFenceView(R.ShmRegion.open_existing(pp))
        for cls in R.SHM_CLASSES:
            assert pv.fence(cls, keys) == rv.fence(cls, keys)
        assert pv.fence("rid_sub", keys) == (4, 7, 7, 0)
        assert pv.epoch() == rv.epoch() == "1"
        assert P.front_stats(p) == R.front_stats(r)
    finally:
        r.close()
        p.close()


def test_fence_mirrors_publish_the_same_bytes(tmp_path):
    """Each package's CellClock + FenceMirror on the same bumps."""
    from dss_tpu.dar.tiers import CellClock as RClock
    from dss_tpu_torch.dar.tiers import CellClock as PClock

    r, rp, p, pp = _pair(tmp_path, nworkers=1, depth=2, fence_slots=1 << 10)
    try:
        clocks = []
        for mod, clock_cls, reg in ((R, RClock, r), (P, PClock, p)):
            c = clock_cls()
            c.bump(np.asarray([5], np.int64))  # before the attach
            c.attach_mirror(mod.FenceMirror(reg, 2))
            c.bump(np.asarray([11, 12], np.int64), None,
                   np.asarray([700], np.int64))
            c.bump_all()
            c.bump(np.asarray([13], np.int64))
            clocks.append(c)
        # the incarnation is a per-process counter of each package
        p._fence_hdrs[2][0] = r._fence_hdrs[2][0]
        assert _file_bytes(rp) == _file_bytes(pp)
        keys = np.asarray([5, 11, 13, 700], np.int64)
        f = P.WorkerFenceView(p).fence("op", keys)
        assert f[1:] == clocks[1].fence(keys)[1:] == clocks[0].fence(keys)[1:]
    finally:
        r.close()
        p.close()


@pytest.mark.parametrize("owner_pkg", ["port", "reference"])
def test_owner_of_one_package_serves_the_others_worker(tmp_path,
                                                       owner_pkg):
    O, W = (P, R) if owner_pkg == "port" else (R, P)
    path = str(tmp_path / "ring.shm")
    ro = O.ShmRegion.create(path, nworkers=1, depth=4)
    seen = []

    def serve(req):
        seen.append(req)
        return ([f"id-{len(req.cells)}", "id-x"], [7, 8],
                len(seen), R.RESP_F_MESH_SERVED)

    owner = O.ShmOwner(ro, serve, threads=2, wal_seq_fn=lambda: 41)
    owner.start()
    rw = W.ShmRegion.open_existing(path)
    client = W.ShmWorkerClient(rw, 0, wait_s=10.0)
    try:
        for cls in R.SHM_CLASSES:
            resp = client.call(
                cls=cls, cells=np.asarray([1, 2, 3], np.uint64),
                alt_lo=1.5, t1_ns=99, now_ns=12, owner="ua",
                trace_id="0af7651916cd43dd8448eb211c80319c",
            )
            assert resp.status == R.ST_OK
            assert resp.ids == ["id-3", "id-x"]
            assert resp.t1s.tolist() == [7, 8]
            assert resp.wal_seq == 41 and resp.mesh_served
        assert [q.cls for q in seen] == list(R.SHM_CLASSES)
        assert all(q.alt_hi is None and q.t0_ns is None and q.t1_ns == 99
                   and q.owner == "ua" and not q.trace_sampled
                   for q in seen)
        assert owner.stats()["dss_shm_served_total"] == 5
        assert client.stats()["enqueued"] == 5
    finally:
        client.close()
        owner.close()
        rw.close()
        ro.close()


def test_route_decisions_equal_the_reference():
    from dss_tpu.plan import shmroute as r_route
    from dss_tpu_torch.plan import shmroute as p_route

    rng = np.random.default_rng(11)
    for _ in range(400):
        kw = dict(
            est_shm_rtt_ms=float(rng.uniform(0.05, 20)),
            est_owner_serve_ms=float(rng.uniform(0.05, 10)),
            est_proxy_ms=float(rng.uniform(0.5, 15)),
            ring_in_flight=int(rng.integers(0, 70)),
            ring_depth=int(rng.choice([8, 64])),
            owner_threads=int(rng.integers(1, 5)),
            owner_alive=bool(rng.uniform() > 0.1),
            shm_attached=bool(rng.uniform() > 0.1),
        )
        head = None if rng.uniform() < 0.3 else float(rng.uniform(0, 30))
        want = r_route.decide_worker(r_route.WorkerState(**kw), head)
        got = p_route.decide_worker(p_route.WorkerState(**kw), head)
        assert (got.route, got.predicted_ms, got.reason) == (
            want.route, want.predicted_ms, want.reason)
    rm, pm = r_route.WorkerCostModel(), p_route.WorkerCostModel()
    for x in rng.uniform(0.01, 50, 64):
        rm.observe_shm(x)
        pm.observe_shm(x)
        rm.observe_proxy(2 * x)
        pm.observe_proxy(2 * x)
    assert pm.stats() == rm.stats()


# -- the differential: both packages' fronts on the same writes ----------------


def _step_writes(rng, h, ns, step, areas, live):
    """One seeded step of writes on harness `h` with the record
    builders of namespace `ns` (both packages draw the same numbers)."""
    k = int(rng.integers(0, len(areas)))
    roll = rng.uniform()
    if roll < 0.45 or not live:
        i = 3000 + step
        h.leader.rid.insert_isa(ns["_isa"](i, areas[k],
                                           owner=f"u{step % 3}"))
        h.leader.scd.upsert_operation(
            ns["_op"](5000 + step, areas[k], alt=(0.0, 60.0 + step)),
            key=[], key_checked=True,
        )
        live.append(i)
    elif roll < 0.7:
        i = live.pop(int(rng.integers(0, len(live))))
        got = h.leader.rid.get_isa(ns["_uuid"](i))
        if got is not None:
            h.leader.rid.delete_isa(got)
        op = h.leader.scd.get_operation(ns["_uuid"](5000 + i - 3000))
        if op is not None:
            h.leader.scd.delete_operation(op.id, op.owner)
    if step % 11 == 10:
        # the tier machinery mid-sequence: minor folds, then every
        # other round a full major compaction
        for index in (h.leader.rid._isa_index, h.leader.scd._op_index):
            t = index.table
            if (step // 11) % 2:
                t.compact()
            else:
                t.fold()


def _answers(h, ns, q):
    T0 = ns["T0"]
    e, l = T0 + timedelta(minutes=5), T0 + timedelta(hours=3)

    def sigs(recs):
        # the version as its string: each package has its own class
        return [(i, o, str(v), *t) for i, o, v, *t in ns["_sigs"](recs)]
    out = {}
    for side, rid, scd in (("leader", h.leader.rid, h.leader.scd),
                           ("worker", h.rid, h.scd)):
        out[side] = (
            sigs(rid.search_isas(q, e, None)),
            sigs(scd.search_operations(q, 10.0, 50.0, e, l)),
        )
    return out


def test_differential_both_packages_across_folds(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    hr = RN["_FrontHarness"](tmp_path / "r", storage="tpu", cache_cap=32)
    hp = PN["_FrontHarness"](tmp_path / "p", storage="tpu", cache_cap=32)
    rr, rp = np.random.default_rng(7), np.random.default_rng(7)
    try:
        areas = [RN["_cells"](2000 + 40 * k, 2024 + 40 * k)
                 for k in range(6)]
        lr, lp = [], []
        for step in range(66):
            _step_writes(rr, hr, RN, step, areas, lr)
            _step_writes(rp, hp, PN, step, areas, lp)
            hr.sync()
            hp.sync()
            k = int(rr.integers(0, len(areas)))
            assert k == int(rp.integers(0, len(areas)))
            a_r, a_p = _answers(hr, RN, areas[k]), _answers(hp, PN, areas[k])
            assert a_p["worker"] == a_p["leader"], step
            assert a_r["worker"] == a_r["leader"], step
            assert a_p["worker"] == a_r["worker"], step
        assert hp.front.cache.stats()["hits"] > 0, "cache never hit"
        assert hp.client.stats()["served"] > 0, "ring never served"
        assert (hp.client.stats()["served"]
                == hr.client.stats()["served"])
        # the tier machinery ran on both leaders
        assert hp.leader.rid._isa_index.stats()["folds"] > 0
    finally:
        hr.close()
        hp.close()


def _expiring_state(h, ns):
    """Every class with one record ending an hour after T0 and one
    ending eight hours after it."""
    T0, cells = ns["T0"], ns["_cells"](4000, 4016)
    end = (T0 + timedelta(hours=1), T0 + timedelta(hours=8))
    for j, e in enumerate(end):
        h.leader.rid.insert_isa(ns["_isa"](70 + j, cells, end=e))
        h.leader.rid.insert_subscription(ns["ridm"].Subscription(
            id=ns["_uuid"](78 + j), owner="ua", url="https://uss.example/s",
            cells=np.asarray(cells, np.uint64), start_time=T0, end_time=e,
            altitude_lo=0.0, altitude_hi=500.0,
        ))
        sub = ns["_scd_sub"](72 + j, cells, owner="ua")
        sub.end_time = e
        h.leader.scd.upsert_subscription(sub)
        op = ns["_op"](74 + j, cells, owner="ua", sub_id=ns["_uuid"](72 + j))
        op.end_time = e
        h.leader.scd.upsert_operation(op, key=[], key_checked=True)
        cst = ns["_cst"](76 + j, cells)
        cst.end_time = e
        h.leader.scd.upsert_constraint(cst)
    h.sync()
    return cells


@pytest.mark.parametrize("cls", R.SHM_CLASSES)
def test_shm_serve_pins_the_workers_now_as_the_reference(tmp_path, cls):
    """shm_serve pins the worker's clock instant on the sub-store's
    `_txn_time`: expiry at the ring's edge follows the worker's `now`,
    not the leader's clock, in both packages alike."""
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    hs = [(RN["_FrontHarness"](tmp_path / "r", storage="tpu"), RN, R),
          (PN["_FrontHarness"](tmp_path / "p", storage="tpu"), PN, P)]
    try:
        got = []
        for h, ns, mod in hs:
            cells = _expiring_state(h, ns)
            T0, to_ns = ns["T0"], ns["to_nanos"]
            out = []
            for hours in (0.5, 2.0, 9.0):
                now = to_ns(T0 + timedelta(hours=hours))
                req = mod.ShmRequest(
                    cls=cls, cells=cells, alt_lo=None, alt_hi=None,
                    t0_ns=now if cls == "isa" else None, t1_ns=None,
                    now_ns=now, deadline_ns=0,
                    owner="ua" if cls.endswith("sub") else None,
                    allow_stale=False,
                )
                ids, t1s, gen, flags = h.leader.shm_serve(req)
                out.append((list(ids), [int(t) for t in t1s], gen, flags))
                for sub in (h.leader.rid, h.leader.scd):
                    assert getattr(sub._txn_time, "now", None) is None
            got.append(out)
        assert got[1] == got[0]
        # the leader's FakeClock stays at T0 while the pinned instant
        # moves: two records live, then one, then none
        assert [len(o[0]) for o in got[1]] == [2, 1, 0]
    finally:
        for h, _, _ in hs:
            h.close()


def test_concurrent_workers_of_both_packages_share_one_owner(tmp_path):
    """A port owner over a two-worker region: worker 0 speaks the
    reference's client, worker 1 the port's, each from four threads."""
    path = str(tmp_path / "ring.shm")
    ro = P.ShmRegion.create(path, nworkers=2, depth=4)
    owner = P.ShmOwner(ro, lambda req: ([str(int(req.cells[0]))],
                                        [int(req.now_ns)], 0), threads=2)
    owner.start()
    clients = [R.ShmWorkerClient(R.ShmRegion.open_existing(path), 0,
                                 wait_s=10.0),
               P.ShmWorkerClient(P.ShmRegion.open_existing(path), 1,
                                 wait_s=10.0)]
    bad = []

    def run(c, t):
        for j in range(30):
            v = 1000 * t + j
            try:
                resp = c.call(cls="isa", cells=np.asarray([v], np.uint64),
                              now_ns=v)
            except (R.RingFull, P.RingFull):
                continue
            if resp.ids != [str(v)] or resp.t1s.tolist() != [v]:
                bad.append((t, j))

    threads = [threading.Thread(target=run, args=(clients[t % 2], t))
               for t in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        st = owner.stats()
        assert st["dss_shm_served_total"] > 0
        assert st["dss_shm_slots_in_flight"] == 0
    finally:
        sys.setswitchinterval(switch)
        for c in clients:
            c.close()
        owner.close()
        ro.close()


def test_chaos_sites_fire_in_the_port(tmp_path):
    """The port's fault seams: an injected enqueue fault raises before
    any slot is touched."""
    r = P.ShmRegion.create(str(tmp_path / "r.shm"), nworkers=1, depth=2)
    c = P.ShmWorkerClient(r, 0, wait_s=0.1)
    try:
        p_chaos.install_plan(
            {"events": [{"site": "shm.ring.enqueue", "count": 1}]})
        with pytest.raises(p_chaos.FaultError):
            c.call(cls="op", cells=np.zeros(1, np.uint64), now_ns=0)
        assert c.stats()["enqueued"] == 0 and c.in_flight() == 0
    finally:
        c.close()
        r.close()

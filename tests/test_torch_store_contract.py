"""The port's DSSStore against the reference's, scenario by scenario.

Each scenario of tests/test_store_contract.py runs twice: on the
reference's `DSSStore(storage="tpu")` and on the port's store (the
`memory` backend, and the `cuda` backend on `device="cpu"`, where every
kernel wrapper takes its plain version), each under its own FakeClock
started at the same instant.  The scenario keeps the reference test's
own assertions, and every value it observes (records as codec docs,
versions, OVNs, error codes, messages and details) goes into a log;
the two logs must be equal, with no tolerance.
"""

from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

from dss_tpu import errors as r_errors
from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar import codec as r_codec
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.geo import covering as r_covering
from dss_tpu.models import rid as r_ridm
from dss_tpu.models import scd as r_scdm
from dss_tpu.models.core import Version as RVersion
from dss_tpu_torch import errors as p_errors
from dss_tpu_torch.clock import FakeClock as PFakeClock
from dss_tpu_torch.dar import codec as p_codec
from dss_tpu_torch.dar.dss_store import DSSStore as PStore
from dss_tpu_torch.geo import covering as p_covering
from dss_tpu_torch.models import rid as p_ridm
from dss_tpu_torch.models import scd as p_scdm
from dss_tpu_torch.models.core import Version as PVersion

T0 = datetime(2026, 7, 1, 12, 0, 0, tzinfo=timezone.utc)

REF = SimpleNamespace(
    errors=r_errors, FakeClock=RFakeClock, codec=r_codec, Store=RStore,
    covering=r_covering, ridm=r_ridm, scdm=r_scdm, Version=RVersion,
)
PORT = SimpleNamespace(
    errors=p_errors, FakeClock=PFakeClock, codec=p_codec, Store=PStore,
    covering=p_covering, ridm=p_ridm, scdm=p_scdm, Version=PVersion,
)
BACKENDS = ("memory", "cuda")


def cells_at(p, lat, lng, half=0.03):
    return p.covering.covering_polygon(
        [
            (lat - half, lng - half),
            (lat - half, lng + half),
            (lat + half, lng + half),
            (lat + half, lng - half),
        ]
    )


def make_store(p, backend, **kw):
    """-> (store, fake clock).  The reference always runs its "tpu"
    backend; the port runs `backend` ("cuda" on the CPU)."""
    clock = p.FakeClock(T0)
    if p is REF:
        return p.Store(storage="tpu", clock=clock, **kw), clock
    if backend == "cuda":
        kw["device"] = "cpu"
    return p.Store(storage=backend, clock=clock, **kw), clock


def norm(p, x):
    """A store result as plain data: records as their codec docs (an
    SCD subscription with its dependent operations), errors as
    (code, message, details)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [norm(p, v) for v in x]
    if isinstance(x, p.ridm.IdentificationServiceArea):
        return ("isa", p.codec.isa_to_doc(x))
    if isinstance(x, p.ridm.Subscription):
        return ("rid_sub", p.codec.rid_sub_to_doc(x))
    if isinstance(x, p.scdm.Operation):
        return ("op", p.codec.op_to_doc(x))
    if isinstance(x, p.scdm.Subscription):
        return ("scd_sub", p.codec.scd_sub_to_doc(x),
                list(x.dependent_operations or []))
    if isinstance(x, p.scdm.Constraint):
        return ("constraint", p.codec.constraint_to_doc(x))
    if isinstance(x, p.errors.StatusError):
        return ("err", int(x.code), x.message, norm(p, x.details))
    raise TypeError(f"no normal form for {type(x)!r}")


class Run:
    """One package's side of a scenario: its store, clock, models and
    the log of everything observed."""

    def __init__(self, p, backend):
        self.p = p
        self.store, self.clock = make_store(p, backend)
        self.log = []
        self.A = cells_at(p, 34.0, -118.0)
        self.B = cells_at(p, 34.06, -118.0)  # overlaps A in part
        self.FAR = cells_at(p, -33.9, 151.2)

    def ok(self, fn, *a, **kw):
        out = fn(*a, **kw)
        self.log.append(("ok", norm(self.p, out)))
        return out

    def err(self, fn, *a, **kw):
        with pytest.raises(self.p.errors.StatusError) as ei:
            fn(*a, **kw)
        self.log.append(norm(self.p, ei.value))
        return ei.value

    def isa(self, id="00000000-0000-4000-8000-000000000001", owner="uss1",
            cells=None):
        return self.p.ridm.IdentificationServiceArea(
            id=id, owner=owner, url="https://uss1.example.com/flights",
            cells=self.A if cells is None else cells,
            start_time=T0, end_time=T0 + timedelta(hours=2),
        )

    def rid_sub(self, id="00000000-0000-4000-8000-00000000s001",
                owner="uss2", cells=None):
        return self.p.ridm.Subscription(
            id=id, owner=owner,
            url="https://uss2.example.com/identification_service_areas",
            cells=self.A if cells is None else cells,
            start_time=T0, end_time=T0 + timedelta(hours=4),
        )

    def op(self, id="00000000-0000-4000-8000-0000000000a1", owner="uss1",
           cells=None, state=None, sub_id="sub-1"):
        scdm = self.p.scdm
        return scdm.Operation(
            id=id, owner=owner, start_time=T0,
            end_time=T0 + timedelta(hours=1),
            altitude_lower=50.0, altitude_upper=120.0,
            uss_base_url="https://uss1.example.com",
            state=scdm.OperationState.ACCEPTED if state is None else state,
            cells=self.A if cells is None else cells,
            subscription_id=sub_id,
        )

    def scd_sub(self, id="00000000-0000-4000-8000-0000000000b1",
                owner="uss1", cells=None):
        return self.p.scdm.Subscription(
            id=id, owner=owner, start_time=T0,
            end_time=T0 + timedelta(hours=6),
            base_url="https://uss1.example.com",
            notify_for_operations=True,
            cells=self.A if cells is None else cells,
        )


# -- the 15 scenarios of tests/test_store_contract.py ------------------------


def isa_insert_search_delete(r):
    s = r.store
    isa = r.ok(s.rid.insert_isa, r.isa())
    assert isa.version is not None and not isa.version.empty
    found = r.ok(s.rid.search_isas, r.A, earliest=T0, latest=None)
    assert [f.id for f in found] == [isa.id]
    assert r.ok(s.rid.search_isas, r.FAR, earliest=T0, latest=None) == []
    stale = r.isa()
    stale.version = r.p.Version.from_time(T0 - timedelta(days=1))
    assert r.ok(s.rid.delete_isa, stale) is None
    good = r.isa()
    good.version = isa.version
    assert r.ok(s.rid.delete_isa, good) is not None
    assert r.ok(s.rid.search_isas, r.A, earliest=T0, latest=None) == []


def isa_fenced_update(r):
    s = r.store
    v1 = r.ok(s.rid.insert_isa, r.isa())
    upd = r.isa(cells=r.B)
    upd.version = v1.version
    v2 = r.ok(s.rid.insert_isa, upd)
    assert v2 is not None and not v2.version.matches(v1.version)
    upd2 = r.isa()
    upd2.version = v1.version
    assert r.ok(s.rid.insert_isa, upd2) is None
    ids_b = [i.id for i in r.ok(s.rid.search_isas, r.B, earliest=T0,
                                latest=None)]
    assert ids_b == [v1.id]


def isa_search_time_window(r):
    s = r.store
    r.ok(s.rid.insert_isa, r.isa())
    late = T0 + timedelta(hours=3)
    assert r.ok(s.rid.search_isas, r.A, earliest=late, latest=None) == []
    found = r.ok(s.rid.search_isas, r.A, earliest=T0,
                 latest=T0 + timedelta(minutes=30))
    assert [f.id for f in found] == [r.isa().id]
    late_isa = r.isa(id="00000000-0000-4000-8000-000000000002")
    late_isa.start_time = T0 + timedelta(hours=1)
    late_isa.end_time = T0 + timedelta(hours=2)
    r.ok(s.rid.insert_isa, late_isa)
    found = r.ok(s.rid.search_isas, r.A, earliest=T0,
                 latest=T0 + timedelta(minutes=30))
    assert [f.id for f in found] == [r.isa().id]


def isa_search_validation(r):
    r.err(r.store.rid.search_isas, np.array([], np.uint64), earliest=T0,
          latest=None)


def rid_subscription_lifecycle_and_fanout(r):
    s = r.store
    sub = r.ok(s.rid.insert_subscription, r.rid_sub())
    assert sub.notification_index == 0
    bumped = r.ok(s.rid.update_notification_idxs_in_cells, r.A)
    assert [b.id for b in bumped] == [sub.id]
    assert bumped[0].notification_index == 1
    assert r.ok(s.rid.update_notification_idxs_in_cells, r.FAR) == []
    mine = r.ok(s.rid.search_subscriptions_by_owner, r.A, "uss2")
    assert [m.id for m in mine] == [sub.id]
    assert r.ok(s.rid.search_subscriptions_by_owner, r.A, "ussX") == []
    d = r.rid_sub()
    d.version = sub.version
    assert r.ok(s.rid.delete_subscription, d) is not None


def rid_subscription_expiry_filtered(r):
    s = r.store
    sub = r.rid_sub()
    sub.end_time = T0 + timedelta(minutes=10)
    r.ok(s.rid.insert_subscription, sub)
    r.clock.advance(minutes=30)
    assert r.ok(s.rid.search_subscriptions, r.A) == []
    assert r.ok(s.rid.update_notification_idxs_in_cells, r.A) == []


def rid_quota_count(r):
    s = r.store
    for k in range(4):
        r.ok(s.rid.insert_subscription,
             r.rid_sub(id=f"00000000-0000-4000-8000-00000000s10{k}"))
    count = s.rid.max_subscription_count_in_cells_by_owner
    assert r.ok(count, r.A, "uss2") == 4
    assert r.ok(count, r.A, "other") == 0
    assert r.ok(count, r.FAR, "uss2") == 0


def scd_upsert_requires_ovns_of_overlapping_ops(r):
    s = r.store
    op1, _ = r.ok(s.scd.upsert_operation, r.op(), key=[])
    assert op1.version == 1 and op1.ovn
    op2 = r.op(id="00000000-0000-4000-8000-0000000000a2", owner="uss2")
    e = r.err(s.scd.upsert_operation, op2, key=[])
    assert e.code == r.p.errors.Code.MISSING_OVNS
    assert [o.id for o in e.details] == [op1.id]
    op2b, _ = r.ok(
        s.scd.upsert_operation,
        r.op(id="00000000-0000-4000-8000-0000000000a2", owner="uss2"),
        key=[op1.ovn],
    )
    assert op2b.version == 1


def scd_upsert_fencing(r):
    s = r.store
    Code = r.p.errors.Code
    op1, _ = r.ok(s.scd.upsert_operation, r.op(), key=[])
    e = r.err(s.scd.upsert_operation, r.op(), key=[op1.ovn])
    assert e.code == Code.ALREADY_EXISTS
    upd = r.op()
    upd.version = 7
    assert r.err(s.scd.upsert_operation, upd, key=[op1.ovn]).code == (
        Code.ABORTED
    )
    upd = r.op(owner="intruder")
    upd.version = 1
    assert r.err(s.scd.upsert_operation, upd, key=[op1.ovn]).code == (
        Code.PERMISSION_DENIED
    )
    upd = r.op()
    upd.version = 1
    op2, _ = r.ok(s.scd.upsert_operation, upd, key=[op1.ovn])
    assert op2.version == 2


def scd_non_conforming_skips_key_check(r):
    s = r.store
    r.ok(s.scd.upsert_operation, r.op(), key=[])
    op2 = r.op(id="00000000-0000-4000-8000-0000000000a3", owner="uss3",
               state=r.p.scdm.OperationState.NON_CONFORMING)
    got, _ = r.ok(s.scd.upsert_operation, op2, key=[])
    assert got.version == 1


def scd_delete_and_implicit_sub_gc(r):
    s = r.store
    sub, _ = r.ok(
        s.scd.upsert_subscription,
        r.p.scdm.Subscription(
            id="00000000-0000-4000-8000-0000000000c1", owner="uss1",
            start_time=T0, end_time=T0 + timedelta(hours=6),
            base_url="https://uss1.example.com",
            implicit_subscription=True, notify_for_operations=True,
            cells=r.A,
        ),
    )
    op, _ = r.ok(s.scd.upsert_operation, r.op(sub_id=sub.id), key=[])
    r.err(s.scd.delete_operation, op.id, "intruder")
    deleted, _ = r.ok(s.scd.delete_operation, op.id, "uss1")
    assert deleted.id == op.id
    r.err(s.scd.get_subscription, sub.id, "uss1")


def scd_expired_op_invisible(r):
    s = r.store
    op, _ = r.ok(s.scd.upsert_operation, r.op(), key=[])
    r.clock.advance(hours=2)
    r.err(s.scd.get_operation, op.id)
    op2, _ = r.ok(
        s.scd.upsert_operation,
        r.op(id="00000000-0000-4000-8000-0000000000a4", owner="uss2"),
        key=[],
    )
    assert op2.version == 1


def scd_subscription_quota(r):
    s = r.store
    for k in range(10):
        r.ok(s.scd.upsert_subscription,
             r.scd_sub(id=f"00000000-0000-4000-8000-0000000000d{k}"))
    e = r.err(s.scd.upsert_subscription,
              r.scd_sub(id="00000000-0000-4000-8000-0000000000dA"))
    assert e.code == r.p.errors.Code.RESOURCE_EXHAUSTED
    got, _ = r.ok(
        s.scd.upsert_subscription,
        r.scd_sub(id="00000000-0000-4000-8000-0000000000dB", owner="uss9"),
    )
    assert got.version == 1


def scd_subscription_delete_blocked_by_dependent_op(r):
    s = r.store
    sub, _ = r.ok(s.scd.upsert_subscription, r.scd_sub())
    r.ok(s.scd.upsert_operation, r.op(sub_id=sub.id), key=[])
    e = r.err(s.scd.delete_subscription, sub.id, "uss1", sub.version)
    assert e.code == r.p.errors.Code.INVALID_ARGUMENT
    r.ok(s.scd.delete_operation, r.op().id, "uss1")
    got = r.ok(s.scd.delete_subscription, sub.id, "uss1", sub.version)
    assert got.id == sub.id


def scd_subscription_search_and_notify(r):
    s = r.store
    sub, affected = r.ok(s.scd.upsert_subscription, r.scd_sub())
    assert affected == []
    op, notified = r.ok(s.scd.upsert_operation, r.op(sub_id=sub.id), key=[])
    assert [n.id for n in notified] == [sub.id]
    assert notified[0].notification_index == 1
    found = r.ok(s.scd.search_subscriptions, r.A, "uss1")
    assert [f.id for f in found] == [sub.id]
    assert found[0].dependent_operations == [op.id]
    assert r.ok(s.scd.search_subscriptions, r.FAR, "uss1") == []
    r.err(s.scd.get_subscription, sub.id, "someone-else")


SCENARIOS = [
    isa_insert_search_delete,
    isa_fenced_update,
    isa_search_time_window,
    isa_search_validation,
    rid_subscription_lifecycle_and_fanout,
    rid_subscription_expiry_filtered,
    rid_quota_count,
    scd_upsert_requires_ovns_of_overlapping_ops,
    scd_upsert_fencing,
    scd_non_conforming_skips_key_check,
    scd_delete_and_implicit_sub_gc,
    scd_expired_op_invisible,
    scd_subscription_quota,
    scd_subscription_delete_blocked_by_dependent_op,
    scd_subscription_search_and_notify,
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_reference(scenario, backend):
    ref, port = Run(REF, backend), Run(PORT, backend)
    try:
        assert port.A.tolist() == ref.A.tolist()
        scenario(ref)
        scenario(port)
        assert port.log == ref.log
        assert port.store.stats()["dss_cache_misses"] == (
            ref.store.stats()["dss_cache_misses"]
        )
    finally:
        ref.store.close()
        port.store.close()


# -- the store's surface ------------------------------------------------------

# the graph-replay counters the port's coalescer adds
GRAPH_KEYS = {
    f"dss_dar_{cls}_co_res_graph_{k}"
    for cls in ("isa", "rid_sub", "op", "scd_sub", "constraint")
    for k in ("busy", "captures", "capture_failures")
}


@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_keep_the_reference_key_set(backend):
    ref = RStore(storage="tpu" if backend == "cuda" else "memory")
    port, _ = make_store(PORT, backend)
    try:
        r, p = ref.stats(), port.stats()
        extra = GRAPH_KEYS if backend == "cuda" else set()
        assert set(p) == set(r) | extra
        # the empty attachment families keep their types and values
        for k in r:
            if k.startswith(("dss_fed_", "dss_shm_", "dss_push_",
                             "dss_tune_")):
                assert p[k] == r[k], k
        f_r, f_p = ref.freshness_status(), port.freshness_status()
        assert set(f_p) == set(f_r)
        assert f_p["classes"] == f_r["classes"]
        assert f_p["degraded_mode"] == f_r["degraded_mode"] == "healthy"
    finally:
        ref.close()
        port.close()


def test_storage_choices():
    with pytest.raises(ValueError, match="unknown storage backend"):
        PStore(storage="tpu")
    # device=None means cuda: without a card the default raises
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PStore(storage="cuda")
    s = PStore(storage="cuda", device="cpu")
    try:
        assert s.storage == "cuda"
        assert str(s.scd._op_index.table.device) == "cpu"
        assert s.scd._op_index.coalescer is not None
    finally:
        s.close()


def test_later_slices_raise():
    # region mode is ported (tests/test_torch_region.py); as in the
    # reference, it takes no local WAL
    with pytest.raises(ValueError, match="wal_path is unused"):
        PStore(storage="memory", region_url="http://localhost:1",
               wal_path="x.wal")
    s = PStore(storage="memory")
    try:
        assert s.region is None and not s.rid._capture_undo
        with pytest.raises(NotImplementedError, match="tuner slice"):
            s.attach_tuner(None)
        # the mesh slice is ported: a memory store has no coalescer to
        # take a delegate, and the replica adopts the store's load map
        # (tests/test_torch_replica.py drives a cuda store's offload)
        adopted = []

        class Replica:
            def use_load(self, load):
                adopted.append(load)

        s.attach_mesh_replica(Replica())
        assert adopted == [s.range_load]
    finally:
        s.close()
    # the federation slice is ported (tests/test_torch_federation.py):
    # attaching a router wraps rid/scd and fills the dss_fed_* gauges
    # as the reference's store does
    from dss_tpu.region import federation as r_fed
    from dss_tpu_torch.region import federation as p_fed

    got = {}
    for name, store_cls, fed in (("ref", RStore, r_fed),
                                 ("port", PStore, p_fed)):
        st = store_cls(storage="memory")
        try:
            plain = {k: v for k, v in st.stats().items()
                     if k.startswith("dss_fed_")}
            assert plain == fed.empty_stats()
            assert st.freshness_status()["federation"] is None
            entries = [fed.RegionEntry("a"), fed.RegionEntry("b")]
            router = fed.FederationRouter(
                fed.FederationMap(entries, np.array([1000], np.int32), "a"),
                {"b": fed.FederationPeer("b", lambda *a: {})},
            )
            st.attach_federation(router)
            router.close()
            assert isinstance(st.rid, fed.FederatedRIDStore)
            assert isinstance(st.scd, fed.FederatedSCDStore)
            assert st.federation is router
            with pytest.raises(RuntimeError, match="already attached"):
                st.attach_federation(router)
            stats = {k: v for k, v in st.stats().items()
                     if k.startswith("dss_fed_")}
            assert set(stats) == set(fed.empty_stats())
            status = st.freshness_status()["federation"]
            got[name] = (stats, {k: v for k, v in status.items()})
        finally:
            st.close()
    assert got["port"] == got["ref"]
    assert got["port"][0]["dss_fed_peer_state"] == {"b": 0.0}


def test_device_loss_recovery_rewarms_through_the_ladder():
    """The store hands its ladder to every coalescer, and leaving
    DEVICE_LOST runs the re-warm hook (warm_resident) before the
    condition clears, as the reference's does."""
    s = PStore(storage="cuda", device="cpu")
    try:
        for index, _ in s._class_indexes():
            assert index.coalescer._health is s.health
        calls = []
        s.warm_resident = lambda: calls.append(1) or 0
        s.health.enter("device_lost", "test")
        assert s.health.mode_name() == "device_lost"
        s.health.exit("device_lost")
        assert calls == [1]
        assert s.health.mode_name() == "healthy"
    finally:
        s.close()

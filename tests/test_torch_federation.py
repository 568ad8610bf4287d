"""The federation on the port, held to the reference.

Every case of tests/test_federation.py runs on the port's modules: the
reference test file is compiled anew with its imports pointed at the
port (`dss_tpu.` -> `dss_tpu_torch.`), and each of its test functions
is collected here under its own name, once with the regions on
`storage="memory"` and once on `storage="cuda"` with `device="cpu"`
(the DAR tables' plain versions, B1's among them); the two that feed
`plan.autotune`'s scenario shapes and capacity vector to the map
planner run on the port's autotune.  The port's copy of the
epoch-probe case raises the region client's
`TransportError` where the reference raises a `requests` error.

Then the two packages side by side and mixed:
- the same two-region script on both packages (fake monotonic clocks
  for breakers and mirrors, equal FakeClocks for the stores): equal
  answers, notes, X-DSS-Freshness headers, statuses, gauges and ladder
  edges, the reference on `memory` and `tpu` (JAX's CPU), the port on
  `memory` and `cuda` on the CPU;
- a port region federated with a reference region in-process, each
  transport calling the other package's serve_query / serve_sync
  through JSON;
- the reference's HttpPeerTransport against the port's
  /aux/v1/federation/* on a live socket and the port's http.client
  transport against the reference's app, with the transports'
  failure classes compared;
- drains of 128 through two federated cuda-on-CPU stores take the
  `device` route on both regions, with the answers of the reference's
  `tpu` stores;
- the push pipeline's `@region:` hop through a real FederationRouter.
Every global query equals a merged-state oracle exactly.
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from datetime import datetime, timedelta, timezone
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import requests

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu import errors as r_errors
from dss_tpu.api.app import build_app as r_build_app
from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar import codec as r_codec
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.geo import covering as r_covering
from dss_tpu.geo.s2cell import cell_to_dar_key as r_cell_to_key
from dss_tpu.geo.s2cell import dar_key_to_cell as r_key_to_cell
from dss_tpu.models import rid as r_ridm
from dss_tpu.models import scd as r_scdm
from dss_tpu.push import PushPipeline as RPush
from dss_tpu.region import federation as r_fed
from dss_tpu.services.rid import RIDService as RRIDService
from dss_tpu.services.scd import SCDService as RSCDService
from dss_tpu_torch import errors as p_errors
from dss_tpu_torch.api.app import build_app as p_build_app
from dss_tpu_torch.clock import FakeClock as PFakeClock
from dss_tpu_torch.dar import codec as p_codec
from dss_tpu_torch.dar.dss_store import DSSStore as PStore
from dss_tpu_torch.geo.s2cell import dar_key_to_cell as p_key_to_cell
from dss_tpu_torch.models import rid as p_ridm
from dss_tpu_torch.models import scd as p_scdm
from dss_tpu_torch.push import PushPipeline as PPush
from dss_tpu_torch.region import federation as p_fed
from dss_tpu_torch.services.rid import RIDService as PRIDService
from dss_tpu_torch.services.scd import SCDService as PSCDService
from tests.live_server import LiveServer
from tests.test_torch_region import port_copy

TESTS = Path(__file__).resolve().parent
STORAGES = ("memory", "cuda")

PORT_CASES = port_copy("test_federation", extra={
    'raise __import__("requests").exceptions.ConnectionError("down")':
    'raise __import__("dss_tpu.region.client",'
    ' fromlist=["TransportError"]).TransportError("down")',
})
_PortStore = PORT_CASES["DSSStore"]
_STORAGE = {"mode": "memory"}  # the storage of the copied cases' stores


def _store(*, storage, **kw):
    """The copied cases' DSSStore: "memory" follows the case's
    parametrised storage; `cuda` runs on the CPU."""
    if storage == "memory":
        storage = _STORAGE["mode"]
    if storage == "cuda":
        kw["device"] = "cpu"
    return _PortStore(storage=storage, **kw)


PORT_CASES["DSSStore"] = _store


@pytest.fixture(params=STORAGES)
def storage(request):
    _STORAGE["mode"] = request.param
    yield request.param
    _STORAGE["mode"] = "memory"


# the copied fixtures, under their own names (they build the port's stores)
two_regions = PORT_CASES["two_regions"]
fed_http = PORT_CASES["fed_http"]

_COPIED = []
for _k, _fn in list(PORT_CASES.items()):
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = pytest.mark.usefixtures("storage")(_fn)
        _COPIED.append(_k)


def test_every_reference_case_is_here():
    src = (TESTS / "test_federation.py").read_text()
    want = set(re.findall(r"^def (test_\w+)\(", src, re.M))
    assert want == set(_COPIED)
    assert len(_COPIED) == 22


# -- the two packages --------------------------------------------------------

REF = SimpleNamespace(
    name="ref", fed=r_fed, Store=RStore, FakeClock=RFakeClock,
    codec=r_codec, key_to_cell=r_key_to_cell, ridm=r_ridm, scdm=r_scdm,
    build_app=r_build_app, RIDService=RRIDService, SCDService=RSCDService,
    Push=RPush,
)
PORT = SimpleNamespace(
    name="port", fed=p_fed, Store=PStore, FakeClock=PFakeClock,
    codec=p_codec, key_to_cell=p_key_to_cell, ridm=p_ridm, scdm=p_scdm,
    build_app=p_build_app, RIDService=PRIDService, SCDService=PSCDService,
    Push=PPush,
)
START = datetime(2026, 3, 1, tzinfo=timezone.utc)
T0 = START + timedelta(minutes=5)
T1 = T0 + timedelta(hours=24)
# a geographic strip whose covering spans both regions once the map's
# boundary sits at its median key (as the reference's HTTP case does)
STRIP = "40.0,-100.0,41.02,-100.0,41.02,-99.99,40.0,-99.99"
_STRIP_CELLS = r_covering.area_to_cell_ids(STRIP)
_STRIP_KEYS = np.sort(r_cell_to_key(_STRIP_CELLS).astype(np.int64))
BOUNDARY = int(_STRIP_KEYS[len(_STRIP_KEYS) // 2])
LOW = _STRIP_KEYS[_STRIP_KEYS < BOUNDARY]
HIGH = _STRIP_KEYS[_STRIP_KEYS >= BOUNDARY]


def _uid(n: int) -> str:
    return str(uuid.UUID(int=n + 1, version=4))


def _make_store(ns, storage, clock):
    if ns is PORT and storage == "cuda":
        return ns.Store(storage="cuda", device="cpu", clock=clock)
    return ns.Store(storage=storage, clock=clock)


def _isa(ns, n, keys, owner="uss1"):
    return ns.ridm.IdentificationServiceArea(
        id=_uid(n), owner=owner, url="https://uss1.example/flights",
        cells=ns.key_to_cell(np.asarray(keys, np.int64)),
        start_time=T0, end_time=T1, altitude_lo=0.0, altitude_hi=3000.0,
    )


def _rid_sub(ns, n, keys, owner="uss1"):
    return ns.ridm.Subscription(
        id=_uid(300 + n), owner=owner, url="https://uss1.example/s",
        cells=ns.key_to_cell(np.asarray(keys, np.int64)),
        start_time=T0, end_time=T1, altitude_lo=0.0, altitude_hi=3000.0,
    )


def _constraint(ns, n, keys):
    return ns.scdm.Constraint(
        id=_uid(500 + n), owner="uss1",
        uss_base_url="https://uss1.example/c",
        cells=ns.key_to_cell(np.asarray(keys, np.int64)),
        start_time=T0, end_time=T1,
        altitude_lower=0.0, altitude_upper=3000.0,
    )


def _inproc(ns, routers, name, *, wire=False):
    """Peer transport by direct call into `ns`'s serve_query/serve_sync
    (through JSON when `wire`, as a socket would carry it)."""

    def transport(method, path, payload):
        if wire:
            payload = json.loads(json.dumps(payload))
        if path.endswith("/query"):
            out = ns.fed.serve_query(routers[name], payload)
        else:
            out = ns.fed.serve_sync(routers[name])
        return json.loads(json.dumps(out)) if wire else out

    return transport


def _attach_quiet(store, router):
    """store.attach_federation(router) without the sync loop's first
    pass, which would race the other region's attach: these tests
    drive every sync by hand, so their counters compare exactly."""
    router.start = lambda: None
    try:
        store.attach_federation(router)
    finally:
        del router.start


def _dead(*a):
    raise r_fed.PeerError("injected partition")


def _status(fn, *a, **kw):
    """A call -> ("ok", value) or (http status, code, retry-after)."""
    try:
        return ("ok", fn(*a, **kw))
    except (r_errors.StatusError, p_errors.StatusError) as e:
        return (e.http_status, int(e.code),
                getattr(e, "retry_after_s", None))


def _docs(recs, to_doc):
    return sorted((json.dumps(to_doc(r), sort_keys=True) for r in recs))


def _ladder(store):
    return (store.health.mode_name(), sorted(store.health.active()))


def _fed_stats(store):
    return {k: v for k, v in store.stats().items()
            if k.startswith("dss_fed_")}


def _scenario(ns, storage):
    """One two-region script; every observation in order."""
    mono = [100.0]

    def tick():
        return mono[0]

    entries = [ns.fed.RegionEntry("a", urls=("http://a.example",)),
               ns.fed.RegionEntry("b", urls=("http://b.example",))]
    routers, stores = {}, {}
    for local, remote in (("a", "b"), ("b", "a")):
        fmap = ns.fed.FederationMap(
            entries, np.array([BOUNDARY], np.int32), local)
        routers[local] = ns.fed.FederationRouter(
            fmap,
            {remote: ns.fed.FederationPeer(
                remote, _inproc(ns, routers, remote), fail_threshold=3,
                reset_s=0.3, clock=tick)},
            stale_lag_s=5.0, clock=tick,
        )
        stores[local] = _make_store(ns, storage, ns.FakeClock(START))
        _attach_quiet(stores[local], routers[local])
    sa, sb = stores["a"], stores["b"]
    ra, rb = routers["a"], routers["b"]
    isa_doc, cst_doc = ns.codec.isa_to_doc, ns.codec.constraint_to_doc
    obs = []

    def note():
        n = ns.fed.take_fed_note()
        return None if n is None else dict(n, lag_s=round(n["lag_s"], 6))

    def search(store, cells, **kw):
        out = _status(store.rid.search_isas, cells, T0, None, **kw)
        if out[0] == "ok":
            out = ("ok", _docs(out[1], isa_doc))
        return out, note()

    srv = None
    try:
        for i in range(3):
            assert sa.rid.insert_isa(_isa(ns, i, LOW[4 * i:4 * i + 4]))
            assert sb.rid.insert_isa(
                _isa(ns, 100 + i, HIGH[4 * i:4 * i + 4]))
        sa.rid.insert_subscription(_rid_sub(ns, 0, LOW[:3]))
        sb.rid.insert_subscription(_rid_sub(ns, 1, HIGH[:3]))
        for i in range(2):
            sa.scd.upsert_constraint(_constraint(ns, i, LOW[20 + i:22 + i]))
            sb.scd.upsert_constraint(
                _constraint(ns, 50 + i, HIGH[20 + i:22 + i]))
        app = ns.build_app(
            ns.RIDService(sa.rid, sa.clock), ns.SCDService(sa.scd, sa.clock),
            None, enable_scd=True, status_fn=sa.freshness_status,
            health_fn=sa.health.mode_name, federation=ra,
        )
        srv = LiveServer(app)
        url = srv.base + "/v1/dss/identification_service_areas"

        def http(**headers):
            r = requests.get(url, params={"area": STRIP}, headers=headers,
                             timeout=10)
            ids = (sorted(s["id"] for s in r.json()["service_areas"])
                   if r.status_code == 200 else None)
            return (r.status_code, r.headers.get("X-DSS-Freshness"),
                    r.headers.get("Retry-After"), ids)

        obs.append(("global a", search(sa, _STRIP_CELLS, allow_stale=True)))
        obs.append(("global b", search(sb, _STRIP_CELLS, allow_stale=True)))
        before = ra.peers["b"].requests
        got, n = search(sa, ns.key_to_cell(LOW[:12]), allow_stale=True)
        obs.append(("local a", got, n, ra.peers["b"].requests - before))
        subs = _status(sa.rid.search_subscriptions, _STRIP_CELLS)
        obs.append(("subs", sorted(s.id for s in subs[1]), note()))
        csts = sa.scd.search_constraints(_STRIP_CELLS, None, None, T0, T1,
                                         allow_stale=True)
        obs.append(("csts", _docs(csts, cst_doc), note()))
        obs.append(("misroute", _status(sa.rid.insert_isa,
                                        _isa(ns, 700, HIGH[:4]))))
        obs.append(("sync", ra.sync_peer("b"), ra.mirrors["b"].counts(),
                    ra.mirrors["b"].gens))
        obs.append(("http", http()))
        obs.append(("gauges", _fed_stats(sa), _ladder(sa)))
        # partition b: three failed syncs open the breaker
        ra.peers["b"].transport = _dead
        obs.append(("partition", [ra.sync_peer("b") for _ in range(3)],
                    _ladder(sa), ra.partitioned()))
        mono[0] += 0.25  # the mirror's lag is now 0.25 s
        obs.append(("stale", search(sa, _STRIP_CELLS, allow_stale=True)))
        obs.append(("http stale", http()))
        obs.append(("http over bound", http(**{"X-DSS-Max-Lag": "0"})))
        ns.fed.set_lag_bound(0.0)
        obs.append(("over bound", search(sa, _STRIP_CELLS,
                                         allow_stale=True)))
        ns.fed.set_lag_bound(None)
        obs.append(("strict", _status(sa.rid.search_subscriptions,
                                      _STRIP_CELLS), note()))
        obs.append(("write shed", _status(sa.rid.insert_isa,
                                          _isa(ns, 701, HIGH[:4]))))
        obs.append(("local write", _status(
            lambda: sa.rid.insert_isa(_isa(ns, 702, LOW[40:44])).id)))
        obs.append(("gauges down", _fed_stats(sa), ra.status()))
        assert sb.rid.insert_isa(_isa(ns, 130, HIGH[40:44]))
        # heal: the breaker's cooldown passes, the next sync recovers
        ra.peers["b"].transport = _inproc(ns, routers, "b")
        mono[0] += 1.0
        obs.append(("heal", ra.sync_peer("b"), _ladder(sa),
                    ra.partitioned()))
        obs.append(("final", search(sa, _STRIP_CELLS, allow_stale=True)))
        obs.append(("http final", http()))
        obs.append(("gauges final", _fed_stats(sa), _fed_stats(sb),
                    ra.status(), rb.status()))
    finally:
        ns.fed.take_fed_note()
        ns.fed.set_lag_bound(None)
        if srv is not None:
            srv.stop()
        for s in stores.values():
            s.close()
    return obs


@pytest.mark.parametrize("ref_storage,port_storage",
                         [("memory", "memory"), ("tpu", "cuda")])
def test_same_script_same_answers_headers_gauges_and_ladder(
        ref_storage, port_storage):
    want = _scenario(REF, ref_storage)
    got = _scenario(PORT, port_storage)
    assert [o[0] for o in got] == [o[0] for o in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    by = dict((o[0], o[1:]) for o in got)
    # the script reached what it is about
    assert len(by["global a"][0][0][1]) == 6
    assert by["partition"][1] == ("federation_degraded",
                                  ["federation_degraded"])
    assert "fed=stale" in by["http stale"][0][1]
    assert "lag=0.250" in by["http stale"][0][1]
    assert by["http over bound"][0][0] == 503
    assert by["write shed"][0][0] == 503
    assert by["heal"][1] == ("healthy", [])


# -- a port region and a reference region ------------------------------------


def _two_packages(port_storage, *, wire_port=None):
    """Region a on the port, region b on the reference, each peer's
    transport the other package's serve_* through JSON (or the given
    pair of transports).  -> (stores, routers)."""
    routers = {}
    fmap = {k: ns.fed.FederationMap(
        [ns.fed.RegionEntry("a"), ns.fed.RegionEntry("b")],
        np.array([BOUNDARY], np.int32), k)
        for k, ns in (("a", PORT), ("b", REF))}
    routers["a"] = p_fed.FederationRouter(
        fmap["a"], {"b": p_fed.FederationPeer(
            "b", _inproc(REF, routers, "b", wire=True), reset_s=0.3)},
        stale_lag_s=30.0)
    routers["b"] = r_fed.FederationRouter(
        fmap["b"], {"a": r_fed.FederationPeer(
            "a", _inproc(PORT, routers, "a", wire=True), reset_s=0.3)},
        stale_lag_s=30.0)
    stores = {"a": _make_store(PORT, port_storage, PFakeClock(START)),
              "b": RStore(storage="memory", clock=RFakeClock(START))}
    for k in ("a", "b"):
        _attach_quiet(stores[k], routers[k])
    return stores, routers


def _populate_both(sa, sb):
    """ISAs, RID subscriptions, operations, SCD subscriptions and
    constraints in each region's own airspace."""
    for ns, store, keys, base in ((PORT, sa, LOW, 0), (REF, sb, HIGH, 100)):
        for i in range(4):
            k = keys[5 * i:5 * i + 4]
            assert store.rid.insert_isa(_isa(ns, base + i, k))
            store.rid.insert_subscription(_rid_sub(ns, base + i, k[:2]))
            store.scd.upsert_constraint(_constraint(ns, base + i, k[1:3]))
            store.scd.upsert_subscription(ns.scdm.Subscription(
                id=_uid(800 + base + i), owner="uss1", start_time=T0,
                end_time=T1, base_url="https://uss1.example",
                notify_for_operations=True,
                cells=ns.key_to_cell(np.asarray(k[:3], np.int64))))
            op = ns.scdm.Operation(
                id=_uid(900 + base + i), owner="uss1", start_time=T0,
                end_time=T1, altitude_lower=10.0 * i,
                altitude_upper=10.0 * i + 50.0,
                uss_base_url="https://uss1.example", state="Accepted",
                cells=ns.key_to_cell(np.asarray(k, np.int64)),
                subscription_id=_uid(800 + base + i))
            prior = store.scd._local.search_operations(
                op.cells, op.altitude_lower, op.altitude_upper, T0, T1)
            store.scd.upsert_operation(op, [o.ovn for o in prior])


def _merged_oracle(sa, sb):
    """ONE reference memory store restored from both regions' state."""
    oracle = RStore(storage="memory", clock=RFakeClock(START))
    rid = {k: sa.rid.serialize_state()[k] + sb.rid.serialize_state()[k]
           for k in ("isas", "subs")}
    scd = {k: sa.scd.serialize_state()[k] + sb.scd.serialize_state()[k]
           for k in ("ops", "subs", "constraints")}
    oracle.rid.restore_state(rid)
    oracle.scd.restore_state(scd)
    return oracle


def _global_answers(store):
    """Every federated search over the strip -> sorted docs/ids."""
    cells = _STRIP_CELLS
    rid, scd = store.rid, store.scd
    return {
        "isas": sorted(json.dumps(r_codec.isa_to_doc(x), sort_keys=True)
                       for x in rid.search_isas(cells, T0, None,
                                                allow_stale=True)),
        "rid_subs": sorted(x.id for x in rid.search_subscriptions(cells)),
        "rid_subs_owner": sorted(
            x.id for x in rid.search_subscriptions_by_owner(cells, "uss1")),
        "ops": sorted(json.dumps(r_codec.op_to_doc(x), sort_keys=True)
                      for x in scd.search_operations(
                          cells, 0.0, 3000.0, T0, T1, allow_stale=True)),
        "scd_subs": sorted(x.id for x in scd.search_subscriptions(
            cells, "uss1")),
        "csts": sorted(x.id for x in scd.search_constraints(
            cells, None, None, T0, T1, allow_stale=True)),
    }


def _oracle_answers(oracle):
    cells = _STRIP_CELLS
    return {
        "isas": sorted(json.dumps(r_codec.isa_to_doc(x), sort_keys=True)
                       for x in oracle.rid.search_isas(cells, T0, None)),
        "rid_subs": sorted(x.id for x in
                           oracle.rid.search_subscriptions(cells)),
        "rid_subs_owner": sorted(
            x.id for x in oracle.rid.search_subscriptions_by_owner(
                cells, "uss1")),
        "ops": sorted(json.dumps(r_codec.op_to_doc(x), sort_keys=True)
                      for x in oracle.scd.search_operations(
                          cells, 0.0, 3000.0, T0, T1)),
        "scd_subs": sorted(x.id for x in oracle.scd.search_subscriptions(
            cells, "uss1")),
        "csts": sorted(x.id for x in oracle.scd.search_constraints(
            cells, None, None, T0, T1)),
    }


@pytest.mark.parametrize("port_storage", STORAGES)
def test_port_region_federated_with_a_reference_region(port_storage):
    stores, routers = _two_packages(port_storage)
    sa, sb = stores["a"], stores["b"]
    oracle = None
    try:
        _populate_both(sa, sb)
        oracle = _merged_oracle(sa, sb)
        want = _oracle_answers(oracle)
        assert {k: len(v) for k, v in want.items()} == {
            "isas": 8, "rid_subs": 8, "rid_subs_owner": 8, "ops": 8,
            "scd_subs": 8, "csts": 8}
        for store in (sa, sb):
            assert _global_answers(store) == want
        # each package's mirror of the other's state answers alike
        assert routers["a"].sync_peer("b") and routers["b"].sync_peer("a")
        for k, other in (("a", "b"), ("b", "a")):
            routers[k].peers[other].transport = _dead
            for _ in range(3):
                routers[k].sync_peer(other)
            assert stores[k].health.mode_name() == "federation_degraded"
            stale = {
                "isas": sorted(json.dumps(r_codec.isa_to_doc(x),
                                          sort_keys=True)
                               for x in stores[k].rid.search_isas(
                                   _STRIP_CELLS, T0, None,
                                   allow_stale=True)),
                "ops": sorted(json.dumps(r_codec.op_to_doc(x),
                                         sort_keys=True)
                              for x in stores[k].scd.search_operations(
                                  _STRIP_CELLS, 0.0, 3000.0, T0, T1,
                                  allow_stale=True)),
            }
            assert stale == {"isas": want["isas"], "ops": want["ops"]}
            note = (p_fed if k == "a" else r_fed).take_fed_note()
            assert note["mode"] == "stale"
    finally:
        p_fed.take_fed_note()
        r_fed.take_fed_note()
        for s in stores.values():
            s.close()
        if oracle is not None:
            oracle.close()


# -- live sockets, both ways -------------------------------------------------


def test_http_transports_cross_the_packages():
    """The reference's requests transport against the port's peer
    surface, and the port's http.client transport against the
    reference's, on live sockets; then each transport's failure
    classes against the same servers."""
    stores, routers = _two_packages("cuda")
    sa, sb = stores["a"], stores["b"]
    servers, oracle = [], None
    try:
        _populate_both(sa, sb)
        oracle = _merged_oracle(sa, sb)
        want = _oracle_answers(oracle)
        srv_a = LiveServer(p_build_app(
            PRIDService(sa.rid, sa.clock), PSCDService(sa.scd, sa.clock),
            federation=routers["a"]))
        servers.append(srv_a)
        srv_b = LiveServer(r_build_app(
            RRIDService(sb.rid, sb.clock), RSCDService(sb.scd, sb.clock),
            federation=routers["b"]))
        servers.append(srv_b)
        routers["a"].peers["b"].transport = p_fed.HttpPeerTransport(
            "b", [srv_b.base])
        routers["b"].peers["a"].transport = r_fed.HttpPeerTransport(
            "a", [srv_a.base])
        for store in (sa, sb):
            assert _global_answers(store) == want
        assert routers["a"].sync_peer("b") and routers["b"].sync_peer("a")
        assert routers["a"].mirrors["b"].counts() == \
            routers["b"].mirrors["a"].counts() == {
                "isa": 4, "rid_sub": 4, "op": 4, "scd_sub": 4,
                "constraint": 4}

        dead = "http://127.0.0.1:9"

        def classes(fed, base):
            out = {}
            cases = {
                # a dead URL, then a live one: failover in order
                "failover": ([dead, base], "GET", "/aux/v1/federation/sync",
                             None),
                "dead": ([dead], "GET", "/aux/v1/federation/sync", None),
                # 4xx: the peer answered and refused
                "refused": ([base], "POST", "/aux/v1/federation/query",
                            {"cls": "nope", "cells": [1]}),
                # 5xx on every URL: a transport failure
                "5xx": ([base, base], "POST", "/aux/v1/federation/query",
                        {"cls": "isa", "cells": [int(_STRIP_CELLS[0])]}),
            }
            for name, (urls, method, path, payload) in cases.items():
                t = fed.HttpPeerTransport("x", urls, timeout_s=2.0)
                try:
                    body = t(method, path, payload)
                    out[name] = ("ok", body.get("region"))
                except fed.PeerError as e:
                    out[name] = ("PeerError", e.transport,
                                 str(e).split(":")[0])
            return out

        for base in (srv_a.base, srv_b.base):
            got, ref = classes(p_fed, base), classes(r_fed, base)
            assert got == ref
            assert got["failover"][0] == "ok"
            assert got["dead"][:2] == ("PeerError", True)
            assert got["refused"][:2] == ("PeerError", False)
            assert got["5xx"][:2] == ("PeerError", True)
    finally:
        for srv in servers:
            srv.stop()
        for s in stores.values():
            s.close()
        if oracle is not None:
            oracle.close()


def test_port_transport_sends_token_and_traceparent():
    """The bearer token and the trace's propagation headers ride every
    peer call, as through the reference's requests session."""
    from aiohttp import web

    from dss_tpu_torch.obs import trace as p_trace

    seen = []

    async def echo(request):
        seen.append(dict(request.headers))
        return web.json_response({"ok": 1})

    app = web.Application()
    app.router.add_get("/aux/v1/federation/sync", echo)
    srv = LiveServer(app)
    try:
        t = p_fed.HttpPeerTransport("b", [srv.base], token="s3cret")
        assert t("GET", "/aux/v1/federation/sync") == {"ok": 1}
        assert seen[-1]["Authorization"] == "Bearer s3cret"
        assert "traceparent" not in seen[-1]  # tracing is off here
        tid = "0af7651916cd43dd8448eb211c80319c"
        was = (p_trace._SAMPLE, p_trace._SLOW_MS)
        p_trace.configure(sample=1.0)
        try:
            ctx = p_trace.new_trace(f"00-{tid}-b7ad6b7169203331-01")
            with p_trace.use(p_trace.SpanHandle(ctx, ctx.root_span_id)):
                t("GET", "/aux/v1/federation/sync")
        finally:
            p_trace.configure(sample=was[0], slow_ms=was[1])
        tp = seen[-1]["traceparent"]
        assert tp.startswith(f"00-{tid}-") and seen[-1]["X-Request-Id"] == tid
    finally:
        srv.stop()


# -- drains of 128 through two federated stores on the device route ----------

DRAIN = 128
QUEUED = 80


def _drain_ops(n, seed, lo, hi):
    """n operation docs in [lo, hi) of the key space."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        s = int(rng.integers(lo, hi - 8))
        keys = np.arange(s, s + 8, dtype=np.int64)
        alo = float(np.float32(rng.uniform(0, 2000)))
        docs.append((f"op-{seed}-{i}", keys, alo, alo + 300.0))
    return docs


def _load_ops(ns, store, docs):
    state = {"ops": [], "subs": [], "constraints": []}
    for oid, keys, alo, ahi in docs:
        op = ns.scdm.Operation(
            id=oid, owner="uss1", version=1, ovn=f"ovn-{oid}",
            start_time=T0, end_time=T1, altitude_lower=alo,
            altitude_upper=ahi, uss_base_url="https://uss1.example",
            state="Accepted", cells=ns.key_to_cell(keys))
        state["ops"].append(ns.codec.op_to_doc(op))
    store.scd.restore_state(state)


def _queries(seed, n):
    """n coverings of 12 keys, each spanning the boundary key 1000."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(989, 1000))
        keys = np.arange(s, s + 12, dtype=np.int64)
        alo = float(np.float32(rng.uniform(0, 2000)))
        out.append((keys, alo, alo + 500.0))
    return out


def _gated_drain(stores, call, n):
    """n callers run call(i) at once while every store's op table holds
    its submit until QUEUED callers queue on that store (or 5 s pass):
    each store then drains its queue as one batch.  -> answers."""
    gates = []
    for store in stores:
        index = store.scd._op_index
        table, co = index.table, index.coalescer
        gate = threading.Event()
        submit = table.query_many_submit

        def gated(*a, _g=gate, _s=submit, **kw):
            _g.wait(10.0)
            return _s(*a, **kw)

        table.query_many_submit = gated
        gates.append((table, co, gate))
    got = [None] * n
    errs = []

    def client(i):
        try:
            got[i] = call(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    ths = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    try:
        for table, co, gate in gates:
            until = time.monotonic() + 5.0
            while (co.stats()["co_queue_depth"] < QUEUED
                   and time.monotonic() < until):
                time.sleep(0.005)
            del table.query_many_submit
            gate.set()
    finally:
        for table, co, gate in gates:
            table.__dict__.pop("query_many_submit", None)
            gate.set()
        for th in ths:
            th.join(60)
    assert not errs, errs[:3]
    return got


def _federated_pair(ns, storage):
    entries = [ns.fed.RegionEntry("a"), ns.fed.RegionEntry("b")]
    routers, stores = {}, {}
    for local, remote in (("a", "b"), ("b", "a")):
        routers[local] = ns.fed.FederationRouter(
            ns.fed.FederationMap(entries, np.array([1000], np.int32), local),
            {remote: ns.fed.FederationPeer(
                remote, _inproc(ns, routers, remote))})
        stores[local] = _make_store(ns, storage, ns.FakeClock(START))
        _attach_quiet(stores[local], routers[local])
    _load_ops(ns, stores["a"], _drain_ops(400, 1, 800, 1000))
    _load_ops(ns, stores["b"], _drain_ops(400, 2, 1000, 1200))
    for store in stores.values():
        # fold the restored overlay into a tier the device route scans
        store.scd._op_index.table.fold(major=True)
    return stores


def test_drains_of_128_take_the_device_route_on_both_regions():
    qs = _queries(5, DRAIN)
    ref = _federated_pair(REF, "tpu")
    try:
        want = [sorted(o.id for o in ref["a"].scd.search_operations(
            p_key_to_cell(k), alo, ahi, T0, T1, allow_stale=True))
            for k, alo, ahi in qs]
    finally:
        for s in ref.values():
            s.close()
    assert sum(map(len, want)) > DRAIN  # the queries find records
    port = _federated_pair(PORT, "cuda")
    try:
        cos = {k: s.scd._op_index.coalescer for k, s in port.items()}
        st0 = {k: co.stats() for k, co in cos.items()}
        sa = port["a"]
        got = _gated_drain(
            [port["a"], port["b"]],
            lambda i: sorted(o.id for o in sa.scd.search_operations(
                p_key_to_cell(qs[i][0]), qs[i][1], qs[i][2], T0, T1,
                allow_stale=True)),
            DRAIN)
        assert got == want
        for k, co in cos.items():
            st1 = co.stats()
            dev = (st1["co_route_device_batches"]
                   - st0[k]["co_route_device_batches"])
            assert dev >= 1, (k, st1)
        assert sa.federation.remote_queries > 0
    finally:
        p_fed.take_fed_note()
        for s in port.values():
            s.close()


# -- the push pipeline's @region: hop ----------------------------------------


def _push_hop(ns):
    """Region a's write forwards through its FederationRouter's peer to
    region b's pipeline, which matches it against b's subscriptions and
    delivers to b's webhook.  b's subscription reaches into a's
    airspace: it predates the federation map (written before the
    router is attached), since the map's guard refuses such a write."""
    entries = [ns.fed.RegionEntry("a"), ns.fed.RegionEntry("b")]
    routers, stores, pipes, got = {}, {}, {}, []

    calls = []

    def transport_to(name):
        def transport(method, path, payload):
            calls.append((name, path))
            if path == "/aux/v1/push/ingest":
                return pipes[name].ingest_remote(
                    json.loads(json.dumps(payload)))
            return _inproc(ns, routers, name)(method, path, payload)
        return transport

    for local, remote in (("a", "b"), ("b", "a")):
        routers[local] = ns.fed.FederationRouter(
            ns.fed.FederationMap(entries, np.array([1000], np.int32), local),
            {remote: ns.fed.FederationPeer(remote, transport_to(remote))})
        stores[local] = ns.Store(storage="memory",
                                 clock=ns.FakeClock(START))
        if local == "b":
            stores[local].scd.upsert_subscription(ns.scdm.Subscription(
                id=_uid(1), owner="uss2", start_time=T0, end_time=T1,
                base_url="https://uss2.example",
                notify_for_operations=True, cells=ns.key_to_cell(
                    np.arange(995, 1104, dtype=np.int64))))
        _attach_quiet(stores[local], routers[local])
        pipes[local] = ns.Push(
            workers=1,
            transport=lambda url, body, hdrs, _l=local: got.append(
                (_l, url, body["trigger"], body["entity"]["id"],
                 body["entity"].get("origin"))))
        stores[local].attach_push(pipes[local])
    try:
        pipes["b"].register_hook("uss2", "http://uss2.example/n")
        # a's own airspace; the pseudo-notification carries the volume
        op = ns.scdm.Operation(
            id=_uid(2), owner="uss1", start_time=T0, end_time=T1,
            state="Accepted", cells=ns.key_to_cell(
                np.arange(990, 1000, dtype=np.int64)))
        stores["a"].scd.upsert_operation(op, [])
        assert pipes["a"].drain(5.0)
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pipes["b"].drain(5.0)
        return (pipes["a"].fed_forwarded, pipes["b"].fed_ingested,
                sorted(got), sorted(calls))
    finally:
        for p in pipes.values():
            p.close()
        for s in stores.values():
            s.close()


def test_push_region_hop_rides_the_router_as_in_the_reference():
    got, want = _push_hop(PORT), _push_hop(REF)
    assert got == want
    forwarded, ingested, delivered, calls = got
    assert forwarded == 1 and ingested == 1
    assert calls == [("b", "/aux/v1/push/ingest")]  # one hop, no sync
    # b's webhook got the remote write (the router has no region_id,
    # so the origin is "" in both packages)
    assert delivered == [("b", "http://uss2.example/n", "operations",
                          _uid(2), "")]

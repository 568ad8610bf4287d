"""The DSS Region on the port, held to the reference.

Every case of tests/test_region.py runs on the port's modules: the
reference test file is compiled anew with its imports pointed at the
port (`dss_tpu.` -> `dss_tpu_torch.`), and each of its test functions
is collected here under its own name, once with the instances on
`storage="memory"` and once on `storage="cuda"` with `device="cpu"`
(the DAR tables' plain versions); the reference's `storage="tpu"` case
runs on `cuda` with `device="cpu"` in both.  The port's log server,
client, coordinator and store's region mode carry those cases.

Then the two packages in one region:
- a mixed region: one reference instance and one port instance on each
  package's log server; a write on either is read on both, a conflict
  across packages is refused, and both instances answer alike, with
  no tolerance;
- each package's client against the other's log server, call for call
  equal to the client against its own;
- the same store operations in region mode write byte-identical region
  logs in both packages (epoch nonce normalised), with no undo list in
  any append; a standalone store's WAL stays byte for byte the
  reference's with the undo capture in the store;
- the smoke's offline region-log seeding (chip_smoke.seed_region_log)
  writes the reference's RegionLog bytes.
"""

from __future__ import annotations

import json
import re
import uuid
from datetime import timedelta
from pathlib import Path

import pytest

from dss_tpu.region import client as r_client
from dss_tpu.region import log_server as r_log_server
from dss_tpu_torch.region import client as p_client
from dss_tpu_torch.region import log_server as p_log_server
from tests import test_region as ref_cases
from tests.test_torch_store_contract import PORT, REF, T0
from tests.test_torch_store_parity import Side, run_sequence

TESTS = Path(__file__).resolve().parent
STORAGES = ("memory", "cuda")


def port_copy(name: str, extra=None) -> dict:
    """The reference test module `name`, compiled with its imports on
    the port (plus `extra` source replacements) -> its namespace."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in (extra or {}).items():
        assert old in src, old
        src = src.replace(old, new)
    src = re.sub(r"\bdss_tpu\.", "dss_tpu_torch.", src)
    src = re.sub(r"\bfrom dss_tpu import\b", "from dss_tpu_torch import",
                 src)
    assert "dss_tpu." not in src.replace("dss_tpu_torch.", "")
    ns = {"__name__": f"tests.{name}_on_the_port", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


PORT_CASES = port_copy("test_region")
_PortStore = PORT_CASES["DSSStore"]
_STORAGE = {"mode": "memory"}  # the storage of the copied cases' instances


def _store(*, storage, **kw):
    """The copied cases' DSSStore: "memory" follows the case's
    parametrised storage, the reference's "tpu" is `cuda` on the CPU."""
    if storage == "memory":
        storage = _STORAGE["mode"]
    if storage in ("tpu", "cuda"):
        storage, kw["device"] = "cuda", "cpu"
    return _PortStore(storage=storage, **kw)


PORT_CASES["DSSStore"] = _store
RegionServerThread = PORT_CASES["RegionServerThread"]
wait_until = PORT_CASES["wait_until"]
_crash_wal = PORT_CASES["_crash_wal"]
rid_extents = PORT_CASES["rid_extents"]
op_params = PORT_CASES["op_params"]


@pytest.fixture(params=STORAGES)
def storage(request):
    _STORAGE["mode"] = request.param
    yield request.param
    _STORAGE["mode"] = "memory"


# the copied fixture, under its own name (it builds the port's stores)
region = PORT_CASES["region"]

_COPIED = []
for _k, _fn in list(PORT_CASES.items()):
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = pytest.mark.usefixtures("storage")(_fn)
        _COPIED.append(_k)


def test_every_reference_case_is_here():
    src = (TESTS / "test_region.py").read_text()
    want = set(re.findall(r"^def (test_\w+)\(", src, re.M))
    assert want == set(_COPIED)
    assert len(_COPIED) == 21


# -- two packages, one region ---------------------------------------------------


class RefServerThread(ref_cases.RegionServerThread):
    """The reference's log server on a background loop."""


def _server(pkg, **kw):
    return (RegionServerThread if pkg == "port" else RefServerThread)(**kw)


def _ref_store(url, name, **kw):
    from dss_tpu.dar.dss_store import DSSStore

    return DSSStore(storage="memory", region_url=url,
                    region_poll_interval_s=ref_cases.POLL_S,
                    instance_id=name, **kw)


def _port_store(url, name, **kw):
    from dss_tpu_torch.dar.dss_store import DSSStore

    return DSSStore(storage="cuda", device="cpu", region_url=url,
                    region_poll_interval_s=ref_cases.POLL_S,
                    instance_id=name, **kw)


def _services(store, pkg):
    if pkg == "ref":
        from dss_tpu.services.rid import RIDService
        from dss_tpu.services.scd import SCDService
    else:
        from dss_tpu_torch.services.rid import RIDService
        from dss_tpu_torch.services.scd import SCDService
    return (RIDService(store.rid, store.clock),
            SCDService(store.scd, store.clock))


def _status(fn, *a):
    """A service call -> ("ok", body) or (http status, code)."""
    from dss_tpu import errors as r_errors
    from dss_tpu_torch import errors as p_errors

    try:
        return ("ok", fn(*a))
    except (r_errors.StatusError, p_errors.StatusError) as e:
        return (e.http_status, int(e.code))


def _search_area(lat, lng, half=0.03):
    return ",".join(f"{a:.4f},{b:.4f}" for a, b in (
        (lat - half, lng - half), (lat - half, lng + half),
        (lat + half, lng + half), (lat + half, lng - half)))


def _sorted(body, key):
    return sorted(body[key], key=lambda x: x["id"])


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_mixed_region_answers_alike(server_pkg):
    server = _server(server_pkg)
    ref = _ref_store(server.url, "mixed-ref")
    port = _port_store(server.url, "mixed-port")
    try:
        svc = {"ref": _services(ref, "ref"), "port": _services(port, "port")}
        stores = {"ref": ref, "port": port}
        # ISAs written on either instance are read on both
        isas = {}
        for k, who in enumerate(("ref", "port", "ref", "port")):
            isa_id = str(uuid.uuid4())
            out = svc[who][0].create_isa(
                isa_id, {"extents": rid_extents(lat=37.03 + 0.01 * k),
                         "flights_url": "https://u.example/f"}, f"uss{k}")
            isas[isa_id] = out["service_area"]["version"]
        for isa_id in isas:
            for who in ("ref", "port"):
                wait_until(lambda w=who, i=isa_id: stores[w].rid.get_isa(i))
        wait_until(lambda: (ref.region.applied == port.region.applied)
                   or None)
        for isa_id, version in isas.items():
            got = {w: svc[w][0].get_isa(isa_id) for w in ("ref", "port")}
            assert got["port"] == got["ref"]
            assert got["port"]["service_area"]["version"] == version
        area = _search_area(37.045, -122.03, 0.06)
        found = {w: _sorted(svc[w][0].search_isas(area), "service_areas")
                 for w in ("ref", "port")}
        assert found["port"] == found["ref"]
        assert {x["id"] for x in found["port"]} == set(isas)

        # an operational intent on the reference instance; the port
        # instance's overlapping intent without its OVN is refused
        op1 = str(uuid.uuid4())
        first = svc["ref"][1].put_operation(op1, op_params(), "uss1")
        ovn1 = first["operation_reference"]["ovn"]
        wait_until(lambda: port.scd._visible_op(op1))
        op2 = str(uuid.uuid4())
        refused = _status(svc["port"][1].put_operation, op2,
                          op_params(), "uss2")
        assert refused[0] == 409, refused
        # the same write, refused the same way on the reference side
        assert _status(svc["ref"][1].put_operation, op2, op_params(),
                       "uss2") == refused
        # with the key it lands, and the reference instance reads it
        second = svc["port"][1].put_operation(op2, op_params(key=[ovn1]),
                                              "uss2")
        wait_until(lambda: ref.scd._visible_op(op2))
        wait_until(lambda: (ref.region.applied == port.region.applied)
                   or None)
        for op_id, owner in ((op1, "uss1"), (op2, "uss2")):
            got = {w: svc[w][1].get_operation(op_id, owner)
                   for w in ("ref", "port")}
            assert got["port"] == got["ref"]
        assert svc["ref"][1].get_operation(op2, "uss2")[
            "operation_reference"]["ovn"] == second[
            "operation_reference"]["ovn"]
        aoi = op_params()["extents"][0]
        q = {w: _sorted(svc[w][1].search_operations(
            {"area_of_interest": aoi}, "uss1"), "operation_references")
            for w in ("ref", "port")}
        assert q["port"] == q["ref"]
        assert {o["id"] for o in q["port"]} == {op1, op2}
        # the two instances hold the same records, doc for doc
        assert port.rid.serialize_state() == ref.rid.serialize_state()
        assert port.scd.serialize_state() == ref.scd.serialize_state()
    finally:
        ref.close()
        port.close()
        server.stop()


def _client_script(client_mod, url):
    """One sequence of client calls -> the outcomes, with lease tokens
    and epoch nonces left out (both are random per server)."""
    out = []
    c = client_mod.RegionClient(url, "script")
    tok, head = c.acquire_lease()
    out.append(("lease", head))
    out.append(("append", c.append(tok, [{"t": "x", "i": 0}],
                                   release=True)))
    tok, head = c.acquire_lease()
    out.append(("lease", head))
    out.append(("append", c.append(tok, [{"t": "x", "i": 1}])))
    # a live lease refuses optimistic appends
    try:
        c.append_optimistic(head + 1, [{"t": "y"}], [5])
    except client_mod.OptimisticRejected as e:
        out.append(("rejected", str(e)))
    c.release_lease(tok)
    out.append(("opt", c.append_optimistic(2, [{"t": "y"}], [5, 6])))
    out.append(("opt", c.append_optimistic(2, [{"t": "z"}], [7])))
    for expected, cells in ((2, [6]), (99, [1]), (-1, [1])):
        try:
            c.append_optimistic(expected, [{"t": "w"}], cells)
            out.append(("opt", "landed"))
        except client_mod.OptimisticRejected as e:
            out.append(("rejected", str(e)))
        except client_mod.RegionError as e:
            out.append(("error", type(e).__name__))
    out.append(("fetch", c.fetch(0)))
    out.append(("fetch", c.fetch(3)))
    out.append(("snapshot", c.get_snapshot()))
    out.append(("put_snapshot", c.put_snapshot(3, {"rid": {}, "n": 3})))
    out.append(("put_snapshot", c.put_snapshot(2, {"stale": True})))
    try:
        c.fetch(1)
    except client_mod.SnapshotRequired:
        out.append(("snapshot_required",))
    out.append(("snapshot", c.get_snapshot()))
    out.append(("fetch", c.fetch(3)))
    out.append(("epoch_gen", c.current_epoch().split(".")[0]))
    out.append(("breakers", sorted(c.breaker_states().values())))
    return out


@pytest.mark.parametrize("pair", ["ref_client_port_server",
                                  "port_client_ref_server"])
def test_each_client_against_the_others_log_server(pair):
    cross_client = r_client if pair.startswith("ref") else p_client
    own_pkg = "port" if pair.endswith("port_server") else "ref"
    own_client = p_client if own_pkg == "port" else r_client
    servers = [_server(own_pkg), _server(own_pkg)]
    try:
        want = _client_script(own_client, servers[0].url)
        got = _client_script(cross_client, servers[1].url)
    finally:
        for s in servers:
            s.stop()
    assert got == want
    assert ("rejected", "lease_held") in got
    assert ("rejected", "conflict") in got and ("snapshot_required",) in got


class _TxnIds:
    """Deterministic txn ids for one package's client (uuid4 stand-in)."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n, version=4)


def _normalised(path) -> bytes:
    return re.sub(rb'"nonce":"[0-9a-f]+"', b'"nonce":"-"',
                  Path(path).read_bytes())


@pytest.mark.parametrize("backend", ["cuda", "memory"])
def test_region_logs_byte_identical_without_undo(backend, tmp_path,
                                                 monkeypatch):
    """The same store operations, each package's store on each
    package's log server in region mode (the lease path; the
    optimistic path's cells depend on timing): the two region logs are
    byte for byte equal once the epoch nonce is normalised, and no
    append carries the stores' undo lists."""
    monkeypatch.setenv("DSS_CACHE_ENABLE", "1")
    monkeypatch.setenv("DSS_TIER_RATIO", "5")
    monkeypatch.setattr(r_client, "uuid", _TxnIds())
    monkeypatch.setattr(p_client, "uuid", _TxnIds())
    paths = (tmp_path / "ref.wal", tmp_path / "port.wal")
    servers = (RefServerThread(wal_path=str(paths[0])),
               RegionServerThread(wal_path=str(paths[1])))
    start = T0 - timedelta(hours=1)
    rc, pc = REF.FakeClock(start), PORT.FakeClock(start)
    kw = dict(region_poll_interval_s=0.02, region_optimistic=False)
    ref = REF.Store(storage="tpu" if backend == "cuda" else "memory",
                    clock=rc, region_url=servers[0].url,
                    instance_id="ref", **kw)
    pkw = {"device": "cpu"} if backend == "cuda" else {}
    port = PORT.Store(storage=backend, clock=pc, region_url=servers[1].url,
                      instance_id="port", **kw, **pkw)
    try:
        assert port.rid._capture_undo and port.scd._capture_undo
        run_sequence(Side(REF, ref, rc), Side(PORT, port, pc), 3, steps=60)
        assert port.region.applied == ref.region.applied > 10
        assert (port.region.stats()["region_rollbacks"]
                == ref.region.stats()["region_rollbacks"])
    finally:
        ref.close()
        port.close()
        for s in servers:
            s.stop()
    a, b = (_normalised(p) for p in paths)
    assert b == a
    assert b"undo" not in b
    entries = [json.loads(x) for x in b.splitlines()]
    assert entries[0] == {"t": "__format__", "version": 1}
    assert sum(e["t"] == "__entry__" for e in entries) > 10


def test_standalone_wal_unchanged_by_the_undo_capture(tmp_path,
                                                      monkeypatch):
    """A standalone store captures no undo list and writes the
    reference's WAL bytes (tests/test_torch_wal_codec.py holds more
    seeds)."""
    from tests.test_torch_store_parity import _pair

    paths = (str(tmp_path / "ref.wal"), str(tmp_path / "port.wal"))
    ref, port = _pair(monkeypatch, "cuda", wal_paths=paths)
    try:
        assert not port.store.rid._capture_undo
        assert not port.store.scd._capture_undo
        assert port.store.region is None
        run_sequence(ref, port, 7, steps=40)
    finally:
        ref.store.close()
        port.store.close()
    a, b = (open(p, "rb").read() for p in paths)
    assert b == a and b"undo" not in b


def test_seeded_region_log_is_the_reference_regionlog(tmp_path):
    """chip_smoke's offline seeding of the region phase's log, through
    each package's RegionLog: the same bytes (epoch nonce
    normalised), and the port's log server boots from it."""
    import chip_smoke

    recs = [{"t": "isa_put", "doc": {"id": f"i{k}", "cells": [k]}}
            for k in range(9)]
    state = {"rid": {"isas": [r["doc"] for r in recs[:6]], "subs": []},
             "scd": {"ops": [], "subs": [], "constraints": []}}
    paths = (tmp_path / "ref.wal", tmp_path / "port.wal")
    for cls, path in zip((r_log_server.RegionLog, p_log_server.RegionLog),
                         paths):
        chip_smoke.seed_region_log(cls, str(path), [[r] for r in recs],
                                   6, state)
    assert _normalised(paths[1]) == _normalised(paths[0])
    log = p_log_server.RegionLog(str(paths[1]))
    try:
        assert (log.base, log.head, log.snapshot_index) == (6, 9, 6)
        assert log.get_snapshot() == (6, state)
        assert [e for _, e in log.fetch(6)] == [[r] for r in recs[6:]]
        assert log.epoch_generation == 1  # the seeding shut down cleanly
    finally:
        log.close()


def test_store_boots_from_a_seeded_log_and_tails_it(tmp_path):
    """Boot = the snapshot's restore_state plus the tail after it, on
    the port's cuda store (device="cpu"), then a write round trip."""
    import chip_smoke
    from dss_tpu_torch.dar import codec

    server = RegionServerThread()
    try:
        w = _port_store(server.url, "template")
        rid, _ = _services(w, "port")
        isa_id = str(uuid.uuid4())
        rid.create_isa(isa_id, {"extents": rid_extents(),
                                "flights_url": "https://u.example/f"}, "u")
        template = codec.isa_to_doc(w.rid._isas[isa_id])
        w.close()
    finally:
        server.stop()
    recs = [{"t": "isa_put", "doc": dict(template, id=f"isa-{k}")}
            for k in range(12)]
    state = chip_smoke.region_state(recs[:8])
    assert [d["id"] for d in state["rid"]["isas"]] == [
        f"isa-{k}" for k in range(8)]
    wal = tmp_path / "seed.wal"
    chip_smoke.seed_region_log(p_log_server.RegionLog, str(wal),
                               [[r] for r in recs], 8, state)
    server = RegionServerThread(wal_path=str(wal))
    try:
        s = _port_store(server.url, "booted")
        try:
            assert s.region.applied == 12
            assert sorted(s.rid._isas) == sorted(f"isa-{k}"
                                                 for k in range(12))
            st = s.stats()
            assert st["region_resyncs"] == 0
            assert st["dss_dar_isa_live_records"] == 12
            rid, _ = _services(s, "port")
            isa_id = str(uuid.uuid4())
            rid.create_isa(isa_id, {"extents": rid_extents(),
                                    "flights_url": "https://u.example/f"},
                           "u")
            entries, head = p_client.RegionClient(server.url,
                                                  "check").fetch(12)
            assert head == 13 == s.region.applied
            assert entries[0][1][0]["doc"]["id"] == isa_id
        finally:
            s.close()
    finally:
        server.stop()


def test_region_server_binary_flags_are_the_references():
    from dss_tpu.cmds import region_server as r_bin
    from dss_tpu_torch.cmds import region_server as p_bin

    def flags(mod):
        return sorted(
            (a.dest, a.default, type(a).__name__)
            for a in mod.make_parser()._actions
        )

    assert flags(p_bin) == flags(r_bin)
    args = p_bin.make_parser().parse_args(
        ["--addr", "127.0.0.1:0", "--quorum", "2"])
    app = p_bin.build(args)
    assert app["region_node"].quorum == 2
    assert app["region_node"].advertise_url == "http://127.0.0.1:0"


def test_status_and_freshness_carry_the_region_epoch():
    """/status's epoch and the read cache's fence read the region
    client's epoch (the reference's app reads `store.region` so)."""
    server = RegionServerThread()
    s = _port_store(server.url, "epoch")
    try:
        epoch = s.freshness_status()["epoch"]
        assert epoch == s._region_client.current_epoch()
        assert epoch.split(".")[0] == "1"
        assert s.stats()["dss_breaker_state"] == {server.url: 0}
        rid, _ = _services(s, "port")
        isa_id = str(uuid.uuid4())
        rid.create_isa(isa_id, {"extents": rid_extents(),
                                "flights_url": "https://u.example/f"}, "u")
        from dss_tpu_torch.dar import readcache

        area = _search_area(37.03, -122.03, 0.05)
        notes = []
        for _ in range(2):
            readcache.take_note()  # the note of an earlier call
            rid.search_isas(area)
            notes.append(readcache.take_note())
        assert [n["epoch"] for n in notes] == [epoch, epoch]
        assert [n["hit"] for n in notes] == [False, True]
    finally:
        s.close()
        server.stop()


def test_region_down_sheds_writes_with_retry_after():
    """Every endpoint's breaker open: the ladder enters
    REGION_LOG_DOWN and a write sheds 503 with the breaker cooldown as
    its Retry-After, while reads keep serving."""
    server = RegionServerThread()
    s = _port_store(server.url, "down")
    try:
        rid, _ = _services(s, "port")
        isa_id = str(uuid.uuid4())
        rid.create_isa(isa_id, {"extents": rid_extents(),
                                "flights_url": "https://u.example/f"}, "u")
        server.stop()
        s._region_client._retry_deadline_s = 0.2
        s._region_client._max_retries = 3
        with pytest.raises(Exception) as ei:
            rid.create_isa(str(uuid.uuid4()), {
                "extents": rid_extents(lat=37.2),
                "flights_url": "https://u.example/f"}, "u")
        err = ei.value
        assert err.http_status == 503
        assert err.retry_after_s >= 0.5
        assert "region_log_down" in s.health.active()
        assert s.health.mode_name() == "region_log_down"
        assert rid.get_isa(isa_id)["service_area"]["id"] == isa_id
    finally:
        s.close()


def test_replica_tails_a_region_log():
    """ShardedReplica(region_client=) follows the region log through
    the port's _RegionTail: snapshot + tail, records of every class."""
    from dss_tpu_torch.parallel import replica as pr
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    server = RegionServerThread()
    s = _port_store(server.url, "writer")
    try:
        rid, scd = _services(s, "port")
        isa_id = str(uuid.uuid4())
        rid.create_isa(isa_id, {"extents": rid_extents(),
                                "flights_url": "https://u.example/f"}, "u")
        op_id = str(uuid.uuid4())
        scd.put_operation(op_id, op_params(), "uss1")
        mesh = make_mesh(2, dp=1, sp=2, devices=virtual_devices("cpu", 2))
        client = p_client.RegionClient(server.url, "replica")
        rep = pr.ShardedReplica(mesh, region_client=client)
        try:
            assert isinstance(rep._tail, pr._RegionTail)
            rep.sync()
            assert rep._tail.position == s.region.applied
            assert rep._tail.at_end()
            assert op_id in rep._records["ops"]
            assert isa_id in rep._records["isas"]
            # compaction: the tail restarts from the snapshot
            st = {"rid": s.rid.serialize_state(),
                  "scd": s.scd.serialize_state()}
            assert client.put_snapshot(s.region.applied, st)
            rep2 = pr.ShardedReplica(
                mesh, region_client=p_client.RegionClient(server.url, "r2"))
            try:
                rep2.sync()
                assert set(rep2._records["ops"]) == set(rep._records["ops"])
                assert set(rep2._records["isas"]) == set(rep._records["isas"])
            finally:
                rep2.close()
        finally:
            rep.close()
            client.close()
    finally:
        s.close()
        server.stop()

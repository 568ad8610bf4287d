"""Inline reads on the event loop, now that the native halves are built.

With `inline_reads=True` and dss_tpu_torch.native loaded, the port's
app runs READ handlers on the aiohttp loop under a host-only budget
(`budget.set_host_only(True)`); a read that would reach the device
raises NeedsDevice and re-runs on the executor.  Three live servers
take every request of the reference's HTTP script: the reference's app
(inline reads on), the port's app with inline reads and the port's app
without them (the executor path); all three must answer alike (status,
content type, body).  A spy on the port's read services records whether
each call ran under the host-only budget, so the inline path is seen
to run, and to hand a device-bound read back to the executor.
"""

from __future__ import annotations

import copy
import random
import uuid
from datetime import datetime, timezone

import pytest
import requests

pytest.importorskip("cryptography")

from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.services import scd as r_scd_mod
from dss_tpu_torch import native
from dss_tpu_torch.api import app as p_app
from dss_tpu_torch.api.app import RID_SCOPES, SCD_SCOPES, build_app
from dss_tpu_torch.auth.authorizer import Authorizer, StaticKeyResolver
from dss_tpu_torch.clock import FakeClock
from dss_tpu_torch.dar import budget
from dss_tpu_torch.dar.dss_store import DSSStore
from dss_tpu_torch.ops.fastpath import FastTable
from dss_tpu_torch.services.rid import RIDService
from dss_tpu_torch.services import scd as p_scd_mod
from dss_tpu_torch.services.scd import SCDService
from tests import test_http_api as ref_http
from tests.live_server import LiveServer
from tests.test_torch_http_api import _ref_app
from tests.test_torch_services import SeededUUID

NOW = datetime.now(timezone.utc).replace(microsecond=0)
READS = ("get_isa", "search_isas", "get_subscription", "search_subscriptions",
         "get_operation", "search_operations", "query_subscriptions",
         "get_constraint", "query_constraints")


class ManyClient:
    """Each request to every server; equal status, content type and
    body (JSON parsed) or the request fails; returns the first's."""

    def __init__(self, *bases):
        self.bases = bases
        self.compared = 0

    def _do(self, method, path, **kw):
        got = []
        for base in self.bases:
            r = requests.request(method, base + path, timeout=30,
                                 **copy.deepcopy(kw))
            ctype = r.headers.get("Content-Type", "").split(";")[0]
            body = r.json() if ctype == "application/json" else r.text
            got.append((r, (r.status_code, ctype, body)))
        for g in got[1:]:
            assert g[1] == got[0][1], (method, path)
        self.compared += 1
        return got[0][0]

    def get(self, path, **kw):
        return self._do("GET", path, **kw)

    def put(self, path, **kw):
        return self._do("PUT", path, **kw)

    def post(self, path, **kw):
        return self._do("POST", path, **kw)

    def delete(self, path, **kw):
        return self._do("DELETE", path, **kw)


class SeededUUIDTwice(SeededUUID):
    """The seeded sequence with every value given twice: the two port
    apps take turns on each request, so each sees the reference's
    sequence."""

    def __init__(self, seed=7):
        super().__init__(seed)
        self._held = None

    def uuid4(self):
        if self._held is None:
            self._held = super().uuid4()
            return self._held
        out, self._held = self._held, None
        return out


def _spied_port_app(pub, clock, store, calls, **kw):
    """The port's app (as tests/test_torch_http_api.py builds it) over
    read services that record whether each call ran under the event
    loop's host-only budget."""
    rid, scd = RIDService(store.rid, clock), SCDService(store.scd, clock)
    for svc in (rid, scd):
        for name in READS:
            fn = getattr(svc, name, None)
            if fn is None:
                continue

            def spy(*a, _fn=fn, _name=name, **k):
                calls.append((_name, budget.is_host_only()))
                return _fn(*a, **k)

            setattr(svc, name, spy)
    scopes = dict(RID_SCOPES)
    scopes.update(SCD_SCOPES)
    return build_app(
        rid, scd,
        Authorizer(StaticKeyResolver([pub]), audiences=[ref_http.AUD],
                   scopes_table=scopes),
        enable_scd=True, **kw,
    )


@pytest.fixture
def trio(keypair, monkeypatch):
    assert native.ensure_built()
    # SCD implicit-subscription ids from one seeded sequence on each side
    monkeypatch.setattr(r_scd_mod, "uuidlib", SeededUUID())
    monkeypatch.setattr(p_scd_mod, "uuidlib", SeededUUIDTwice())
    _, pub = keypair
    rc = RFakeClock(NOW)
    rs = RStore(storage="tpu", clock=rc)
    stores, servers, calls = [rs], [], {"inline": [], "executor": []}
    servers.append(LiveServer(_ref_app(pub, rc, rs, inline_reads=True)))
    for kind in ("inline", "executor"):
        pc = FakeClock(NOW)
        ps = DSSStore(storage="cuda", clock=pc, device="cpu")
        app = _spied_port_app(pub, pc, ps, calls[kind],
                              inline_reads=kind == "inline")
        stores.append(ps)
        servers.append(LiveServer(app))
    yield ManyClient(*(s.base for s in servers)), stores, calls
    for s in servers:
        s.stop()
    for s in stores:
        s.close()


def test_native_ready_follows_the_library():
    assert native.ensure_built()
    assert p_app._native_ready() is True
    assert p_app._native_ready() is native.available()


HTTP_CASES = [
    getattr(ref_http, n) for n in sorted(
        (n for n in dir(ref_http) if n.startswith("test_")),
        key=lambda n: getattr(ref_http, n).__code__.co_firstlineno,
    )
]


def test_inline_reads_answer_as_the_executor_and_the_reference(trio,
                                                               keypair):
    """The reference's HTTP script on the three servers: every answer
    alike, the port's inline app served its reads on the loop (host-only
    budget), the executor app never did."""
    client, _, calls = trio
    args = {"client": client, "keypair": keypair}
    for case in HTTP_CASES:
        case(*[args[a] for a in case.__code__.co_varnames[
            :case.__code__.co_argcount]])
    assert client.compared > 20
    inline = [c for c in calls["inline"] if c[0] in ("search_isas",
                                                     "get_isa")]
    assert inline and all(host_only for _, host_only in inline)
    assert calls["executor"] and not any(h for _, h in calls["executor"])
    assert [n for n, _ in calls["inline"]] == [n for n, _ in calls["executor"]]


AREA = "40.0,-100.0,40.02,-100.0,40.02,-99.98,40.0,-99.98"
# a slightly larger square over the same ISAs: not a read-cache hit
AREA2 = "39.999,-100.001,40.021,-100.001,40.021,-99.979,39.999,-99.979"


def test_device_bound_inline_read_reruns_on_the_executor(trio, keypair,
                                                         monkeypatch):
    """ISAs folded into a device tier; with the host-scan candidate cap
    at 0 every tier search needs the device, so the inline attempt
    raises NeedsDevice and the same read re-runs on the executor: two
    service calls (host-only, then not) and the reference's answer."""
    client, stores, calls = trio
    h = ref_http.hdr(keypair)
    ids = [str(uuid.UUID(int=77 + i, version=4)) for i in range(6)]
    for isa_id in ids:
        r = client.put(f"/v1/dss/identification_service_areas/{isa_id}",
                       json=ref_http.isa_params(), headers=h)
        assert r.status_code == 200, r.text
    for ps in stores[1:]:
        assert ps.rid._isa_index.table.fold()
    # on the host first: one inline call answers
    calls["inline"].clear()
    r = client.get(f"/v1/dss/identification_service_areas?area={AREA}",
                   headers=h)
    assert r.status_code == 200
    assert sorted(s["id"] for s in r.json()["service_areas"]) == sorted(ids)
    assert calls["inline"] == [("search_isas", True)]
    # device-bound: the inline attempt is abandoned, the executor answers
    monkeypatch.setattr(FastTable, "HOST_MAX_CANDIDATES", 0)
    calls["inline"].clear()
    calls["executor"].clear()
    r = client.get(f"/v1/dss/identification_service_areas?area={AREA2}",
                   headers=h)
    assert r.status_code == 200
    assert sorted(s["id"] for s in r.json()["service_areas"]) == sorted(ids)
    assert calls["inline"] == [("search_isas", True), ("search_isas", False)]
    assert calls["executor"] == [("search_isas", False)]

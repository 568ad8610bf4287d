"""The port's REST app (dss_tpu_torch/api/app.py) against the reference's.

Both `build_app`s run in-process on a live socket (tests/live_server.py),
each over its own services and store under its own FakeClock set to one
instant, with the same RS256 key and scope tables.  Every request script
of tests/test_http_api.py runs against a TwinClient: each request goes
to both servers, and the status, content type and body (versions and
OVNs included) must be equal before the reference's response goes back
to the test's own assertions.  The port's store is `cuda` on the CPU
(the kernels' plain versions); the reference's is `tpu`.

The cases of tests/test_wire_validation.py (malformed wire scalars map
to 400, never 500) run on twin services, each answer compared.  Then
the port's own surface: /metrics and /status beside the reference's,
the torch.profiler capture behind /debug/profile, and the later-slice
arguments that raise.
"""

from __future__ import annotations

import copy
import json
from datetime import datetime, timezone

import pytest
import requests

pytest.importorskip("cryptography")

from dss_tpu.api.app import RID_SCOPES as R_RID_SCOPES
from dss_tpu.api.app import SCD_SCOPES as R_SCD_SCOPES
from dss_tpu.api.app import build_app as r_build_app
from dss_tpu.auth.authorizer import Authorizer as RAuthorizer
from dss_tpu.auth.authorizer import StaticKeyResolver as RResolver
from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.obs.metrics import MetricsRegistry as RMetrics
from dss_tpu.services.rid import RIDService as RRIDService
from dss_tpu.services.scd import SCDService as RSCDService
from dss_tpu_torch.api import app as p_app
from dss_tpu_torch.api.app import RID_SCOPES, SCD_SCOPES, build_app
from dss_tpu_torch.auth.authorizer import Authorizer, StaticKeyResolver
from dss_tpu_torch.clock import FakeClock
from dss_tpu_torch.dar.dss_store import DSSStore
from dss_tpu_torch.obs.metrics import MetricsRegistry
from dss_tpu_torch.services.rid import RIDService
from dss_tpu_torch.services.scd import SCDService
from tests import test_http_api as ref_http
from tests import test_wire_validation as ref_wire
from tests.live_server import LiveServer
from tests.test_torch_services import PAIRS, make_twin, seeded_uuids  # noqa: F401

NOW = datetime.now(timezone.utc).replace(microsecond=0)


def _ref_app(pub, clock, store, **kw):
    scopes = dict(R_RID_SCOPES)
    scopes.update(R_SCD_SCOPES)
    return r_build_app(
        RRIDService(store.rid, clock), RSCDService(store.scd, clock),
        RAuthorizer(RResolver([pub]), audiences=[ref_http.AUD],
                    scopes_table=scopes),
        enable_scd=True, **kw,
    )


def _port_app(pub, clock, store, **kw):
    scopes = dict(RID_SCOPES)
    scopes.update(SCD_SCOPES)
    return build_app(
        RIDService(store.rid, clock), SCDService(store.scd, clock),
        Authorizer(StaticKeyResolver([pub]), audiences=[ref_http.AUD],
                   scopes_table=scopes),
        enable_scd=True, **kw,
    )


class TwinClient:
    """requests to both servers; equal status, content type and body
    (JSON parsed) or the request fails; returns the reference's."""

    def __init__(self, ref_base, port_base):
        self.bases = (ref_base, port_base)
        self.compared = 0

    def _do(self, method, path, **kw):
        got = []
        for base in self.bases:
            r = requests.request(method, base + path, timeout=30,
                                 **copy.deepcopy(kw))
            ctype = r.headers.get("Content-Type", "").split(";")[0]
            body = r.json() if ctype == "application/json" else r.text
            got.append((r, (r.status_code, ctype, body)))
        assert got[1][1] == got[0][1], (method, path)
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


@pytest.fixture(scope="module")
def twin(keypair):
    _, pub = keypair
    rc, pc = RFakeClock(NOW), FakeClock(NOW)
    rs = RStore(storage="tpu", clock=rc)
    ps = DSSStore(storage="cuda", clock=pc, device="cpu")
    ref = LiveServer(_ref_app(pub, rc, rs))
    port = LiveServer(_port_app(pub, pc, ps))
    yield TwinClient(ref.base, port.base)
    ref.stop()
    port.stop()
    rs.close()
    ps.close()


HTTP_CASES = [
    getattr(ref_http, n) for n in sorted(
        (n for n in dir(ref_http) if n.startswith("test_")),
        key=lambda n: getattr(ref_http, n).__code__.co_firstlineno,
    )
]


def test_every_http_case_of_the_reference_is_here():
    assert len(HTTP_CASES) == 10


@pytest.mark.parametrize("case", HTTP_CASES, ids=lambda f: f.__name__)
def test_http_case_matches_reference(case, twin, keypair):
    """The reference's script, in its file's order, on both servers
    (state carries from case to case, as in the reference's module)."""
    n = twin.compared
    args = {"client": twin, "keypair": keypair}
    case(*[args[a] for a in case.__code__.co_varnames[
        :case.__code__.co_argcount]])
    assert twin.compared > n


# -- tests/test_wire_validation.py on twin services -----------------------------


WIRE_CASES = [
    getattr(ref_wire, n) for n in dir(ref_wire) if n.startswith("test_")
]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("case", WIRE_CASES, ids=lambda f: f.__name__)
def test_wire_validation_case_matches_reference(case, pair):
    arg = case.__code__.co_varnames[0]
    twin = make_twin(pair, "scd" if arg == "scd_svc" else "rid")
    try:
        case(twin)
        assert twin.calls > 0
    finally:
        for s in twin.stores:
            s.close()


# -- the port's own surface ---------------------------------------------------


def _metric_names(text):
    return {
        line.split("{")[0].split(" ")[0]
        for line in text.splitlines() if line and not line.startswith("#")
    }


def test_metrics_and_status_beside_the_reference(keypair):
    """/metrics carries the reference's families plus the store's
    co_res_graph_* gauges; /status the same keys; X-Request-Id echoes
    verbatim on both."""
    _, pub = keypair
    rc, pc = RFakeClock(NOW), FakeClock(NOW)
    rs = RStore(storage="tpu", clock=rc)
    ps = DSSStore(storage="cuda", clock=pc, device="cpu")
    servers = [
        LiveServer(_ref_app(pub, rc, rs, metrics=RMetrics(),
                            stats_fn=rs.stats,
                            status_fn=rs.freshness_status)),
        LiveServer(_port_app(pub, pc, ps, metrics=MetricsRegistry(),
                             stats_fn=ps.stats,
                             status_fn=ps.freshness_status)),
    ]
    try:
        got = []
        for srv in servers:
            r = requests.get(srv.base + "/healthy",
                             headers={"X-Request-Id": "abc-123"}, timeout=10)
            assert r.headers["X-Request-Id"] == "abc-123"
            m = requests.get(srv.base + "/metrics", timeout=10)
            st = requests.get(srv.base + "/status", timeout=10)
            assert m.status_code == st.status_code == 200
            got.append((_metric_names(m.text), st.json()))
        (r_names, r_status), (p_names, p_status) = got
        graph = {n for n in p_names if "_co_res_graph_" in n}
        assert graph and all(
            n.split("_co_res_graph_")[1] in ("busy", "captures",
                                             "capture_failures")
            for n in graph
        )
        assert p_names - graph == r_names
        assert set(p_status) == set(r_status)
    finally:
        for srv in servers:
            srv.stop()
        rs.close()
        ps.close()


def test_debug_profile_writes_a_torch_trace(keypair, tmp_path):
    """POST /debug/profile records a torch.profiler Chrome trace into
    profile_dir, with the reference's bounds, lock and response."""
    priv, pub = keypair
    pc = FakeClock(NOW)
    ps = DSSStore(storage="memory", clock=pc)
    prof = tmp_path / "prof"
    srv = LiveServer(_port_app(pub, pc, ps, profile_dir=str(prof)))
    try:
        h = ref_http.hdr(keypair)
        r = requests.post(srv.base + "/debug/profile?seconds=0",
                          headers=h, timeout=10)
        assert r.status_code == 400
        r = requests.post(srv.base + "/debug/profile?seconds=0.2",
                          headers=h, timeout=30)
        assert r.status_code == 200, r.text
        assert r.json() == {"profile_dir": str(prof), "seconds": 0.2}
        traces = list(prof.glob("*.json"))
        assert len(traces) == 1
        assert "traceEvents" in json.loads(traces[0].read_text())
    finally:
        srv.stop()
        ps.close()


def test_later_slice_arguments_raise():
    with pytest.raises(NotImplementedError, match="federation slice"):
        build_app(federation=object())
    # the read-worker proxy is the shm front's, ported
    assert callable(p_app.make_worker_proxy_middleware("http://127.0.0.1:1"))
    # inline reads follow the native library (no longer a later slice)
    from dss_tpu_torch import native

    assert p_app._native_ready() is native.available()

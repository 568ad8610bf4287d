"""Two-region federation dryrun: the cross-region chaos drill.

Two legs, both emitting a verdict dict (the reference's bench.py --leg
federation wraps its own as FED_r01.json):

  faultplan   IN-PROCESS two regions with a SEEDED FaultPlan
              partitioning the region.federation.request/sync sites —
              every hit is driven by this function (no threads), so
              the injected partition and its heal-by-count are
              byte-for-byte replayable.  Proves: stale serving inside
              the declared bound, honest 503s for remote-owned
              writes, FEDERATION_DEGRADED enter/exit, bit-identical
              convergence after heal.
  sigkill     FOUR OS processes — two region log servers, two DSS
              servers in region mode federated over real sockets —
              disjoint cell ownership, a global query proven
              bit-identical to a merged-state oracle, then SIGKILL of
              one whole region (DSS server AND its region log).  The
              survivor keeps serving its own airspace with zero 5xx,
              serves cross-region reads declared-lag stale from its
              follower mirror, 503s writes to the dead region's cells
              with an honest Retry-After, and — after the dead region
              restarts from its region log — converges with zero
              acked-write loss and walks the ladder back to HEALTHY.

The port of the reference's `dss_tpu/cmds/federation_dryrun.py`.  As
a port entry point it runs on the card unless asked otherwise: every
DSS store of both legs is `storage="cuda"` on `--device` (default
`cuda`, which raises on a machine without a card; `--device cpu` runs
the DAR tables' plain versions), where the reference's dryrun runs
`memory` stores on its CPU.  The merged-state oracle stays a `memory`
store.  Its HTTP calls ride `http.client` through the region client's
transport (the reference rides `requests`), and each child process
logs to a file in the run's directory.

Usage:  python -m dss_tpu_torch.cmds.federation_dryrun --run
            [--leg all|faultplan|sigkill] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from dss_tpu_torch.region.client import TransportError, _Transport

# two geographic boxes whose level-13 coverings occupy disjoint DAR
# key ranges (verified at runtime): the 41N box keys sort BELOW the
# 40N box keys, so one boundary key splits them cleanly
BOX_A = [(40.0, -100.0), (40.02, -100.0), (40.02, -99.98),
         (40.0, -99.98)]  # high keys -> region "a"
BOX_B = [(41.0, -100.0), (41.02, -100.0), (41.02, -99.98),
         (41.0, -99.98)]  # low keys -> region "b"
# the global strip spanning both (under the 2500 km2 area cap)
STRIP = [(40.0, -100.0), (41.02, -100.0), (41.02, -99.99),
         (40.0, -99.99)]


def _area(pts) -> str:
    return ",".join(f"{lat},{lng}" for lat, lng in pts)


def _iso(offset_s: float) -> str:
    t = time.time() + offset_s
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + "Z"


def _isa_params(box, t0=60, t1=6 * 3600) -> dict:
    return {
        "extents": {
            "spatial_volume": {
                "footprint": {
                    "vertices": [
                        {"lat": lat, "lng": lng} for lat, lng in box
                    ]
                },
                "altitude_lo": 20.0,
                "altitude_hi": 400.0,
            },
            "time_start": _iso(t0),
            "time_end": _iso(t1),
        },
        "flights_url": "https://uss1.example.com/flights",
    }


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_HTTP = _Transport({})


def _http(method: str, url: str, *, timeout: float = 15.0, **kw):
    """One HTTP exchange -> the region client's Response (status_code,
    headers, json()); TransportError below the status line."""
    return _HTTP.request(method, url, timeout=timeout, **kw)


def _wait_http(url: str, proc, what: str, deadline_s: float = 60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if proc is not None and proc.p.poll() is not None:
            raise RuntimeError(f"{what} exited at startup:\n{proc.tail()}")
        try:
            if _http("GET", url, timeout=1).status_code == 200:
                return
        except TransportError:
            pass
        time.sleep(0.1)
    raise RuntimeError(f"{what} never became healthy at {url}")


# -- leg 1: seeded-FaultPlan partition, fully in-process ----------------------


def run_faultplan_leg(seed: int = 13, device: str = "cuda") -> dict:
    """Deterministic injected cross-region partition: every fault-site
    hit is driven by this function, so the seeded plan's injection
    sequence (and the heal, by count exhaustion) replays exactly.
    Both regions are `cuda` stores on `device`."""
    from dss_tpu_torch import chaos
    from dss_tpu_torch.clock import Clock
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.geo.s2cell import dar_key_to_cell
    from dss_tpu_torch.models import rid as ridm
    from dss_tpu_torch.region import federation as fed

    BOUNDARY = 1000
    t0 = __import__("datetime").datetime.now(
        __import__("datetime").timezone.utc
    ) + __import__("datetime").timedelta(minutes=5)
    t1 = t0 + __import__("datetime").timedelta(hours=12)

    def isa(n, keys):
        return ridm.IdentificationServiceArea(
            id=str(uuid.UUID(int=n + 1, version=4)), owner="drill",
            url="https://uss1.example/flights",
            cells=dar_key_to_cell(np.asarray(list(keys), np.int64)),
            start_time=t0, end_time=t1,
            altitude_lo=0.0, altitude_hi=3000.0,
        )

    chaos.clear_plan()
    chaos.registry().reset_counters()
    entries = [fed.RegionEntry("a"), fed.RegionEntry("b")]
    routers: Dict[str, fed.FederationRouter] = {}

    def transport_to(region_id):
        def transport(method, path, payload):
            # the in-process twin of HttpPeerTransport: same fault
            # site, same detail shape, same serve_* entry points
            chaos.fault_point(
                "region.federation.request", detail=f"{region_id}:{path}"
            )
            if path.endswith("/query"):
                return fed.serve_query(routers[region_id], payload)
            return fed.serve_sync(routers[region_id])

        return transport

    stores = {}
    for local, remote in (("a", "b"), ("b", "a")):
        fmap = fed.FederationMap(
            entries, np.array([BOUNDARY], np.int32), local
        )
        routers[local] = fed.FederationRouter(
            fmap,
            {remote: fed.FederationPeer(
                remote, transport_to(remote),
                fail_threshold=3, reset_s=0.05,
            )},
            stale_lag_s=30.0,
        )
        stores[local] = DSSStore(
            storage="cuda", device=device, clock=Clock()
        )
        stores[local].attach_federation(routers[local])
        routers[local].close()  # hits driven explicitly, not by thread
    sa, sb = stores["a"], stores["b"]
    ra = routers["a"]
    area = dar_key_to_cell(np.arange(0, 1300, dtype=np.int64))
    out = {"ok": False}
    try:
        for i in range(3):
            assert sa.rid.insert_isa(isa(i, range(10 * i, 10 * i + 4)))
            assert sb.rid.insert_isa(
                isa(100 + i, range(1100 + 10 * i, 1104 + 10 * i))
            )
        assert ra.sync_peer("b")
        baseline = sorted(
            x.id for x in sa.rid.search_isas(
                area, t0, None, allow_stale=True
            )
        )
        assert len(baseline) == 6

        # the seeded partition: both federation sites, heal by count
        chaos.install_plan({
            "seed": seed,
            "events": [
                {"site": "region.federation.request", "match": "b:",
                 "action": "partition", "count": 4},
                {"site": "region.federation.sync", "match": "b",
                 "action": "partition", "count": 4},
            ],
        })
        stale_served = 0
        shed_writes = 0
        degraded_seen = False
        # drive hits deterministically: sync, query, write attempt
        for step in range(8):
            synced = ra.sync_peer("b")
            got = sorted(
                x.id for x in sa.rid.search_isas(
                    area, t0, None, allow_stale=True
                )
            )
            assert got == baseline, (step, got)
            note = fed.take_fed_note()
            if note and note["mode"] == "stale":
                stale_served += 1
            if sa.health.is_active("federation_degraded"):
                degraded_seen = True
                try:
                    sa.rid.insert_isa(isa(700 + step, range(1200, 1204)))
                except fed.FederationUnavailable as e:
                    assert e.retry_after_s > 0
                    shed_writes += 1
            # local airspace always serves
            assert len(sa.rid.search_isas(
                dar_key_to_cell(np.arange(0, 50, dtype=np.int64)),
                t0, None, allow_stale=True,
            )) == 3
            if synced and step > 0 and not sa.health.is_active(
                "federation_degraded"
            ) and degraded_seen:
                break
        assert degraded_seen, "ladder never entered FEDERATION_DEGRADED"
        assert stale_served > 0, "no stale-mirror serve observed"
        assert shed_writes > 0, "no remote-owned write shed observed"
        # plan exhausted: converge, ladder back to HEALTHY
        chaos.clear_plan()
        assert sb.rid.insert_isa(isa(130, range(1250, 1254)))
        deadline = time.monotonic() + 5.0
        while not ra.sync_peer("b"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert sa.health.mode_name() == "healthy"
        final = sorted(
            x.id for x in sa.rid.search_isas(
                area, t0, None, allow_stale=True
            )
        )
        assert len(final) == 7 and str(
            uuid.UUID(int=131, version=4)
        ) in final
        inj = chaos.registry().injected_by_site()
        out.update(
            ok=True,
            seed=seed,
            injected=inj,
            stale_served=stale_served,
            shed_writes=shed_writes,
            dwell_s=round(
                sa.health.dwell_s("federation_degraded"), 4
            ),
        )
    finally:
        chaos.clear_plan()
        fed.take_fed_note()
        for s in stores.values():
            s.close()
    return out


# -- leg 2: SIGKILL a whole region over real processes ------------------------


class _Proc:
    def __init__(self, argv: List[str], what: str, env=None,
                 log_dir: str = ""):
        e = dict(os.environ)
        if env:
            e.update(env)
        self.what = what
        # a file, not a pipe: a server logs every request, and an
        # undrained pipe would stall it
        self.log_path = os.path.join(log_dir or tempfile.gettempdir(),
                                     f"{what}.log")
        with open(self.log_path, "wb") as log:
            self.p = subprocess.Popen(
                [sys.executable, "-m", *argv],
                stdout=subprocess.DEVNULL,
                stderr=log,
                env=e,
            )

    def tail(self, n: int = 4000) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                return fh.read().decode(errors="replace")[-n:]
        except OSError:
            return ""

    def kill9(self):
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGKILL)
            self.p.wait(timeout=10)

    def stop(self):
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGTERM)
            try:
                self.p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(timeout=5)


def _split_boundary():
    """Verify the two boxes' key ranges are disjoint and return the
    splitting boundary (b low, a high)."""
    from dss_tpu_torch.geo import covering as geo_covering
    from dss_tpu_torch.geo.s2cell import cell_to_dar_key

    ka = cell_to_dar_key(geo_covering.area_to_cell_ids(_area(BOX_A)))
    kb = cell_to_dar_key(geo_covering.area_to_cell_ids(_area(BOX_B)))
    if int(kb.max()) >= int(ka.min()):
        raise RuntimeError(
            f"dryrun boxes' key ranges overlap: b<= {int(kb.max())}, "
            f"a>= {int(ka.min())}"
        )
    return (int(kb.max()) + int(ka.min())) // 2


def _oracle_docs(sync_bodies: List[dict], area_cells) -> List[dict]:
    """The merged-region oracle: ONE store restored from every
    region's serialized state, searched with the same covering.
    Returns service-layer ISA JSON sorted by id."""
    from datetime import datetime, timezone

    from dss_tpu_torch.clock import Clock
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.services import serialization as ser

    merged = {"isas": [], "subs": []}
    for body in sync_bodies:
        st = body["state"]["rid"]
        merged["isas"].extend(st["isas"])
        merged["subs"].extend(st["subs"])
    oracle = DSSStore(storage="memory", clock=Clock())
    try:
        oracle.rid.restore_state(merged)
        recs = oracle.rid.search_isas(
            area_cells, datetime.now(timezone.utc), None
        )
        return sorted(
            (ser.isa_to_json(r) for r in recs), key=lambda d: d["id"]
        )
    finally:
        oracle.close()


def run_sigkill_leg(tmpdir: str, device: str = "cuda",
                    on_ready: Optional[Callable[[], dict]] = None) -> dict:
    """`on_ready`, when given, is called once both DSS servers first
    answer /healthy (before any write); its dict is reported under
    "on_ready" (the smoke reads the card's memory there)."""
    from dss_tpu_torch.geo import covering as geo_covering

    boundary = _split_boundary()
    strip_cells = geo_covering.area_to_cell_ids(_area(STRIP))
    ports = {k: _free_port() for k in ("log_a", "log_b", "dss_a", "dss_b")}
    log_a = f"http://127.0.0.1:{ports['log_a']}"
    log_b = f"http://127.0.0.1:{ports['log_b']}"
    dss_a = f"http://127.0.0.1:{ports['dss_a']}"
    dss_b = f"http://127.0.0.1:{ports['dss_b']}"

    fmap_path = os.path.join(tmpdir, "fmap.json")
    with open(fmap_path, "w", encoding="utf-8") as fh:
        json.dump({
            "format": 1,
            "local": "a",
            "regions": [
                {"id": "b", "urls": [dss_b], "capacity_weight": 1.0},
                {"id": "a", "urls": [dss_a], "capacity_weight": 1.0},
            ],
            "boundaries": [boundary],
        }, fh)

    fed_env = {
        "DSS_FED_SYNC_INTERVAL_S": "0.25",
        "DSS_FED_BREAKER_FAILS": "3",
        "DSS_FED_BREAKER_RESET_S": "1.0",
        "DSS_FED_STALE_LAG_S": "60",
        "DSS_FED_PEER_TIMEOUT_S": "2.0",
    }

    def region_proc(port, wal, what):
        return _Proc(
            ["dss_tpu_torch.cmds.region_server",
             "--addr", f"127.0.0.1:{port}",
             "--wal_path", wal],
            what,
            log_dir=tmpdir,
        )

    def dss_proc(port, region_url, local, what):
        return _Proc(
            ["dss_tpu_torch.cmds.server",
             "--addr", f"127.0.0.1:{port}",
             "--storage", "cuda",
             "--device", device,
             "--insecure_no_auth",
             "--no_warmup",
             "--region_url", region_url,
             "--region_poll_interval", "0.02",
             "--instance_id", f"fed-{local}",
             "--federation_map", fmap_path,
             "--federation_region", local],
            what,
            env=fed_env,
            log_dir=tmpdir,
        )

    procs: Dict[str, Optional[_Proc]] = {}
    counts = {"total": 0, "unexpected": 0}

    def req(method, url, expect, what, **kw):
        counts["total"] += 1
        r = _http(method, url, **kw)
        if r.status_code not in expect:
            counts["unexpected"] += 1
            raise RuntimeError(
                f"{what}: {r.status_code} not in {expect}: "
                f"{r.text[:300]}"
            )
        return r

    out = {"ok": False, "boundary": boundary}
    try:
        procs["log_a"] = region_proc(
            ports["log_a"], os.path.join(tmpdir, "ra.wal"), "log-a"
        )
        procs["log_b"] = region_proc(
            ports["log_b"], os.path.join(tmpdir, "rb.wal"), "log-b"
        )
        _wait_http(log_a + "/status", procs["log_a"], "log-a")
        _wait_http(log_b + "/status", procs["log_b"], "log-b")
        procs["dss_a"] = dss_proc(ports["dss_a"], log_a, "a", "dss-a")
        procs["dss_b"] = dss_proc(ports["dss_b"], log_b, "b", "dss-b")
        _wait_http(dss_a + "/healthy", procs["dss_a"], "dss-a")
        _wait_http(dss_b + "/healthy", procs["dss_b"], "dss-b")
        if on_ready is not None:
            out["on_ready"] = on_ready()

        # both links up before phase 1: each server's sync loop starts
        # failing (and opens its breaker) while the other still boots,
        # and closes it at its first good sync, up to one sync interval
        # after the peer is healthy.  The healthy-path misroute below
        # must not land in that window (a 503 where a 400 is due).
        deadline = time.monotonic() + 30.0
        while True:
            links = [
                req("GET", base + "/status", (200,), f"status-{k}").json()
                for k, base in (("a", dss_a), ("b", dss_b))
            ]
            if all(st["federation"]["peers"][peer]["breaker"] == 0
                   and st["degraded_mode"] == "healthy"
                   for st, peer in zip(links, ("b", "a"))):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"links never came up: "
                    f"{[st['federation'] for st in links]}"
                )
            time.sleep(0.1)

        # -- phase 1: disjoint writes, each region its own airspace --
        ids_a, ids_b = [], []
        for i in range(4):
            ia, ib = str(uuid.uuid4()), str(uuid.uuid4())
            req("PUT",
                f"{dss_a}/v1/dss/identification_service_areas/{ia}",
                (200,), "put-a", json=_isa_params(BOX_A))
            req("PUT",
                f"{dss_b}/v1/dss/identification_service_areas/{ib}",
                (200,), "put-b", json=_isa_params(BOX_B))
            ids_a.append(ia)
            ids_b.append(ib)
        # healthy-path misroute: writing b's airspace at a is a
        # client routing error (400 + owner hint), not a 5xx
        r = _http(
            "PUT",
            f"{dss_a}/v1/dss/identification_service_areas/"
            f"{uuid.uuid4()}",
            json=_isa_params(BOX_B),
        )
        if r.status_code != 400:
            raise RuntimeError(
                f"healthy misroute gave {r.status_code}: {r.text[:200]}"
            )

        # wait for both follower mirrors to hold the remote ISAs
        deadline = time.monotonic() + 30.0
        while True:
            st_a = req("GET", dss_a + "/status", (200,), "status-a").json()
            st_b = req("GET", dss_b + "/status", (200,), "status-b").json()
            ma = st_a["federation"]["peers"]["b"]["mirror_counts"]
            mb = st_b["federation"]["peers"]["a"]["mirror_counts"]
            if ma.get("isa") == 4 and mb.get("isa") == 4:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"mirrors never warmed: a<-b={ma} b<-a={mb}"
                )
            time.sleep(0.2)

        # -- phase 2: global query bit-identical to the merged oracle
        strip = _area(STRIP)
        search = "/v1/dss/identification_service_areas"
        syncs = [
            req("GET", dss_a + "/aux/v1/federation/sync", (200,),
                "sync-a").json(),
            req("GET", dss_b + "/aux/v1/federation/sync", (200,),
                "sync-b").json(),
        ]
        want = _oracle_docs(syncs, strip_cells)
        if len(want) != 8:
            raise RuntimeError(f"oracle sees {len(want)} ISAs, want 8")
        fed_headers = {}
        for name, base in (("a", dss_a), ("b", dss_b)):
            r = req("GET", base + search, (200,), f"global-{name}",
                    params={"area": strip})
            got = sorted(
                r.json()["service_areas"], key=lambda d: d["id"]
            )
            if got != want:
                raise RuntimeError(
                    f"global query at {name} diverged from the merged "
                    f"oracle ({len(got)} vs {len(want)} docs)"
                )
            fed_headers[name] = r.headers.get("X-DSS-Freshness", "")
            if "region=" not in fed_headers[name]:
                raise RuntimeError(
                    f"no region in freshness header: {fed_headers}"
                )
        out["bit_identical"] = True

        # -- phase 3: SIGKILL region b entirely (DSS + its log) ------
        t_kill = time.monotonic()
        procs["dss_b"].kill9()
        procs["log_b"].kill9()

        # survivor's own airspace: zero 5xx throughout.  Counted raw
        # (not via req(), which would abort on the first bad status)
        # so the emitted local_5xx figure is a real measurement over
        # all 15 probes, then gated once at the end.
        local_5xx = 0
        for _ in range(15):
            counts["total"] += 1
            r = _http(
                "GET", dss_a + search, params={"area": _area(BOX_A)},
            )
            if r.status_code >= 500:
                counts["unexpected"] += 1
                local_5xx += 1
        if local_5xx:
            raise RuntimeError(
                f"local-airspace serving returned {local_5xx} 5xx "
                f"during the partition"
            )
        # cross-region reads: declared-lag stale from the mirror,
        # same answer as pre-kill
        r = req("GET", dss_a + search, (200,), "stale-global",
                params={"area": strip})
        got = sorted(r.json()["service_areas"], key=lambda d: d["id"])
        if got != want:
            raise RuntimeError("stale global read diverged from oracle")
        h = r.headers.get("X-DSS-Freshness", "")
        if "fed=stale" not in h or "lag=" not in h:
            raise RuntimeError(f"stale read not marked stale: {h!r}")
        # the ladder walks up as the sync loop's breaker opens
        deadline = time.monotonic() + 15.0
        while True:
            st = req("GET", dss_a + "/status", (200,), "status").json()
            if st["degraded_mode"] == "federation_degraded":
                break
            if time.monotonic() > deadline:
                raise RuntimeError("ladder never entered degraded")
            time.sleep(0.2)
        # writes to the dead region's airspace: honest 503+Retry-After
        r = _http(
            "PUT",
            f"{dss_a}/v1/dss/identification_service_areas/"
            f"{uuid.uuid4()}",
            json=_isa_params(BOX_B),
        )
        counts["total"] += 1
        if r.status_code != 503 or "Retry-After" not in r.headers:
            counts["unexpected"] += 1
            raise RuntimeError(
                f"remote-owned write gave {r.status_code} "
                f"(headers {dict(r.headers.items())})"
            )
        # a declared bound the mirror exceeds -> rejected, not staler
        r = _http(
            "GET", dss_a + search, params={"area": strip},
            headers={"X-DSS-Max-Lag": "0"},
        )
        counts["total"] += 1
        if r.status_code != 503 or "Retry-After" not in r.headers:
            counts["unexpected"] += 1
            raise RuntimeError(
                f"over-bound stale read gave {r.status_code}"
            )
        out["partition"] = {
            "local_5xx": local_5xx,
            "stale_marked": True,
            "write_shed_503": True,
            "overbound_shed_503": True,
        }

        # -- phase 4: heal — restart region b from its region log ----
        t_restart = time.monotonic()
        procs["log_b"] = region_proc(
            ports["log_b"], os.path.join(tmpdir, "rb.wal"), "log-b2"
        )
        _wait_http(log_b + "/status", procs["log_b"], "log-b2")
        procs["dss_b"] = dss_proc(ports["dss_b"], log_b, "b", "dss-b2")
        _wait_http(dss_b + "/healthy", procs["dss_b"], "dss-b2")
        deadline = time.monotonic() + 45.0
        while True:
            st = req("GET", dss_a + "/status", (200,), "status").json()
            peers = st["federation"]["peers"]["b"]
            if st["degraded_mode"] == "healthy" and peers["breaker"] == 0:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"never recovered: {st['degraded_mode']} {peers}"
                )
            time.sleep(0.2)
        t_recovered = time.monotonic()

        # zero acked-write loss: every pre-kill ISA of region b is
        # back (replayed from its region log), post-heal writes land,
        # and the global view re-converges with the oracle
        ib2 = str(uuid.uuid4())
        req("PUT",
            f"{dss_b}/v1/dss/identification_service_areas/{ib2}",
            (200,), "put-b-postheal", json=_isa_params(BOX_B))
        syncs = [
            req("GET", dss_a + "/aux/v1/federation/sync", (200,),
                "sync-a2").json(),
            req("GET", dss_b + "/aux/v1/federation/sync", (200,),
                "sync-b2").json(),
        ]
        want2 = _oracle_docs(syncs, strip_cells)
        if len(want2) != 9:
            raise RuntimeError(
                f"post-heal oracle sees {len(want2)} ISAs, want 9 "
                f"(acked-write loss?)"
            )
        got_ids = {d["id"] for d in want2}
        missing = [i for i in ids_a + ids_b if i not in got_ids]
        if missing:
            raise RuntimeError(f"acked writes lost: {missing}")
        r = req("GET", dss_a + search, (200,), "global-postheal",
                params={"area": strip})
        got = sorted(r.json()["service_areas"], key=lambda d: d["id"])
        if got != want2:
            raise RuntimeError("post-heal global read diverged")
        out.update(
            ok=True,
            partition_dwell_s=round(t_recovered - t_kill, 3),
            recovery_s=round(t_recovered - t_restart, 3),
            requests_total=counts["total"],
            unexpected_statuses=counts["unexpected"],
            error_budget_burn=round(
                counts["unexpected"] / max(1, counts["total"]), 6
            ),
        )
    finally:
        for p in procs.values():
            if p is not None:
                p.stop()
        _HTTP.close()
    return out


def run_dryrun(tmpdir: str, device: str = "cuda") -> dict:
    fault = run_faultplan_leg(device=device)
    kill = run_sigkill_leg(tmpdir, device=device)
    return {
        "ok": bool(fault.get("ok")) and bool(kill.get("ok")),
        "faultplan": fault,
        "sigkill": kill,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--run", action="store_true",
        help="run both dryrun legs and print the JSON verdict",
    )
    ap.add_argument(
        "--leg", choices=["all", "faultplan", "sigkill"], default="all",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of every DSS store (default cuda, which raises "
        "without a card; cpu runs the DAR tables' plain versions)",
    )
    args = ap.parse_args()
    if not args.run:
        ap.print_help()
        return 2
    with tempfile.TemporaryDirectory(prefix="dss-fed-") as td:
        if args.leg == "faultplan":
            verdict = run_faultplan_leg(device=args.device)
        elif args.leg == "sigkill":
            verdict = run_sigkill_leg(td, device=args.device)
        else:
            verdict = run_dryrun(td, device=args.device)
    print(json.dumps(verdict, indent=2, default=str))
    return 0 if verdict.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

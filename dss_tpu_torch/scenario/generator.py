"""Deterministic city-scale scenario generator.

The port of the reference's `dss_tpu/scenario/generator.py`: numpy,
hashlib and uuid only, no device code.  The same (name, seed, scale,
duration_s) gives the same request stream and the same `stream_digest`
in both packages (tests/test_torch_scenario.py).

The serving stack so far has been measured under synthetic uniform
load; real UTM traffic has spatial structure — corridors, stadium
closures, diurnal tides — and geospatial batching only pays off when
the workload has that structure (PAPERS.md 1403.0802), while placement
decisions should be driven by measured access patterns, not uniform
synthetics (Fast-OverlaPIM, 2407.00604).  This module produces SEEDED,
REPLAYABLE request streams with that structure; `bench.py --leg
scenario` drives them through the real HTTP stack and reports
per-phase SLOs.

Determinism contract: `build_scenario(name, seed, scale, duration_s)`
is a pure function of its arguments — no wall clock, no process state.
Request bodies carry RELATIVE time sentinels (`rel_time`), materialized
to absolute RFC3339 only at send time, so `stream_digest` is stable
across runs and hosts (the CI scenario-smoke job asserts exactly
this: same seed -> same digest).

Spatial layout: every scenario lives in a metro box around
(47.6, -122.3).  Entity disjointness inside shared footprints is by
altitude band (4D intersection needs altitude overlap), which keeps
every operation PUT conflict-free by construction except where a
scenario *wants* a conflict (the emergency scenario's blocked put).
"""

from __future__ import annotations

import hashlib
import json
import math
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# metro anchor (Seattle-ish); boxes stay well under MAX_AREA_KM2
METRO_LAT, METRO_LNG = 47.6, -122.3

# scope classes a request needs (bench runs --insecure_no_auth, but the
# stream records intent so an authenticated sender can mint per-class
# tokens)
SC, CM, CC = "sc", "cm", "cc"


def env_knobs() -> dict:
    """DSS_SCENARIO_* env knobs (docs/OPERATIONS.md):

      DSS_SCENARIO_SEED       stream seed (default 7)
      DSS_SCENARIO_SCALE      entity/request-count multiplier (1.0)
      DSS_SCENARIO_DURATION_S per-scenario wall budget the timeline is
                              laid out over (45)
      DSS_SCENARIO_SET        comma list of scenario names (all)
      DSS_SCENARIO_STORAGE    server storage backend (cuda)
      DSS_SCENARIO_THREADS    sender threads (8)
    """
    import os

    raw_set = os.environ.get("DSS_SCENARIO_SET", "")
    names = [
        s.strip() for s in raw_set.split(",") if s.strip()
    ] or list(SCENARIOS)
    return {
        "seed": int(os.environ.get("DSS_SCENARIO_SEED", 7)),
        "scale": float(os.environ.get("DSS_SCENARIO_SCALE", 1.0)),
        "duration_s": float(os.environ.get("DSS_SCENARIO_DURATION_S", 45.0)),
        "names": names,
        "storage": os.environ.get("DSS_SCENARIO_STORAGE", "cuda"),
        "threads": int(os.environ.get("DSS_SCENARIO_THREADS", 8)),
    }


@dataclass(frozen=True)
class Request:
    """One timed request.  `t` is seconds from the PHASE start; bodies
    may carry rel_time sentinels (materialize_body resolves them)."""

    t: float
    method: str
    path: str
    body: Optional[dict]
    tag: str
    expect: Tuple[int, ...] = (200,)
    scope: str = SC


@dataclass
class Phase:
    name: str
    requests: List[Request] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return max((r.t for r in self.requests), default=0.0)


@dataclass
class Scenario:
    name: str
    phases: List[Phase]
    meta: dict = field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return sum(len(p.requests) for p in self.phases)


# -- relative-time sentinels -------------------------------------------------


def rel_time(seconds: float, fmt: str = "scd") -> dict:
    """A time field resolved at SEND time to now+seconds, so the
    generated stream contains no wall-clock values (digest stability).
    fmt 'scd' -> {"value": RFC3339, "format": "RFC3339"}; 'rid' -> bare
    RFC3339 string."""
    return {"__rel_s__": float(seconds), "__fmt__": fmt}


def _rfc3339(epoch_s: float) -> str:
    import time as _time

    return _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(epoch_s))


def materialize_body(body, t0_epoch_s: float):
    """Deep-resolve rel_time sentinels against the scenario's start
    instant.  Leaves everything else untouched."""
    if isinstance(body, dict):
        if "__rel_s__" in body:
            stamp = _rfc3339(t0_epoch_s + body["__rel_s__"])
            if body.get("__fmt__") == "rid":
                return stamp
            return {"value": stamp, "format": "RFC3339"}
        return {k: materialize_body(v, t0_epoch_s) for k, v in body.items()}
    if isinstance(body, list):
        return [materialize_body(v, t0_epoch_s) for v in body]
    return body


def stream_digest(sc: Scenario) -> str:
    """sha256 over the canonical JSON of the full stream (phase names,
    schedule, methods, paths, raw bodies WITH sentinels) — the replay
    identity the scenario-smoke CI job pins."""
    doc = [
        [
            p.name,
            [
                [round(r.t, 6), r.method, r.path, r.tag, list(r.expect),
                 r.body]
                for r in p.requests
            ],
        ]
        for p in sc.phases
    ]
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# -- geometry helpers --------------------------------------------------------


def _box(lat: float, lng: float, half_lat: float, half_lng: float) -> list:
    return [
        {"lat": lat - half_lat, "lng": lng - half_lng},
        {"lat": lat - half_lat, "lng": lng + half_lng},
        {"lat": lat + half_lat, "lng": lng + half_lng},
        {"lat": lat + half_lat, "lng": lng - half_lng},
    ]


def scd_extent(
    lat, lng, half_lat, half_lng, alt_lo, alt_hi, t0_rel, t1_rel
) -> dict:
    return {
        "volume": {
            "outline_polygon": {
                "vertices": _box(lat, lng, half_lat, half_lng)
            },
            "altitude_lower": {
                "value": float(alt_lo), "reference": "W84", "units": "M",
            },
            "altitude_upper": {
                "value": float(alt_hi), "reference": "W84", "units": "M",
            },
        },
        "time_start": rel_time(t0_rel),
        "time_end": rel_time(t1_rel),
    }


def _aoi(lat, lng, half_lat, half_lng, alt=(0.0, 5000.0),
         t0_rel=0.0, t1_rel=7200.0) -> dict:
    return {
        "area_of_interest": scd_extent(
            lat, lng, half_lat, half_lng, alt[0], alt[1], t0_rel, t1_rel
        )
    }


def _rid_area(lat, lng, half_lat, half_lng) -> str:
    pts = _box(lat, lng, half_lat, half_lng)
    return ",".join(f"{p['lat']:.5f},{p['lng']:.5f}" for p in pts)


def _uid(space: int, n: int) -> str:
    """Deterministic uuid4-shaped id: `space` isolates scenarios,
    `n` enumerates entities within one."""
    return str(uuid.UUID(int=(space << 64) | n, version=4))


def _spread(n: int, t0: float, t1: float) -> np.ndarray:
    """n send times evenly laid over [t0, t1)."""
    if n <= 0:
        return np.array([])
    return t0 + (t1 - t0) * (np.arange(n) / max(n, 1))


# -- named scenarios ---------------------------------------------------------


def corridors(seed: int, scale: float, duration_s: float) -> Scenario:
    """Drone-delivery corridors: K lane-separated corridors crossing
    the metro, each a chain of segment operations riding one explicit
    subscription.  Phase `build` lays the corridors down; phase
    `cruise` is the steady state — repeat polls along the corridors
    (the read-cache's bread and butter: quantized repeat areas) plus
    op churn (new legs created, old legs retired)."""
    rng = np.random.default_rng(seed * 1000 + 1)
    n_corr = max(2, int(round(8 * scale)))
    n_seg = 6
    build, cruise = Phase("build"), Phase("cruise")
    d_build, d_cruise = 0.35 * duration_s, 0.65 * duration_s

    half = 0.008  # segment half-size (deg)
    corr_axes = []
    for c in range(n_corr):
        # corridor = straight lane across the metro, own heading
        lat0 = METRO_LAT + float(rng.uniform(-0.12, 0.12))
        lng0 = METRO_LNG + float(rng.uniform(-0.15, 0.15))
        dlat = float(rng.uniform(-0.02, 0.02))
        dlng = float(rng.uniform(0.015, 0.03))
        corr_axes.append((lat0, lng0, dlat, dlng))

    # one subscription per corridor covering its bbox (ops + constraints)
    sub_times = _spread(n_corr, 0.0, 0.15 * d_build)
    for c, (lat0, lng0, dlat, dlng) in enumerate(corr_axes):
        clat = lat0 + dlat * (n_seg - 1) / 2
        clng = lng0 + dlng * (n_seg - 1) / 2
        # clamped under the area cap; a corridor sub not covering a
        # tail segment only narrows its notification audience
        hl = min(abs(dlat) * n_seg / 2 + 2 * half, 0.06)
        hg = min(abs(dlng) * n_seg / 2 + 2 * half, 0.08)
        build.requests.append(Request(
            t=float(sub_times[c]), method="PUT",
            path=f"/dss/v1/subscriptions/{_uid(1, c)}",
            body={
                "extents": scd_extent(
                    clat, clng, hl, hg, 0.0, 3000.0, 30.0, 3600.0
                ),
                "uss_base_url": f"https://corr{c}.uss.example",
                "notify_for_operations": True,
                "notify_for_constraints": True,
                "old_version": 0,
            },
            tag="sub_put",
        ))

    # corridor legs: each segment an op in the corridor's altitude
    # lane.  Ops reference the corridor subscriptions (the service
    # 404s a missing subscription_id), so the schedule gives the sub
    # PUTs several seconds of completion slack on a slow host.
    op_times = _spread(
        n_corr * n_seg, max(0.2 * d_build, 3.0), max(d_build, 5.0)
    )
    k = 0
    for c, (lat0, lng0, dlat, dlng) in enumerate(corr_axes):
        for s in range(n_seg):
            alt0 = 40.0 + 8.0 * (c * n_seg + s)
            build.requests.append(Request(
                t=float(op_times[k]), method="PUT",
                path=f"/dss/v1/operation_references/{_uid(2, k)}",
                body={
                    "extents": [scd_extent(
                        lat0 + dlat * s, lng0 + dlng * s, half, half,
                        alt0, alt0 + 5.0, 60.0, 3600.0,
                    )],
                    "uss_base_url": f"https://corr{c}.uss.example",
                    "subscription_id": _uid(1, c),
                    "state": "Accepted",
                    "old_version": 0,
                    "key": [],
                },
                tag="op_put",
            ))
            k += 1

    # cruise: ~85% polls over a QUANTIZED pool of corridor waypoints
    # (repeat areas -> cache hits), ~10% fresh legs, ~5% retirements
    n_cruise = max(30, int(round(260 * scale)))
    poll_pool = []
    for c, (lat0, lng0, dlat, dlng) in enumerate(corr_axes):
        for s in range(0, n_seg, 2):
            poll_pool.append((lat0 + dlat * s, lng0 + dlng * s))
    cruise_times = _spread(n_cruise, 0.0, d_cruise)
    new_leg = 0
    for i in range(n_cruise):
        r = float(rng.uniform())
        if r < 0.85:
            lat, lng = poll_pool[int(rng.integers(0, len(poll_pool)))]
            cruise.requests.append(Request(
                t=float(cruise_times[i]), method="POST",
                path="/dss/v1/operation_references/query",
                body=_aoi(lat, lng, 2 * half, 2 * half),
                tag="poll",
            ))
        elif r < 0.95:
            c = int(rng.integers(0, n_corr))
            lat0, lng0, dlat, dlng = corr_axes[c]
            s = int(rng.integers(0, n_seg))
            alt0 = 40.0 + 8.0 * (n_corr * n_seg + new_leg)
            cruise.requests.append(Request(
                t=float(cruise_times[i]), method="PUT",
                path=f"/dss/v1/operation_references/{_uid(3, new_leg)}",
                body={
                    "extents": [scd_extent(
                        lat0 + dlat * s, lng0 + dlng * s, half, half,
                        alt0, alt0 + 5.0, 60.0, 3600.0,
                    )],
                    "uss_base_url": f"https://corr{c}.uss.example",
                    "subscription_id": _uid(1, c),
                    "state": "Accepted",
                    "old_version": 0,
                    "key": [],
                },
                tag="op_put",
            ))
            new_leg += 1
        else:
            dead = int(rng.integers(0, n_corr * n_seg))
            cruise.requests.append(Request(
                t=float(cruise_times[i]), method="DELETE",
                path=f"/dss/v1/operation_references/{_uid(2, dead)}",
                body=None,
                tag="op_delete",
                # a second retirement of the same leg is a 404 by
                # design (the stream may draw the same leg twice)
                expect=(200, 404),
            ))
    return Scenario(
        "corridors", [build, cruise],
        meta={"corridors": n_corr, "segments": n_seg,
              "cruise_requests": n_cruise},
    )


def mass_event(seed: int, scale: float, duration_s: float) -> Scenario:
    """Mass-event airspace closure: thousands of intents built up over
    a stadium box, then ONE constraint write over the whole box — the
    single most adversarial write shape the stack serves (every
    intersecting subscription fans out, every cached poll of the area
    fences out).  Phases: buildup -> census (one bulk query counting
    intersecting intents) -> closure (the constraint PUT + the poll
    storm of USSs re-checking) -> recheck."""
    rng = np.random.default_rng(seed * 1000 + 2)
    n_int = max(24, int(round(1200 * scale)))
    cols = max(2, int(round(math.sqrt(n_int / 25.0))))
    # stadium district box (~13 x 12 km; the reference's pi-inflated
    # area formula caps usable boxes well under the nominal 2500 km2),
    # split into `cols` lng strips
    half_lat, half_lng = 0.06, 0.08
    strip_hw = half_lng / cols

    buildup = Phase("buildup")
    census = Phase("census")
    closure = Phase("closure")
    recheck = Phase("recheck")
    d_build = 0.55 * duration_s

    # one subscription per strip, notify_for_constraints=True — the
    # fanout audience of the closure write
    sub_times = _spread(cols, 0.0, 0.1 * d_build)
    for c in range(cols):
        lng_c = METRO_LNG - half_lng + (2 * c + 1) * strip_hw
        buildup.requests.append(Request(
            t=float(sub_times[c]), method="PUT",
            path=f"/dss/v1/subscriptions/{_uid(4, c)}",
            body={
                "extents": scd_extent(
                    METRO_LAT, lng_c, half_lat, strip_hw,
                    0.0, 4000.0, 30.0, 7200.0,
                ),
                "uss_base_url": f"https://strip{c}.uss.example",
                "notify_for_operations": True,
                "notify_for_constraints": True,
                "old_version": 0,
            },
            tag="sub_put",
        ))

    # intents: op i lives in strip i%cols; altitude bands are GLOBALLY
    # unique (level-13 coverings are conservative — adjacent strips
    # share boundary cells, so per-strip bands would 4D-conflict).
    # Band pitch derives from the intent count so any scale fits under
    # the 4000 m subscription/constraint ceiling.
    pitch = min(2.5, (4000.0 - 40.0) / max(n_int, 1))
    band_h = 0.6 * pitch
    op_times = _spread(
        n_int, max(0.12 * d_build, 3.0), max(d_build, 5.0)
    )
    for i in range(n_int):
        c = i % cols
        lng_c = METRO_LNG - half_lng + (2 * c + 1) * strip_hw
        alt0 = 30.0 + pitch * i
        buildup.requests.append(Request(
            t=float(op_times[i]), method="PUT",
            path=f"/dss/v1/operation_references/{_uid(5, i)}",
            body={
                "extents": [scd_extent(
                    METRO_LAT, lng_c, half_lat * 0.9, strip_hw * 0.9,
                    alt0, alt0 + band_h, 60.0, 7200.0,
                )],
                "uss_base_url": f"https://strip{c}.uss.example",
                "subscription_id": _uid(4, c),
                "state": "Accepted",
                "old_version": 0,
                "key": [],
            },
            tag="op_put",
        ))

    # census: ONE bulk query over the whole box — the sender reports
    # its result count as intersecting_intents
    census.requests.append(Request(
        t=0.0, method="POST",
        path="/dss/v1/operation_references/query",
        body=_aoi(METRO_LAT, METRO_LNG, half_lat, half_lng),
        tag="intent_census",
    ))

    # closure: THE constraint write (alt 0..3000 covers every band),
    # then the poll storm — constraint queries + op re-checks over the
    # strips, the USS herd reacting to the fanout
    closure.requests.append(Request(
        t=0.0, method="PUT",
        path=f"/dss/v1/constraint_references/{_uid(6, 0)}",
        body={
            "extents": [scd_extent(
                METRO_LAT, METRO_LNG, half_lat, half_lng,
                0.0, 4000.0, 30.0, 7200.0,
            )],
            "uss_base_url": "https://authority.example",
            "old_version": 0,
        },
        tag="closure_put",
        scope=CM,
    ))
    n_storm = max(40, int(round(500 * scale)))
    storm_times = _spread(n_storm, 0.3, 0.30 * duration_s)
    for i in range(n_storm):
        c = int(rng.integers(0, cols))
        lng_c = METRO_LNG - half_lng + (2 * c + 1) * strip_hw
        if rng.uniform() < 0.5:
            closure.requests.append(Request(
                t=float(storm_times[i]), method="POST",
                path="/dss/v1/constraint_references/query",
                body=_aoi(METRO_LAT, lng_c, half_lat, strip_hw),
                tag="cst_poll",
                scope=CC,
            ))
        else:
            closure.requests.append(Request(
                t=float(storm_times[i]), method="POST",
                path="/dss/v1/operation_references/query",
                body=_aoi(METRO_LAT, lng_c, half_lat, strip_hw),
                tag="poll",
            ))

    # recheck: the post-storm steady state — repeat strip polls
    n_re = max(12, int(round(80 * scale)))
    re_times = _spread(n_re, 0.0, 0.12 * duration_s)
    for i in range(n_re):
        c = int(rng.integers(0, cols))
        lng_c = METRO_LNG - half_lng + (2 * c + 1) * strip_hw
        recheck.requests.append(Request(
            t=float(re_times[i]), method="POST",
            path="/dss/v1/constraint_references/query",
            body=_aoi(METRO_LAT, lng_c, half_lat, strip_hw),
            tag="cst_poll",
            scope=CC,
        ))
    return Scenario(
        "mass_event", [buildup, census, closure, recheck],
        meta={"intents": n_int, "strips": cols, "storm": n_storm},
    )


def emergency(seed: int, scale: float, duration_s: float) -> Scenario:
    """Emergency priority operations: steady background traffic, then
    an incident — the authority drops a constraint over the zone, a
    constraint-AWARE op missing its OVN is 409-blocked by design (the
    deconfliction gate exercised through HTTP), the priority op (not
    constraint-gated) goes through, polls spike — then the all-clear
    delete."""
    rng = np.random.default_rng(seed * 1000 + 3)
    n_bg = max(10, int(round(60 * scale)))
    steady = Phase("steady")
    incident = Phase("incident")
    clear = Phase("clear")
    d_steady = 0.4 * duration_s

    zone = (METRO_LAT + 0.05, METRO_LNG - 0.04, 0.03, 0.04)

    # one shared zone-watch subscription carries the background ops
    # (implicit subs would pile onto the per-cell quota in a zone this
    # dense — exactly the USS posture the quota is there to force);
    # notify_for_constraints=True makes the bg fleet constraint-aware
    steady.requests.append(Request(
        t=0.0, method="PUT",
        path=f"/dss/v1/subscriptions/{_uid(7, 999)}",
        body={
            "extents": scd_extent(
                zone[0], zone[1], zone[2] + 0.025, zone[3] + 0.035,
                0.0, 3000.0, 30.0, 5400.0,
            ),
            "uss_base_url": "https://zonewatch.uss.example",
            "notify_for_operations": True,
            "notify_for_constraints": True,
            "old_version": 0,
        },
        tag="sub_put",
    ))
    bg_times = _spread(n_bg, 3.0, max(0.6 * d_steady, 5.0))
    for i in range(n_bg):
        alt0 = 40.0 + 7.0 * i
        steady.requests.append(Request(
            t=float(bg_times[i]), method="PUT",
            path=f"/dss/v1/operation_references/{_uid(7, i)}",
            body={
                "extents": [scd_extent(
                    zone[0] + float(rng.uniform(-0.02, 0.02)),
                    zone[1] + float(rng.uniform(-0.03, 0.03)),
                    0.006, 0.006, alt0, alt0 + 4.0, 60.0, 5400.0,
                )],
                "uss_base_url": f"https://bg{i % 5}.uss.example",
                "subscription_id": _uid(7, 999),
                "state": "Accepted",
                "old_version": 0,
                "key": [],
            },
            tag="op_put",
        ))
    n_poll = max(15, int(round(90 * scale)))
    poll_times = _spread(n_poll, 0.3 * d_steady, d_steady)
    for i in range(n_poll):
        steady.requests.append(Request(
            t=float(poll_times[i]), method="POST",
            path="/dss/v1/operation_references/query",
            body=_aoi(zone[0], zone[1], zone[2], zone[3]),
            tag="poll",
        ))

    # incident opens: authority constraint over the zone
    incident.requests.append(Request(
        t=0.0, method="PUT",
        path=f"/dss/v1/constraint_references/{_uid(8, 0)}",
        body={
            "extents": [scd_extent(
                zone[0], zone[1], zone[2], zone[3],
                0.0, 3000.0, 30.0, 5400.0,
            )],
            "uss_base_url": "https://authority.example",
            "old_version": 0,
        },
        tag="emergency_cst",
        scope=CM,
    ))
    # a constraint-aware USS races in WITHOUT the constraint's OVN in
    # its key: the deconfliction gate must 409 it (by design).  The
    # schedule leaves the closure PUT several seconds of slack — the
    # senders pace by offset only, and a first-use compile on a cold
    # small host can hold the t=0 write long enough that a tight
    # follower would arrive before the constraint exists.
    incident.requests.append(Request(
        t=3.0, method="PUT",
        path=f"/dss/v1/operation_references/{_uid(8, 1)}",
        body={
            "extents": [scd_extent(
                zone[0], zone[1], 0.006, 0.006,
                2400.0, 2420.0, 60.0, 5400.0,
            )],
            "uss_base_url": "https://late.uss.example",
            "new_subscription": {
                "uss_base_url": "https://late.uss.example",
                "notify_for_constraints": True,
            },
            "state": "Accepted",
            "old_version": 0,
            "key": [],
        },
        tag="blocked_put",
        expect=(409,),
    ))
    # the priority (first-responder) op: not constraint-gated, clear
    # altitude band -> goes through while the closure stands
    incident.requests.append(Request(
        t=3.5, method="PUT",
        path=f"/dss/v1/operation_references/{_uid(8, 2)}",
        body={
            "extents": [scd_extent(
                zone[0], zone[1], 0.008, 0.008,
                2800.0, 2830.0, 60.0, 5400.0,
            )],
            "uss_base_url": "https://medevac.uss.example",
            "new_subscription": {
                "uss_base_url": "https://medevac.uss.example",
                "notify_for_constraints": False,
            },
            "state": "Accepted",
            "old_version": 0,
            "key": [],
        },
        tag="priority_put",
    ))
    # poll spike: everyone re-checks the zone
    n_spike = max(20, int(round(160 * scale)))
    spike_times = _spread(n_spike, 4.0, max(0.4 * duration_s, 6.0))
    for i in range(n_spike):
        if rng.uniform() < 0.5:
            incident.requests.append(Request(
                t=float(spike_times[i]), method="POST",
                path="/dss/v1/constraint_references/query",
                body=_aoi(zone[0], zone[1], zone[2], zone[3]),
                tag="cst_poll",
                scope=CC,
            ))
        else:
            incident.requests.append(Request(
                t=float(spike_times[i]), method="POST",
                path="/dss/v1/operation_references/query",
                body=_aoi(zone[0], zone[1], zone[2], zone[3]),
                tag="poll",
            ))

    clear.requests.append(Request(
        t=0.0, method="DELETE",
        path=f"/dss/v1/constraint_references/{_uid(8, 0)}",
        body=None,
        tag="cst_delete",
        scope=CM,
    ))
    n_after = max(8, int(round(40 * scale)))
    after_times = _spread(n_after, 0.5, 0.15 * duration_s)
    for i in range(n_after):
        clear.requests.append(Request(
            t=float(after_times[i]), method="POST",
            path="/dss/v1/operation_references/query",
            body=_aoi(zone[0], zone[1], zone[2], zone[3]),
            tag="poll",
        ))
    return Scenario(
        "emergency", [steady, incident, clear],
        meta={"background_ops": n_bg, "spike": n_spike},
    )


def diurnal(seed: int, scale: float, duration_s: float) -> Scenario:
    """24 h diurnal load curve compressed into the wall budget: a
    two-peak rate profile (morning + evening) over a mixed RID+SCD
    workload — mostly repeat polls over a metro area pool, a write
    tail of ISA/op churn.  Phases are the day parts, so the SLO report
    shows how the stack rides the tide."""
    rng = np.random.default_rng(seed * 1000 + 4)
    n_total = max(120, int(round(1500 * scale)))
    # hourly weights: night trough, 8am and 6pm peaks
    hours = np.arange(24)
    w = (
        0.25
        + 1.0 * np.exp(-0.5 * ((hours - 8.0) / 2.0) ** 2)
        + 0.9 * np.exp(-0.5 * ((hours - 18.0) / 2.5) ** 2)
    )
    w = w / w.sum()
    counts = np.floor(w * n_total).astype(int)
    parts = (
        ("night", 0, 6), ("morning_peak", 6, 10), ("midday", 10, 16),
        ("evening_peak", 16, 21), ("late", 21, 24),
    )
    # quantized metro poll pool (repeat areas -> cache-visible)
    pool = [
        (METRO_LAT - 0.1 + 0.05 * i, METRO_LNG - 0.12 + 0.06 * j)
        for i in range(5) for j in range(5)
    ]
    phases = []
    ent = 0
    isa_n = 0
    first = True
    for name, h0, h1 in parts:
        ph = Phase(name)
        if first:
            # one metro-wide subscription carries the day's op churn
            # (implicit subs would pile onto the per-cell quota at the
            # popular pool points)
            ph.requests.append(Request(
                t=0.0, method="PUT",
                path=f"/dss/v1/subscriptions/{_uid(9, 0)}",
                body={
                    "extents": scd_extent(
                        METRO_LAT, METRO_LNG, 0.06, 0.08,
                        0.0, 3000.0, 30.0, 7200.0,
                    ),
                    "uss_base_url": "https://day.uss.example",
                    "notify_for_operations": True,
                    "notify_for_constraints": False,
                    "old_version": 0,
                },
                tag="sub_put",
            ))
            first = False
        n_part = int(counts[h0:h1].sum())
        d_part = duration_s * (h1 - h0) / 24.0
        times = _spread(n_part, 0.0, d_part)
        for i in range(n_part):
            r = float(rng.uniform())
            lat, lng = pool[int(rng.integers(0, len(pool)))]
            if r < 0.55:
                ph.requests.append(Request(
                    t=float(times[i]), method="POST",
                    path="/dss/v1/operation_references/query",
                    body=_aoi(lat, lng, 0.02, 0.025),
                    tag="poll",
                ))
            elif r < 0.78:
                ph.requests.append(Request(
                    t=float(times[i]), method="GET",
                    path=(
                        "/v1/dss/identification_service_areas"
                        f"?area={_rid_area(lat, lng, 0.02, 0.025)}"
                    ),
                    body=None,
                    tag="rid_poll",
                ))
            elif r < 0.90:
                isa_n += 1
                ph.requests.append(Request(
                    t=float(times[i]), method="PUT",
                    path=(
                        "/v1/dss/identification_service_areas/"
                        f"{_uid(9, isa_n)}"
                    ),
                    body={
                        "extents": {
                            "spatial_volume": {
                                "footprint": {
                                    "vertices": _box(lat, lng, 0.01, 0.012)
                                },
                                "altitude_lo": 0.0,
                                "altitude_hi": 120.0,
                            },
                            "time_start": rel_time(30.0, "rid"),
                            "time_end": rel_time(3600.0, "rid"),
                        },
                        "flights_url": "https://rid.uss.example/flights",
                    },
                    tag="isa_put",
                ))
            else:
                ent += 1
                alt0 = 40.0 + 6.0 * ent
                # ops ride the shared metro sub; in the first phase
                # leave its PUT completion slack before referencing it
                t_op = (
                    max(float(times[i]), 3.0)
                    if name == parts[0][0] else float(times[i])
                )
                ph.requests.append(Request(
                    t=t_op, method="PUT",
                    path=f"/dss/v1/operation_references/{_uid(10, ent)}",
                    body={
                        "extents": [scd_extent(
                            lat, lng, 0.008, 0.008,
                            alt0, alt0 + 4.0, 60.0, 5400.0,
                        )],
                        "uss_base_url": "https://day.uss.example",
                        "subscription_id": _uid(9, 0),
                        "state": "Accepted",
                        "old_version": 0,
                        "key": [],
                    },
                    tag="op_put",
                ))
        phases.append(ph)
    return Scenario(
        "diurnal", phases,
        meta={"requests": n_total, "profile": "two-peak"},
    )


SCENARIOS: Dict[str, object] = {
    "corridors": corridors,
    "mass_event": mass_event,
    "emergency": emergency,
    "diurnal": diurnal,
}


def build_scenario(
    name: str, seed: int, scale: float, duration_s: float
) -> Scenario:
    """Pure scenario constructor (the determinism seam the digest
    check rides): same arguments -> bit-identical stream."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; one of {sorted(SCENARIOS)}"
        )
    return fn(seed, scale, duration_s)

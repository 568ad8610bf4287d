"""Proposer: fitted observations -> a bounded, allowlisted knob delta.

A proposal is a format-versioned PROFILE DELTA: the same shape as an
offline autotune profile (plan/autotune.py), restricted to the same
KNOB_KEYS allowlist, so everything downstream — precedence rules,
operator tooling, the profile JSON an operator pins during an incident
— speaks one dialect.  Three hard bounds apply before anything reaches
the shadow evaluator:

  allowlist  — only HOT_KNOBS (the KNOB_KEYS subset that is actually
               hot-swappable through coalescer configure()) are ever
               proposed.  Boot-geometry knobs (shm slot bytes, graph
               bucket grids, shard results cap) never move at runtime.
  precedence — env > profile > tuner, with "env" meaning the
               OPERATOR's environment: keys the boot profile seeded
               (apply_profile returns them) are the tuner's starting
               point and stay proposable; keys the operator set
               explicitly are never touched.
  step limit — each knob moves at most STEP_LIMITS[knob] relative per
               proposal, so even a deranged fit walks, never jumps;
               the guard window rolls back any single step that hurts.

A deadband suppresses proposals that would move a knob less than
`deadband` relative — the EWMAs already track small drift; the tuner
exists for the shifts winsorization makes slow.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from dss_tpu_torch.plan.autotune import KNOB_KEYS, host_class

__all__ = [
    "HOT_KNOBS",
    "KNOB_TO_CONFIGURE",
    "Proposal",
    "STEP_LIMITS",
    "TUNE_FORMAT",
    "clamp_step",
    "make_probe",
    "make_proposal",
]

TUNE_FORMAT = 1

# max relative move per proposal, per knob.  Every key here MUST be in
# plan/autotune.KNOB_KEYS (asserted below): the tuner's vocabulary is
# a subset of the offline autotuner's, never a superset.
STEP_LIMITS: Dict[str, float] = {
    "DSS_CO_EST_FLOOR_MS": 0.5,
    "DSS_CO_EST_ITEM_MS": 0.5,
    "DSS_CO_EST_CHUNK_MS": 0.5,
    "DSS_CO_EST_RES_FLOOR_MS": 0.5,
    "DSS_CO_EST_RES_LAT_MS": 0.5,
    "DSS_CO_RES_INFLIGHT": 1.0,
    "DSS_CO_RES_RING": 1.0,
}

HOT_KNOBS = tuple(STEP_LIMITS)
assert all(k in KNOB_KEYS for k in HOT_KNOBS)

_INT_KNOBS = frozenset(("DSS_CO_RES_INFLIGHT", "DSS_CO_RES_RING"))

# knob -> QueryCoalescer.configure kwarg (the actuator's translation;
# dss_store.configure_serving fans these to every class coalescer)
KNOB_TO_CONFIGURE: Dict[str, str] = {
    "DSS_CO_EST_FLOOR_MS": "est_floor_ms",
    "DSS_CO_EST_ITEM_MS": "est_item_ms",
    "DSS_CO_EST_CHUNK_MS": "est_chunk_ms",
    "DSS_CO_EST_RES_FLOOR_MS": "est_res_floor_ms",
    "DSS_CO_EST_RES_LAT_MS": "est_res_lat_ms",
    "DSS_CO_RES_INFLIGHT": "res_inflight",
    "DSS_CO_RES_RING": "res_ring",
}


def clamp_step(knob: str, current: float, target: float) -> float:
    """Bound one knob's move to its per-proposal step limit around the
    CURRENT value; integer knobs round and move at least one unit when
    they move at all."""
    cur = float(current)
    lim = STEP_LIMITS[knob]
    lo = cur / (1.0 + lim)
    hi = cur * (1.0 + lim)
    v = min(max(float(target), lo), hi)
    if knob in _INT_KNOBS:
        v = float(int(round(v)))
        if v == int(round(cur)) and target != current:
            v = cur + (1.0 if target > current else -1.0)
        v = max(1.0, v)
    return v


@dataclasses.dataclass(frozen=True)
class Proposal:
    """One knob delta headed for shadow evaluation: proposed values,
    the values they would replace, and why."""

    seq: int
    knobs: Dict[str, float]  # knob -> proposed value (post-clamp)
    based_on: Dict[str, float]  # knob -> value at proposal time
    reason: str
    kind: str = "fit"  # "fit" (histogram-derived) | "probe"
    #                    (exploration) | "injected" (drill)

    def to_profile_delta(self, device="cuda") -> dict:
        """The format-versioned on-the-wire/on-disk form: an autotune
        profile delta an operator can diff, archive, or pin, stamped
        with the host class of `device` (the card unless the caller
        names the CPU)."""
        return {
            "format": TUNE_FORMAT,
            "kind": f"tune-delta/{self.kind}",
            "host_class": host_class(device=device),
            "seq": self.seq,
            "reason": self.reason,
            "knobs": {k: v for k, v in sorted(self.knobs.items())},
            "based_on": {
                k: v for k, v in sorted(self.based_on.items())
            },
        }


def _proposable(knob: str, env, profile_seeded) -> bool:
    """env > profile > tuner: a knob the operator pinned in the
    environment is untouchable; one the boot PROFILE seeded (the
    apply_profile setdefault writes) is the tuner's starting point."""
    if knob not in HOT_KNOBS:
        return False
    if knob in env and knob not in profile_seeded:
        return False
    return True


def make_proposal(fits, route_mix: Dict[str, float],
                  current: Dict[str, float], *, seq: int = 0,
                  deadband: float = 0.25, min_dominance: float = 0.7,
                  chunk: int = 64, env=None,
                  profile_seeded=()) -> Optional[Proposal]:
    """Fits + the window's recorded route mix + current knob values ->
    a Proposal, or None when nothing clears the gates.

    Attribution needs the route mix because a stage histogram is keyed
    by ROUTE CLASS (search/write), not by the planner route that
    served it: the store_ms distribution only speaks about the
    device-class floor when the window's search decisions actually
    went device-class, and about the host chunk cost when they went
    hostward.  The gate is strict purity, not mere dominance: even a
    20% admixture of the other route biases the unlabeled histogram's
    mean and quantiles enough to fit a poisoned slope, and the guard
    window cannot reliably catch the resulting small regression
    (bucket resolution).  A mixed window proposes nothing — ambiguity
    is thin evidence, same policy as thin traffic."""
    env = os.environ if env is None else env
    fit = fits.get(("search", "store_ms"))
    targets: Dict[str, Tuple[float, str]] = {}
    if fit is not None and route_mix:
        dev = (
            route_mix.get("device", 0.0)
            + route_mix.get("resident", 0.0)
            + route_mix.get("mesh", 0.0)
        )
        host = (
            route_mix.get("hostchunk", 0.0)
            + route_mix.get("inline", 0.0)
        )
        res = route_mix.get("resident", 0.0)
        if dev >= min_dominance and host == 0.0:
            targets["DSS_CO_EST_FLOOR_MS"] = (
                fit.floor_ms, "store_ms floor, device-class window"
            )
            if fit.slope_ms > 0.0:
                targets["DSS_CO_EST_ITEM_MS"] = (
                    fit.slope_ms, "store_ms slope, device-class window"
                )
            if res >= min_dominance:
                targets["DSS_CO_EST_RES_FLOOR_MS"] = (
                    fit.floor_ms, "store_ms floor, resident window"
                )
                targets["DSS_CO_EST_RES_LAT_MS"] = (
                    fit.p50_ms, "store_ms p50, resident window"
                )
        elif host >= min_dominance and dev == 0.0:
            # a host-route store_ms sample covers the WHOLE batch —
            # ceil(n/chunk) sequential warmed chunks — so the per-chunk
            # cost is the batch mean over the window's typical chunk
            # count (from the recorded batch-size moments; without
            # moments there is no honest divisor, so propose nothing).
            # The mean, not a quantile: sum/count is exact where the
            # bucketed quantiles carry interpolation error, and chunk
            # cost enters the planner linearly anyway
            if fit.n_mean is not None and fit.n_mean > 0:
                chunks = max(1.0, -(-float(fit.n_mean) // chunk))
                targets["DSS_CO_EST_CHUNK_MS"] = (
                    fit.mean_ms / chunks,
                    "store_ms mean per chunk, host-chunk window",
                )
    knobs: Dict[str, float] = {}
    based: Dict[str, float] = {}
    reasons = []
    for knob, (target, why) in sorted(targets.items()):
        if not _proposable(knob, env, profile_seeded):
            continue
        cur = current.get(knob)
        if cur is None or cur <= 0:
            continue
        if abs(target - cur) / cur < deadband:
            continue  # inside the deadband: the EWMAs can carry it
        knobs[knob] = clamp_step(knob, cur, target)
        based[knob] = float(cur)
        reasons.append(f"{knob}: {why}")
    if not knobs:
        return None
    return Proposal(
        seq=int(seq), knobs=knobs, based_on=based,
        reason="; ".join(reasons),
    )


def make_probe(route_mix: Dict[str, float],
               current: Dict[str, float], *, seq: int = 0,
               min_dominance: float = 0.7, env=None,
               profile_seeded=(),
               blocked=()) -> Optional[Proposal]:
    """The exploration step the EWMAs structurally cannot take.

    A poisoned-HIGH estimate is self-sealing: it makes its route look
    expensive, the planner never takes the route, the route is never
    observed, and nothing ever corrects the estimate — the store serves
    the second-best route forever (the same trap the winsorization
    comment in plan/costs.py names).  The fitter cannot break it either
    (it only fits what was observed).  So when a whole window's
    decisions went one-sided — the OTHER side completely unobserved —
    propose ONE step down on the DEVICE floor knob.  The shadow replay
    then prices whether that step would flip any decisions, and if it
    flips them the guard window measures the route's TRUE cost: a
    genuinely bad route regresses measured p99 and rolls back within
    one guard window (the controller then blocks the knob from
    re-probing for a while), a genuinely good route commits.
    Exploration is safe exactly because the guard bounds it.

    Only the device side is ever probed.  The host-chunk cost cannot
    poison the same way: the host route stays reachable (device-lost
    fallbacks, inline smalls) and its cost is CPU-measurable by the
    offline autotuner, so its estimate keeps getting corrected.  A
    symmetric host-ward probe would also oscillate: a committed
    chunk-down probe gets EWMA-healed by the very observations it
    causes, re-arming the probe forever, and the guard cannot referee
    regressions smaller than its histogram bucket resolution."""
    env = os.environ if env is None else env
    dev = (
        route_mix.get("device", 0.0)
        + route_mix.get("resident", 0.0)
        + route_mix.get("mesh", 0.0)
    )
    host = (
        route_mix.get("hostchunk", 0.0)
        + route_mix.get("inline", 0.0)
    )
    if host >= min_dominance and dev == 0.0:
        knob, side = "DSS_CO_EST_FLOOR_MS", "device"
    else:
        return None
    if knob in blocked or not _proposable(knob, env, profile_seeded):
        return None
    cur = current.get(knob)
    if cur is None or cur <= 0:
        return None
    target = clamp_step(knob, cur, cur / (1.0 + STEP_LIMITS[knob]))
    if target >= cur:
        return None
    return Proposal(
        seq=int(seq), knobs={knob: target},
        based_on={knob: float(cur)},
        reason=(
            f"{knob}: probe — {side} class unobserved this window, "
            f"walking its floor down one step (guard-bounded "
            f"exploration)"
        ),
        kind="probe",
    )

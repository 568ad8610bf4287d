"""Shadow evaluator: replay recorded decisions under proposed knobs.

The planner's `decide(shape, state, headroom)` is pure over a frozen
ModelState — which means the last N REAL routing decisions, recorded
as (shape, state, headroom, flags, plan) tuples, are a perfect what-if
simulator: substitute the proposed cost scalars into each recorded
state, re-run `decide`, and read off exactly which decisions would
flip and what the predicted latency distribution becomes.  This is the
8000-decision equivalence machinery from tests/test_planner.py turned
from a regression harness into a control-loop stage: nothing is
guessed about the planner, because the planner itself is asked.

The DecisionRecorder follows the trace flight recorder's discipline
(obs/trace.py): a bounded ring, an allocation counter the
zero-cost-when-disabled contract is asserted against, and a
module-global hook gate (plan.set_decision_hook) so the planner's hot
path pays one global read + None test when tuning is off — DSS_TUNE=0
never installs a recorder, so the counter provably stays 0.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from dss_tpu_torch.plan import planner as _planner

__all__ = [
    "DecisionRecorder",
    "KNOB_TO_STATE",
    "ShadowReport",
    "apply_knobs_to_state",
    "shadow_eval",
]

# knob -> the ModelState field it would reseed.  Knobs with no state
# field (resident ring/inflight geometry) are shadow-NEUTRAL: the
# replay cannot price them, so they pass through to the guard window,
# which can.
KNOB_TO_STATE: Dict[str, str] = {
    "DSS_CO_EST_FLOOR_MS": "est_floor_ms",
    "DSS_CO_EST_ITEM_MS": "est_item_ms",
    "DSS_CO_EST_CHUNK_MS": "est_chunk_ms",
    "DSS_CO_EST_RES_FLOOR_MS": "est_res_floor_ms",
    "DSS_CO_EST_RES_LAT_MS": "est_res_lat_ms",
}


def apply_knobs_to_state(state, knobs: Dict[str, float]):
    """A recorded ModelState under the proposed knobs — the ModelState
    seeding half of the what-if: pressure/availability fields keep
    their recorded values (the replay asks 'same moment, different
    estimates'), only the proposed cost scalars move."""
    fields = {
        KNOB_TO_STATE[k]: float(v)
        for k, v in knobs.items()
        if k in KNOB_TO_STATE
    }
    if not fields:
        return state
    return dataclasses.replace(state, **fields)


# ring entry: (shape, state, headroom_ms, allow_resident, allow_mesh,
#              route, predicted_ms) — everything `decide` consumed plus
# what it answered, so identity is checkable and the replay exact
_Entry = Tuple[object, object, Optional[float], bool, bool, str, float]


class DecisionRecorder:
    """Bounded ring of live planner decisions, fed through
    plan.set_decision_hook by the tune controller.  Never installed
    when DSS_TUNE=0 — the zero-alloc contract is structural, not a
    branch in here."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(8, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.allocs = 0  # ring entries created — THE zero-alloc-
        #                  when-disabled assertion target
        self.recorded = 0

    def record(self, shape, state, headroom_ms, allow_resident,
               allow_mesh, plan) -> None:
        """The set_decision_hook callback: one tuple append under one
        lock — cheap enough for the pack thread's hot path."""
        with self._lock:
            self._ring.append((
                shape, state, headroom_ms, bool(allow_resident),
                bool(allow_mesh), plan.route, plan.predicted_ms,
            ))
            self.allocs += 1
            self.recorded += 1

    def entries(self) -> List[_Entry]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def route_mix(self) -> Dict[str, float]:
        """Fraction of recorded decisions per chosen route."""
        entries = self.entries()
        if not entries:
            return {}
        mix: Dict[str, float] = {}
        for e in entries:
            mix[e[5]] = mix.get(e[5], 0.0) + 1.0
        n = float(len(entries))
        return {r: c / n for r, c in mix.items()}

    def batch_moments(self) -> Dict[str, Tuple[float, float]]:
        """{"store_ms": (n_mean, n_min)} — the batch-size moments the
        observer's fitter pairs with the store-stage histogram (the
        decisions recorded here sized exactly the batches that stage
        timed)."""
        ns = [float(e[0].n) for e in self.entries()]
        if not ns:
            return {}
        return {"store_ms": (sum(ns) / len(ns), min(ns))}


@dataclasses.dataclass(frozen=True)
class ShadowReport:
    """What the replay predicts a proposal would do — and whether the
    recorded trace still replays identically under UNCHANGED knobs
    (identity=False means the recording is unsound and the proposal
    must not be trusted either way)."""

    decisions: int
    identity: bool  # recorded routes reproduce under current knobs
    changed: int  # decisions that would flip under the proposal
    route_mix_before: Dict[str, float]
    route_mix_after: Dict[str, float]
    p99_before_ms: float
    p99_after_ms: float
    accept: bool
    reason: str


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def shadow_eval(entries: List[_Entry], knobs: Dict[str, float], *,
                p99_tol: float = 0.10,
                min_decisions: int = 32) -> ShadowReport:
    """Score a proposal against the recorded trace: predicted p99 of
    the chosen routes, before vs after, plus the route-mix shift.
    Accept iff the replay is sound (identity holds), the trace is
    thick enough to mean anything, and the predicted p99 does not
    regress past p99_tol."""
    n = len(entries)
    if n < min_decisions:
        return ShadowReport(
            decisions=n, identity=True, changed=0,
            route_mix_before={}, route_mix_after={},
            p99_before_ms=0.0, p99_after_ms=0.0, accept=False,
            reason=f"trace too thin ({n} < {min_decisions} decisions)",
        )
    identity = True
    changed = 0
    before: List[float] = []
    after: List[float] = []
    mix0: Dict[str, float] = {}
    mix1: Dict[str, float] = {}
    for shape, state, headroom, a_res, a_mesh, route, pred in entries:
        p0 = _planner.decide(
            shape, state, headroom,
            allow_resident=a_res, allow_mesh=a_mesh,
        )
        if p0.route != route:
            identity = False
        p1 = _planner.decide(
            shape, apply_knobs_to_state(state, knobs), headroom,
            allow_resident=a_res, allow_mesh=a_mesh,
        )
        if p1.route != p0.route:
            changed += 1
        before.append(p0.predicted_ms)
        after.append(p1.predicted_ms)
        mix0[p0.route] = mix0.get(p0.route, 0.0) + 1.0
        mix1[p1.route] = mix1.get(p1.route, 0.0) + 1.0
    fn = float(n)
    mix0 = {r: c / fn for r, c in mix0.items()}
    mix1 = {r: c / fn for r, c in mix1.items()}
    p99_0 = _p99(before)
    p99_1 = _p99(after)
    if not identity:
        accept, reason = False, (
            "recorded trace does not replay identically under current "
            "knobs — recording unsound, refusing to predict"
        )
    elif p99_1 > p99_0 * (1.0 + p99_tol):
        accept, reason = False, (
            f"predicted p99 regresses {p99_0:.3f} -> {p99_1:.3f} ms "
            f"(> {p99_tol:.0%} tolerance)"
        )
    else:
        accept, reason = True, (
            f"predicted p99 {p99_0:.3f} -> {p99_1:.3f} ms, "
            f"{changed}/{n} decisions shift"
        )
    return ShadowReport(
        decisions=n, identity=identity, changed=changed,
        route_mix_before=mix0, route_mix_after=mix1,
        p99_before_ms=p99_0, p99_after_ms=p99_1,
        accept=accept, reason=reason,
    )

"""One planner over the serving routes.

A copy of the reference's `dss_tpu/plan/planner.py`.  A routing
decision is an explicit **Plan** produced by one pure function,
`decide(shape, state, headroom_ms)`:

  shape       — what is being routed (BatchShape: size, staleness,
                owner scoping, inline-ness),
  state       — an immutable ModelState snapshot (cost estimates +
                pipeline pressure + route availability),
  headroom_ms — the tightest queued deadline's remaining budget
                (None = bulk / all-stale: a throughput decision).

Because the decision is pure, it unit-tests with no live coalescer,
no device, and no threads, and it replays deterministically against
recorded model states.  tests/test_torch_planner.py pins it
decision-identical to the reference's planner.

Routes (ROUTES):

  cache     — version-fenced read-cache hit (dar/readcache.py): served
              before the coalescer; the store's hit path notes it so
              the plan mix in /metrics shows the whole picture.
  inline    — lone-caller exact host scan on the caller's thread (the
              idle-pipeline shortcut in QueryCoalescer.query).
  hostchunk — forced chunked exact host scans at the warmed bucket
              (FastTable.query_host_chunked), the deadline router's
              pressure escape.
  device    — one cold fused-kernel dispatch (submit/collect round
              trip).
  resident  — the resident serving loop's persistent device stream
              (ops/resident.py: captured CUDA graphs, static buffers, pipelined
              feeder).
  mesh      — the sharded multi-chip replica (parallel/replica.py),
              bounded-stale by construction; carries the shard
              boundary generation so a plan records WHICH placement
              it was made against.
  rqmatch   — the reverse-query match route (push/match.py): a WRITE
              is a query with the roles swapped, so a batch of
              write-side match volumes rides the same fused geometry
              kernel against the subscription classes' DAR.  Its own
              cost keys (est_rq_*) because the subscription table is
              a different resident set than the entity tiers; when
              the device class is inadmissible the host oracle
              (hostchunk) serves the match bit-identically.

Adding a route means adding a candidate in `enumerate_candidates`, an
arm in the `decide` policy, and a throughput arm in `route_qps` — all
in this file.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

from dss_tpu_torch.plan import costs as _c

__all__ = [
    "HEADROOM_SAFETY",
    "ROUTES",
    "BatchShape",
    "ModelState",
    "Plan",
    "Planner",
    "decide",
    "plan_drain_cap",
    "state_of",
]

# fraction of a batch's tightest headroom the planner budgets for the
# serving route itself (the rest covers decode + caller wake).  Shared
# by the route choice AND plan_drain_cap so the drain sizing and the
# route decision can never disagree about the budget.
HEADROOM_SAFETY = 0.5

ROUTES = (
    "cache", "inline", "hostchunk", "device", "resident", "mesh",
    "rqmatch",
)


@dataclasses.dataclass(frozen=True)
class ModelState:
    """Everything a routing decision reads, frozen at decision time:
    the cost model's live estimates, the pipeline's pressure counters,
    and which routes are attached/admissible right now.  A decision is
    a pure function of (BatchShape, ModelState, headroom) — recording
    ModelStates is what makes planner decisions replayable."""

    est_floor_ms: float
    est_item_ms: float
    est_chunk_ms: float
    est_res_floor_ms: float
    est_res_lat_ms: float
    # reverse-query (rqmatch) keys — defaulted to 0 so model states
    # recorded before the route existed still replay; state_of always
    # passes the live estimates
    est_rq_floor_ms: float = 0.0
    est_rq_item_ms: float = 0.0
    chunk: int = 64
    inflight_device: int = 0
    inflight_host_chunks: int = 0
    inflight_resident: int = 0
    resident_ready: bool = False  # loop attached AND ring has space
    mesh_ready: bool = False  # mesh delegate attached
    mesh_min: int = 64
    mesh_max: int = 256
    host_only: bool = False  # event-loop caller: no forced chunk scans
    boundary_gen: int = 0  # shard placement generation
    # degradation ladder (chaos/ladder.py, store slice): DEVICE_LOST makes
    # every device-class route (device / resident / mesh) inadmissible
    # while hostchunk + inline keep serving — the same
    # route-substitution move the host_only path already makes, now
    # driven by store health instead of caller context
    device_ok: bool = True

    # -- predictions (the shared formulas from plan.costs) ------------

    def predict_device_ms(self, n: int) -> float:
        return _c.predict_device_ms(
            self.est_floor_ms, self.est_item_ms, n, self.inflight_device
        )

    def predict_resident_ms(self, n: int) -> float:
        return _c.predict_resident_ms(
            self.est_res_floor_ms, self.est_item_ms, n,
            self.inflight_resident,
        )

    def predict_resident_latency_ms(self, n: int) -> float:
        return _c.predict_resident_latency_ms(
            self.est_res_lat_ms, self.est_res_floor_ms,
            self.est_item_ms, n, self.inflight_resident,
        )

    def predict_host_ms(self, n: int) -> float:
        return _c.predict_host_ms(
            self.est_chunk_ms, self.est_floor_ms, self.chunk, n,
            self.inflight_host_chunks, self.inflight_device,
        )

    def predict_rqmatch_ms(self, n: int) -> float:
        # pre-route recorded states carry 0.0 rq keys: fall back to
        # the cold-device keys they DID record (the rq seeds anyway)
        floor = self.est_rq_floor_ms or self.est_floor_ms
        item = self.est_rq_item_ms or self.est_item_ms
        return _c.predict_rqmatch_ms(floor, item, n, self.inflight_device)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelState":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class BatchShape:
    """What is being routed.  `inline` marks the lone-caller shortcut
    (and the mesh fallback), which executes synchronously on the
    caller's thread and therefore can never ride the resident stream
    (a batch cleared only because the stream's latency fits would
    otherwise run as a COLD dispatch and blow the deadline the
    clearance assumed)."""

    n: int
    all_stale: bool = False
    owner_scoped: bool = False
    inline: bool = False
    # write-side reverse-query match batch (push/match.py): routes to
    # the rqmatch candidate when the device class is admissible, else
    # the bit-identical host oracle — never cache/mesh/resident (a
    # match must be exact against the CURRENT subscription set)
    rqmatch: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BatchShape":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One routing decision, recorded: the chosen route, its predicted
    cost, every candidate considered (route -> predicted ms; None =
    not admissible for this shape/state), the deadline class the
    decision was made under, the freshness class the answer will
    carry, and the shard boundary generation it was planned against."""

    route: str
    predicted_ms: float
    candidates: Tuple[Tuple[str, Optional[float]], ...]
    deadline_class: str  # "fresh" (headroom-bounded) | "bulk"
    freshness_class: str  # "fresh" | "bounded_stale" | "cached"
    boundary_gen: int
    n: int
    headroom_ms: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "route": self.route,
            "predicted_ms": self.predicted_ms,
            "candidates": {r: c for r, c in self.candidates},
            "deadline_class": self.deadline_class,
            "freshness_class": self.freshness_class,
            "boundary_gen": self.boundary_gen,
            "n": self.n,
            "headroom_ms": self.headroom_ms,
        }


def mesh_admissible(shape: BatchShape, state: ModelState) -> bool:
    """The mesh-offload eligibility: bounded-staleness
    searches only (conflict prechecks never set allow_stale), no owner
    filters, and a size window above which ONE local fused dispatch
    beats serialized mesh chunk round trips."""
    return (
        state.mesh_ready
        and state.device_ok  # the mesh IS local device compute
        and shape.all_stale
        and not shape.owner_scoped
        and state.mesh_min <= shape.n <= state.mesh_max
    )


def enumerate_candidates(
    shape: BatchShape,
    state: ModelState,
    headroom_ms: Optional[float],
    *,
    allow_resident: bool = True,
) -> Dict[str, Optional[float]]:
    """Predicted cost per route for this (shape, state); None marks a
    route inadmissible here.  THE one place a new route registers its
    cost — `decide` and `plan_drain_cap` consume this map."""
    n = shape.n
    cand: Dict[str, Optional[float]] = {r: None for r in ROUTES}
    if shape.rqmatch:
        # write-side match batch: exactness pins the candidate set to
        # the fused kernel over the live subscription DAR or the
        # bit-identical host oracle — bounded-stale routes (cache,
        # mesh, resident) could miss a subscription upserted since
        # their snapshot, and a missed notification is a correctness
        # bug, not a staleness note
        if state.device_ok:
            cand["rqmatch"] = state.predict_rqmatch_ms(n)
        cand["hostchunk"] = state.predict_host_ms(n)
        return cand
    # cache: a hit never reaches the planner (the store answers it in
    # microseconds before admission) — enumerated as the ~free
    # candidate so the plan mix is honest about what a miss costs
    cand["cache"] = 0.0 if shape.n == 0 else None
    if mesh_admissible(shape, state):
        # a mesh chunk round trip costs ~one cold dispatch; the mesh
        # serves pre-rebalanced shard rows, so the prediction is the
        # device formula without the LOCAL queue pressure
        cand["mesh"] = _c.predict_device_ms(
            state.est_floor_ms, state.est_item_ms, n, 0
        )
    if shape.inline:
        # the lone-caller exact host path (auto-routed inside the
        # table: small batches never touch the device)
        cand["inline"] = _c.predict_host_ms(
            state.est_chunk_ms, state.est_floor_ms, state.chunk, n, 0, 0
        )
    if not (shape.inline and state.host_only):
        cand["hostchunk"] = state.predict_host_ms(n)
    if state.device_ok:
        cand["device"] = state.predict_device_ms(n)
    if (
        allow_resident and state.resident_ready and state.device_ok
        and not shape.inline
    ):
        cand["resident"] = (
            state.predict_resident_ms(n)
            if headroom_ms is None
            else state.predict_resident_latency_ms(n)
        )
    return cand


def decide(
    shape: BatchShape,
    state: ModelState,
    headroom_ms: Optional[float],
    *,
    allow_resident: bool = True,
    allow_mesh: bool = True,
) -> Plan:
    """The routing policy — a pure function, decision-identical to the
    pre-refactor router (pinned by tests/test_planner.py).

    Mesh-admissible batches go to the mesh (freshness re-checked at
    execution; the fallback re-plans inline, exactly as before).

    Bulk / all-stale drains (headroom_ms None) are throughput
    decisions: ride the resident stream whenever it is attached, has
    ring space, and its marginal (gap) cost beats a cold dispatch —
    else the cold fused kernel.

    Deadline-carrying drains are latency decisions: the device-class
    candidate is whichever of resident/cold predicts the lower
    COMPLETION LATENCY (for the stream that includes the full round
    trip — pipelining amortizes dispatch cost, never the wire).  If
    that latency blows the headroom budget (HEADROOM_SAFETY of it —
    the same budget plan_drain_cap sizes against) AND the host chunks
    are predicted to finish sooner, the drain is served as chunked
    exact host scans."""
    n = shape.n
    cand = enumerate_candidates(
        shape, state, headroom_ms, allow_resident=allow_resident
    )
    dl_class = "bulk" if headroom_ms is None else "fresh"

    def mk(route: str, pred: float, fresh: str = "fresh") -> Plan:
        return Plan(
            route=route,
            predicted_ms=float(pred),
            candidates=tuple(sorted(cand.items())),
            deadline_class=dl_class,
            freshness_class=fresh,
            boundary_gen=state.boundary_gen,
            n=n,
            headroom_ms=headroom_ms,
        )

    if shape.rqmatch:
        # reverse-query match: device kernel when admissible — under
        # DEVICE_LOST (or a headroom the dispatch floor cannot fit)
        # the host oracle serves the same answer bit-identically
        rq = cand["rqmatch"]
        hc = cand["hostchunk"]
        if rq is None:
            return mk("hostchunk", hc)
        if (
            headroom_ms is not None
            and rq > HEADROOM_SAFETY * headroom_ms
            and hc is not None
            and hc < rq
        ):
            return mk("hostchunk", hc)
        return mk("rqmatch", rq)
    if allow_mesh and cand["mesh"] is not None:
        return mk("mesh", cand["mesh"], fresh="bounded_stale")
    pred_dev = cand["device"]
    res = cand["resident"]
    if pred_dev is None:
        # DEVICE_LOST (degradation ladder): the whole device class is
        # inadmissible — serve from the host, exactly as the deadline
        # router already does under pressure.  Lone callers keep the
        # inline exact path; everything else rides hostchunk.
        hc = cand["hostchunk"]
        if shape.inline and (hc is None or n < state.chunk):
            return mk("inline", cand["inline"])
        return mk(
            "hostchunk",
            hc if hc is not None else state.predict_host_ms(n),
        )
    if headroom_ms is None:
        if res is not None and res < pred_dev:
            return mk("resident", res)
        return mk(
            "inline" if shape.inline and n < state.chunk else "device",
            pred_dev,
        )
    dc_lat, kind = pred_dev, "device"
    if res is not None and res <= pred_dev:
        # tie-break toward the stream: at the seed state the latency
        # keys are EQUAL (both one round trip), and a strict compare
        # would starve the resident route of the very observations
        # that lower its estimate — equal latency, strictly cheaper
        # dispatch
        dc_lat, kind = res, "resident"
    if dc_lat <= HEADROOM_SAFETY * headroom_ms:
        if shape.inline and kind == "device" and n < state.chunk:
            return mk("inline", dc_lat)
        return mk(kind, dc_lat)
    hc = cand["hostchunk"]
    if hc is not None and hc < dc_lat:
        return mk("hostchunk", hc)
    if shape.inline and kind == "device" and n < state.chunk:
        return mk("inline", dc_lat)
    return mk(kind, dc_lat)


def plan_drain_cap(
    cur: int, headroom_ms: Optional[float], state: ModelState
) -> int:
    """Deadline-aware drain bound: never drain more than the predicted
    route cost fits into the minimum queued headroom.  With rich
    headroom (the device-class route — resident stream when available,
    else cold dispatch — fits inside the budget) the AIMD size stands;
    under pressure — and only when the host route is the one `decide`
    will actually choose (same HEADROOM_SAFETY budget, so the two
    decisions cannot disagree) — the drain shrinks to the host chunks
    that fit, never below one warmed chunk (forward progress — a zero
    cap would starve the queue entirely)."""
    if headroom_ms is None:
        return cur
    budget_ms = HEADROOM_SAFETY * max(0.0, headroom_ms)
    if not state.device_ok:
        # DEVICE_LOST: the device class can never absorb the drain —
        # size against the host chunks below, unconditionally
        pred_dev = float("inf")
    else:
        pred_dev = state.predict_device_ms(cur)
        if state.resident_ready:
            # latency view, matching the route choice: a drain sized
            # against the stream's throughput gap would admit batches
            # the stream cannot deliver inside their deadlines
            pred_dev = min(
                pred_dev, state.predict_resident_latency_ms(cur)
            )
    if pred_dev <= budget_ms:
        return cur
    if state.predict_host_ms(cur) >= pred_dev:
        # the device is the lesser evil even over budget: shrinking
        # the drain would only pay MORE dispatch floors
        return cur
    fit = (
        int(
            (budget_ms - state.inflight_device * state.est_floor_ms)
            / max(state.est_chunk_ms, 1e-3)
        )
        - max(0, state.inflight_host_chunks)
    )
    return max(state.chunk, min(cur, state.chunk * max(1, fit)))


def state_of(cost, **pressure) -> ModelState:
    """Freeze a CostModel's live estimates (+ the caller's pressure /
    availability fields) into a ModelState — the ONE construction
    point, so a field added to the model can never silently run on a
    dataclass default in one consumer while another reads the live
    estimate."""
    return ModelState(
        est_floor_ms=cost.est_floor_ms,
        est_item_ms=cost.est_item_ms,
        est_chunk_ms=cost.est_chunk_ms,
        est_res_floor_ms=cost.est_res_floor_ms,
        est_res_lat_ms=cost.est_res_lat_ms,
        est_rq_floor_ms=cost.est_rq_floor_ms,
        est_rq_item_ms=cost.est_rq_item_ms,
        chunk=cost.chunk,
        **pressure,
    )


# -- decision-trace recorder hook (the tuner's shadow replay) -----------------
#
# One process-wide hook, same discipline as the trace flight recorder's
# _ENABLED gate: when no recorder is installed the hot path pays ONE
# module-global read and a None test — no allocation, no lock, no call.
# The tune controller installs its DecisionRecorder here so EVERY
# planner in the process (five class coalescers + the push match
# stages) records into one bounded ring the shadow evaluator replays.
# Module-level on purpose: tune imports plan, so plan cannot import
# tune — the seam lives on the side that everything else already
# depends on.

_DECISION_HOOK = None


def set_decision_hook(hook) -> None:
    """Install (or clear, with None) the process-wide decision
    recorder.  `hook(shape, state, headroom_ms, allow_resident,
    allow_mesh, plan)` is called for every RECORDED plan — the allow_*
    flags ride along so a replay presents `decide` with exactly the
    arguments the live call used (decision identity, not just state
    identity)."""
    global _DECISION_HOOK
    _DECISION_HOOK = hook


class Planner:
    """Owns the cost models and produces Plans.

    The live mutable half (the CostModel EWMAs, fed by observe_*)
    stays here; every DECISION goes through the pure `decide` over a
    frozen ModelState, so what the planner will do is always
    reproducible from a recorded state.  Per-route plan counters feed
    the co_plan_* gauges in /metrics."""

    def __init__(self, **cost_kwargs):
        self.cost = _c.CostModel(**cost_kwargs)
        self._lock = threading.Lock()
        self._plans: Dict[str, int] = {r: 0 for r in ROUTES}
        self._fallbacks = 0  # plans demoted at execution (ring full)

    # -- state capture ----------------------------------------------------

    def capture(
        self,
        *,
        inflight_device: int = 0,
        inflight_host_chunks: int = 0,
        inflight_resident: int = 0,
        resident_ready: bool = False,
        mesh_ready: bool = False,
        mesh_min: int = 64,
        mesh_max: int = 256,
        host_only: bool = False,
        boundary_gen: int = 0,
        device_ok: bool = True,
    ) -> ModelState:
        return state_of(
            self.cost,
            inflight_device=inflight_device,
            inflight_host_chunks=inflight_host_chunks,
            inflight_resident=inflight_resident,
            resident_ready=resident_ready,
            mesh_ready=mesh_ready,
            mesh_min=mesh_min,
            mesh_max=mesh_max,
            host_only=host_only,
            boundary_gen=boundary_gen,
            device_ok=device_ok,
        )

    # -- planning ---------------------------------------------------------

    def plan(
        self,
        shape: BatchShape,
        state: ModelState,
        headroom_ms: Optional[float],
        *,
        allow_resident: bool = True,
        allow_mesh: bool = True,
        record: bool = True,
    ) -> Plan:
        p = decide(
            shape, state, headroom_ms,
            allow_resident=allow_resident, allow_mesh=allow_mesh,
        )
        if record:
            self.note(p.route)
            hook = _DECISION_HOOK
            if hook is not None:
                hook(
                    shape, state, headroom_ms, allow_resident,
                    allow_mesh, p,
                )
        return p

    def note(self, route: str) -> None:
        """Count a chosen plan.  NOTE: cache-hit plans are NOT noted
        here — the coalescer's stats() folds the read-cache view's
        hit counter into co_plan_cache (a hit is served before the
        coalescer, so the cache already counts it); noting them here
        too would double-count the route mix."""
        with self._lock:
            if route in self._plans:
                self._plans[route] += 1

    def note_fallback(self) -> None:
        """A plan demoted at execution time (resident ring filled
        between decision and enqueue): the batch re-routes cold."""
        with self._lock:
            self._fallbacks += 1

    def drain_cap(
        self, cur: int, headroom_ms: Optional[float], state: ModelState
    ) -> int:
        return plan_drain_cap(cur, headroom_ms, state)

    # -- throughput (Retry-After) -----------------------------------------

    def route_qps(self, route: str, n: int, state: ModelState) -> float:
        """Steady-state drain throughput of `route` at batch size n
        (queue pressure excluded: Retry-After quotes how fast the
        backlog drains once it is this batch's turn)."""
        n = max(1, int(n))
        if route in ("hostchunk", "inline"):
            return state.chunk / max(state.est_chunk_ms, 1e-3) * 1000.0
        if route == "resident":
            return n / max(
                _c.predict_resident_ms(
                    state.est_res_floor_ms, state.est_item_ms, n, 0
                ),
                1e-3,
            ) * 1000.0
        if route == "rqmatch":
            return n / max(state.predict_rqmatch_ms(n), 1e-3) * 1000.0
        # device, mesh (one mesh chunk trip ~ one cold dispatch), and
        # anything unknown: the cold-dispatch throughput
        return n / max(
            _c.predict_device_ms(
                state.est_floor_ms, state.est_item_ms, n, 0
            ),
            1e-3,
        ) * 1000.0

    def backlog_qps(
        self,
        n: int,
        state: ModelState,
        headroom_ms: Optional[float],
        *,
        all_stale: bool = False,
    ) -> float:
        """Throughput of the route the planner would ACTUALLY choose
        for the queued shape class — the honest Retry-After
        denominator.  The old estimate quoted min(host, device)
        unconditionally, telling overloaded clients to wait for a
        route the router would never pick for their traffic (e.g.
        host-route throughput during a fresh-SLO overload that is
        draining hostward anyway, or the device floor during an
        all-stale bulk overload the resident stream is absorbing)."""
        shape = BatchShape(n=max(1, int(n)), all_stale=all_stale)
        p = self.plan(
            shape, state, headroom_ms, allow_mesh=False, record=False
        )
        return self.route_qps(p.route, shape.n, state)

    # -- observation passthrough (the mutable half) -----------------------

    def observe_device(self, n: int, total_ms: float) -> None:
        self.cost.observe_device(n, total_ms)

    def observe_host(self, n: int, total_ms: float) -> None:
        self.cost.observe_host(n, total_ms)

    def observe_resident(self, n: int, gap_ms: float,
                         lat_ms: Optional[float] = None) -> None:
        self.cost.observe_resident(n, gap_ms, lat_ms)

    def observe_rqmatch(self, n: int, total_ms: float) -> None:
        self.cost.observe_rqmatch(n, total_ms)

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                f"co_plan_{r}": self._plans[r] for r in ROUTES
            }
            out["co_plan_fallbacks"] = self._fallbacks
            out["co_plan_total"] = sum(self._plans.values())
        return out


# -- federation read admissibility (region/federation.py) --------------------
#
# The cross-region analog of decide(): pure, replayable, and owning
# the ONE policy question a federated read poses — live peer, declared-
# lag mirror, or honest shed.  The FederationRouter feeds it breaker +
# mirror state; keeping the decision here keeps route admissibility a
# planner concern (same discipline as device_ok gating the device
# class under DEVICE_LOST).

FED_REMOTE = "remote"
FED_STALE = "stale"
FED_SHED = "shed"


@dataclasses.dataclass(frozen=True)
class FederationReadPlan:
    """The chosen cross-region route for one remote slice.
    retry_after_s is only meaningful for FED_SHED — the honest
    Retry-After (breaker cooldown, floored so clients cannot
    busy-poll a flapping link)."""

    route: str
    retry_after_s: float = 0.0


def decide_federation_read(
    *,
    peer_allowed: bool,
    cooldown_s: float,
    mirror_synced: bool,
    mirror_lag_s: float,
    lag_bound_s: float,
    allow_stale: bool = True,
) -> FederationReadPlan:
    """Pure federation-read route choice.

      peer breaker allows traffic      -> FED_REMOTE (live bounded-
                                          stale follower read at the
                                          remote region)
      else, bounded-stale query AND
      the local mirror's measured lag
      is inside the declared bound     -> FED_STALE (declared-lag
                                          mirror read; the response
                                          header carries the lag)
      else                             -> FED_SHED (503 + honest
                                          Retry-After; never silently
                                          served staler than declared)
    """
    if peer_allowed:
        return FederationReadPlan(FED_REMOTE)
    if allow_stale and mirror_synced and mirror_lag_s <= lag_bound_s:
        return FederationReadPlan(FED_STALE)
    return FederationReadPlan(
        FED_SHED, retry_after_s=max(0.5, float(cooldown_s))
    )

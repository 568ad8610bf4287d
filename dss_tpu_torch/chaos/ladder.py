"""The graceful-degradation ladder: one explicit store-level mode.

Every fallback the stack can take used to be local knowledge — the
planner knew about host_only, the mesh replica knew about degraded
mode, the region coordinator knew about dirty state.  The ladder makes
the store's health ONE explicit state machine:

    HEALTHY (0) -> PUSH_DEGRADED (1) -> DEVICE_LOST (2)
                -> MESH_DEGRADED (3) -> FEDERATION_DEGRADED (4)
                -> REGION_LOG_DOWN (5)

driven by condition signals (enter/exit), where the MODE is the worst
active condition.  Effects, wired in dar/dss_store.py + the planner:

  PUSH_DEGRADED     the push delivery queue is saturated or every
                    delivery breaker is open (push/): writes
                    and reads serve normally and matched notifications
                    are still durably enqueued — only webhook fan-out
                    is behind.  The mildest rung on purpose: losing
                    push delivery never degrades the core serving
                    contract, it degrades the no-polling add-on.
  DEVICE_LOST       the planner's device / resident / mesh routes are
                    inadmissible (ModelState.device_ok=False);
                    hostchunk + inline keep serving — the same
                    reasoning 1403.0802 applies to heterogeneous
                    geospatial backends: lose an executor, remap the
                    work to the next-cheapest one.  The coalescer
                    absorbs in-flight device failures (host re-run,
                    no caller 5xx) and reports the condition.
  MESH_DEGRADED     the multihost mesh lost a peer (the existing
                    MultihostRuntime watchdog flags it); the mesh
                    route is already inadmissible via mesh_fresh —
                    the ladder makes the mode visible stack-wide.
  FEDERATION_DEGRADED  a remote federated region is unreachable (its
                    peer breaker opened — region/federation.py).
                    Local-airspace serving is untouched; cross-region
                    reads degrade to declared-lag stale answers from
                    the local follower mirror (or 503 with the breaker
                    cooldown as Retry-After once past the bound), and
                    writes to remote-owned cells 503 honestly.
                    Recovery re-syncs the follower tail BEFORE the
                    condition clears, so remote routes re-admit with a
                    warm mirror behind them.
  REGION_LOG_DOWN   the region log is unreachable (client breakers
                    open): writes answer 503 with an honest
                    Retry-After (breaker cooldown) while reads keep
                    serving fenced cache/snapshot answers; surfaced
                    in X-DSS-Freshness and /status.

Recovery walks the ladder back DOWN: exit(condition) runs the
registered on_recover callbacks (re-capture the graph grid, re-prime the
cache) BEFORE clearing the condition, so a route is only re-admitted
once its warm state exists again.  Dwell time per condition is
accounted for bench.py --leg chaos's degraded-mode dwell report.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "HEALTHY",
    "PUSH_DEGRADED",
    "DEVICE_LOST",
    "MESH_DEGRADED",
    "FEDERATION_DEGRADED",
    "REGION_LOG_DOWN",
    "CONDITIONS",
    "MODE_NAMES",
    "DegradationLadder",
]

log = logging.getLogger("dss.chaos")

HEALTHY = 0
PUSH_DEGRADED = 1
DEVICE_LOST = 2
MESH_DEGRADED = 3
FEDERATION_DEGRADED = 4
REGION_LOG_DOWN = 5

# condition name -> ladder severity (mode = max of active conditions).
# Ordered by how much of the serving contract is lost: push fan-out
# lag costs nothing but notification latency, a dead region log costs
# write availability.  Compare modes via the symbolic constants — the
# numbering shifts when a rung is inserted.
CONDITIONS: Dict[str, int] = {
    "push_degraded": PUSH_DEGRADED,
    "device_lost": DEVICE_LOST,
    "mesh_degraded": MESH_DEGRADED,
    "federation_degraded": FEDERATION_DEGRADED,
    "region_log_down": REGION_LOG_DOWN,
}

MODE_NAMES: Dict[int, str] = {
    HEALTHY: "healthy",
    PUSH_DEGRADED: "push_degraded",
    DEVICE_LOST: "device_lost",
    MESH_DEGRADED: "mesh_degraded",
    FEDERATION_DEGRADED: "federation_degraded",
    REGION_LOG_DOWN: "region_log_down",
}


class DegradationLadder:
    """Thread-safe condition set + severity view + recovery hooks.

    enter() is idempotent (re-entering an active condition only
    refreshes its reason); exit() runs the condition's on_recover
    callbacks with the lock RELEASED (re-warm does device work), then
    clears the condition — so the route a recovery re-admits never
    races its own warm-up."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        # condition -> (entered_at_monotonic, reason)
        self._active: Dict[str, Tuple[float, str]] = {}
        self._recover_cbs: Dict[str, List[Callable[[], None]]] = {}
        self._enter_cbs: Dict[str, List[Callable[[str], None]]] = {}
        self.transitions = 0  # enter+exit edges (the alert's rate basis)
        # per-condition cumulative dwell seconds (closed episodes)
        self._dwell_s: Dict[str, float] = {c: 0.0 for c in CONDITIONS}

    # -- signals -----------------------------------------------------------

    def enter(self, condition: str, reason: str = "") -> bool:
        """Activate a condition.  Returns True on the ENTER edge
        (False when it was already active)."""
        if condition not in CONDITIONS:
            raise ValueError(f"unknown ladder condition {condition!r}")
        with self._lock:
            fresh = condition not in self._active
            if fresh:
                self._active[condition] = (self._clock(), reason)
                self.transitions += 1
            else:
                self._active[condition] = (
                    self._active[condition][0], reason or
                    self._active[condition][1],
                )
            cbs = list(self._enter_cbs.get(condition, ())) if fresh else ()
        if fresh:
            log.error(
                "degradation ladder: ENTER %s (%s) -> mode %s",
                condition, reason or "unspecified", self.mode_name(),
            )
            for fn in cbs:
                try:
                    fn(reason)
                except Exception:  # noqa: BLE001 — degrading must not cascade
                    log.exception("ladder enter callback failed")
        return fresh

    def exit(self, condition: str) -> bool:
        """Recover from a condition: run its on_recover hooks (re-warm
        BEFORE re-admission), then clear it.  Returns True on the EXIT
        edge (False when it was not active)."""
        if condition not in CONDITIONS:
            raise ValueError(f"unknown ladder condition {condition!r}")
        with self._lock:
            if condition not in self._active:
                return False
            cbs = list(self._recover_cbs.get(condition, ()))
        for fn in cbs:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a failed re-warm must not
                # block recovery: the route re-admits and warms lazily
                log.exception("ladder recovery callback failed")
        with self._lock:
            entry = self._active.pop(condition, None)
            if entry is None:
                return False  # raced another exit
            self._dwell_s[condition] += self._clock() - entry[0]
            self.transitions += 1
        log.warning(
            "degradation ladder: EXIT %s -> mode %s",
            condition, self.mode_name(),
        )
        return True

    def on_recover(self, condition: str, fn: Callable[[], None]) -> None:
        """Register a re-warm hook run on exit(condition), before the
        condition clears (graph grid re-capture, cache re-prime)."""
        self._recover_cbs.setdefault(condition, []).append(fn)

    def on_enter(self, condition: str, fn: Callable[[str], None]) -> None:
        self._enter_cbs.setdefault(condition, []).append(fn)

    # -- views -------------------------------------------------------------

    def mode(self) -> int:
        with self._lock:
            if not self._active:
                return HEALTHY
            return max(CONDITIONS[c] for c in self._active)

    def mode_name(self) -> str:
        return MODE_NAMES[self.mode()]

    def is_active(self, condition: str) -> bool:
        with self._lock:
            return condition in self._active

    def device_ok(self) -> bool:
        return not self.is_active("device_lost")

    def region_ok(self) -> bool:
        return not self.is_active("region_log_down")

    def active(self) -> Dict[str, dict]:
        """Operator view (rides /status): condition -> {since_s,
        reason}."""
        now = self._clock()
        with self._lock:
            return {
                c: {"since_s": round(now - t, 3), "reason": r}
                for c, (t, r) in self._active.items()
            }

    def dwell_s(self, condition: Optional[str] = None) -> float:
        """Cumulative seconds spent in a condition (closed episodes
        plus the live one) — the chaos bench's dwell-time report."""
        now = self._clock()
        with self._lock:
            def one(c):
                d = self._dwell_s.get(c, 0.0)
                if c in self._active:
                    d += now - self._active[c][0]
                return d

            if condition is not None:
                return one(condition)
            return sum(one(c) for c in CONDITIONS)

    def stats(self) -> dict:
        """Gauges for /metrics (dss_store stats namespace)."""
        return {
            "dss_degraded_mode": float(self.mode()),
            "dss_degraded_transitions": float(self.transitions),
            "dss_degraded_dwell_s": round(self.dwell_s(), 3),
        }

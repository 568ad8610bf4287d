"""The worker-side route decision of the shared-memory serving front.

A request worker has three ways to answer a search:

  cache — its worker-local version-fenced read cache (microseconds;
          handled before this decision — a fenced hit never needs a
          plan).
  shm   — the shared-memory query ring to the device owner
          (parallel/shmring.py): zero-marshal, exact, fresh.
  proxy — the loopback-HTTP proxy to the leader: the pre-existing
          fallback path.  Slower (full marshal/unmarshal) but immune
          to ring saturation and owner stalls.

Same discipline as the owner-side Planner (plan/planner.py): the
decision is a pure function `decide_worker(state, headroom_ms)` over
an immutable WorkerState snapshot, so it unit-tests with no ring, no
processes, and no clock, and the live front records the same state
shape it decides from.  The cost formulas live in plan.costs
(predict_shm_ms) so the live model and a recorded state can never
disagree.

The EWMA cost model (WorkerCostModel) learns the ring round trip and
the proxy round trip from every completed request; DSS_SHM_RTT_MS and
DSS_SHM_PROXY_MS seed it, so a fresh worker can price the ring from
measurements instead of defaults.  A copy of the reference's
`dss_tpu/plan/shmroute.py`: the same decisions on the same states
(tests/test_torch_shmring.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

from dss_tpu_torch.plan import costs as _c

__all__ = [
    "WORKER_ROUTES",
    "WorkerState",
    "WorkerPlan",
    "WorkerCostModel",
    "decide_worker",
]

WORKER_ROUTES = ("shm", "proxy")


@dataclasses.dataclass(frozen=True)
class WorkerState:
    """Everything the worker-front route decision reads, frozen at
    decision time."""

    est_shm_rtt_ms: float
    est_owner_serve_ms: float
    est_proxy_ms: float
    ring_in_flight: int = 0
    ring_depth: int = 64
    owner_threads: int = 2
    owner_alive: bool = True  # owner heartbeat fresh
    shm_attached: bool = True

    def predict_shm_ms(self) -> float:
        return _c.predict_shm_ms(
            self.est_shm_rtt_ms, self.est_owner_serve_ms,
            self.ring_in_flight, self.owner_threads,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerState":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkerPlan:
    route: str
    predicted_ms: float
    reason: str


def decide_worker(state: WorkerState,
                  headroom_ms: Optional[float] = None) -> WorkerPlan:
    """Pure worker-front route choice.  Policy:

    1. no ring / dead owner -> proxy (the ring is not an option);
    2. ring full -> proxy (never block, never error — the acceptance
       contract of the shm front);
    3. ring priced above BOTH the proxy and the headroom -> proxy
       (a stalled owner must not absorb deadline-doomed waits);
    4. otherwise -> shm (the zero-marshal path is the point).
    """
    if not state.shm_attached or not state.owner_alive:
        return WorkerPlan(
            "proxy", state.est_proxy_ms,
            "no-ring" if not state.shm_attached else "owner-dead",
        )
    if state.ring_in_flight >= state.ring_depth:
        return WorkerPlan("proxy", state.est_proxy_ms, "ring-full")
    shm_ms = state.predict_shm_ms()
    if shm_ms > state.est_proxy_ms and (
        headroom_ms is None or shm_ms > headroom_ms
    ):
        return WorkerPlan("proxy", state.est_proxy_ms, "ring-slow")
    return WorkerPlan("shm", shm_ms, "shm")


class WorkerCostModel:
    """EWMA ring/proxy round-trip estimates, seeded from DSS_SHM_RTT_MS
    / DSS_SHM_PROXY_MS and updated from every
    completed request.  Thread-safe: request threads observe
    concurrently."""

    __slots__ = ("alpha", "est_shm_rtt_ms", "est_owner_serve_ms",
                 "est_proxy_ms", "shm_obs", "proxy_obs", "_lock")

    def __init__(self, *, rtt_ms: float = None, proxy_ms: float = None,
                 owner_serve_ms: float = 1.0, alpha: float = 0.2):
        def _env_f(name, default):
            raw = os.environ.get(name)
            return default if raw is None else float(raw)

        self.alpha = float(alpha)
        self.est_shm_rtt_ms = (
            _env_f("DSS_SHM_RTT_MS", 1.0) if rtt_ms is None
            else float(rtt_ms)
        )
        self.est_proxy_ms = (
            _env_f("DSS_SHM_PROXY_MS", 10.0) if proxy_ms is None
            else float(proxy_ms)
        )
        self.est_owner_serve_ms = float(owner_serve_ms)
        self.shm_obs = 0
        self.proxy_obs = 0
        self._lock = threading.Lock()

    def observe_shm(self, total_ms: float) -> None:
        with self._lock:
            # winsorize: one owner stall must not poison the estimate
            # into routing everything proxy-ward forever
            total_ms = min(
                float(total_ms), 4.0 * max(self.est_shm_rtt_ms, 0.05)
            )
            self.est_shm_rtt_ms += self.alpha * (
                total_ms - self.est_shm_rtt_ms
            )
            self.shm_obs += 1

    def observe_proxy(self, total_ms: float) -> None:
        with self._lock:
            total_ms = min(
                float(total_ms), 4.0 * max(self.est_proxy_ms, 0.05)
            )
            self.est_proxy_ms += self.alpha * (
                total_ms - self.est_proxy_ms
            )
            self.proxy_obs += 1

    def state(self, *, ring_in_flight: int, ring_depth: int,
              owner_threads: int, owner_alive: bool,
              shm_attached: bool = True) -> WorkerState:
        with self._lock:
            return WorkerState(
                est_shm_rtt_ms=self.est_shm_rtt_ms,
                est_owner_serve_ms=self.est_owner_serve_ms,
                est_proxy_ms=self.est_proxy_ms,
                ring_in_flight=ring_in_flight,
                ring_depth=ring_depth,
                owner_threads=owner_threads,
                owner_alive=owner_alive,
                shm_attached=shm_attached,
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "shm_est_rtt_ms": round(self.est_shm_rtt_ms, 4),
                "shm_est_proxy_ms": round(self.est_proxy_ms, 4),
                "shm_rtt_obs": self.shm_obs,
                "shm_proxy_obs": self.proxy_obs,
            }

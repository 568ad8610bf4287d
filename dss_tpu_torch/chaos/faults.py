"""Deterministic fault injection: named seams + a seeded schedule.

The port of the reference's `dss_tpu/chaos/faults.py`.  Every failure
seam of the serving path is a NAMED FAULT SITE that consults one
process-global schedule:

    from dss_tpu_torch import chaos
    chaos.fault_point("device.dispatch")     # sync seams
    await chaos.async_fault_point(           # event-loop seams
        "region.mirror.replicate", detail=url)

A site is a no-op (one module-global bool read) unless a FaultPlan is
installed, so the instrumented hot paths pay nothing in production.
Plans come from the DSS_FAULT_PLAN environment variable (inline JSON,
or a path to a JSON file) or programmatically via install_plan():

    {"seed": 7, "events": [
       {"site": "device.dispatch", "action": "device_lost",
        "after": 10, "count": 3},
       {"site": "resident.submit", "action": "delay", "delay_s": 0.2,
        "count": -1, "p": 0.5}]}

Determinism contract: events trigger on per-site HIT COUNTS (`after`
skips the first N matching hits, `count` bounds injections; -1 =
forever), and probabilistic events (`p` < 1) draw from a
random.Random seeded by (plan seed, site, event index) — so the same
plan against the same hit sequence injects the same faults.

Actions:
  error        raise FaultError at the site (generic failure)
  partition    raise FaultError(kind="partition")
  device_lost  raise DeviceLostError — the coalescer absorbs it and
               re-serves the batch on the host route (no caller error)
  delay        sleep delay_s at the site (stall injection; async
               sites await instead of blocking the loop)

Registered sites (grep for the literal to find the seam):
  wal.append / wal.fsync          dar/wal.py
  cache.populate                  dar/dss_store.py (read-cache insert)
  device.dispatch                 dar/coalesce.py (cold fused submit)
  resident.submit                 ops/resident.py (stream feeder)
  graph.capture                   ops/resident.py (CUDA graph capture)
  region.client.request           region/client.py (region log hop)
  region.mirror.replicate         region/mirror.py (async: primary ->
                                  mirror pushes, mirror heartbeats)

Only the injected DeviceLostError counts as a device loss
(is_device_loss): a real CUDA error raised by a kernel wrapper is
delivered to the callers, never absorbed into a host rerun.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "FaultError",
    "DeviceLostError",
    "FaultEvent",
    "FaultPlan",
    "FaultRegistry",
    "registry",
    "install_plan",
    "clear_plan",
    "fault_point",
    "async_fault_point",
    "is_device_loss",
    "load_env_plan",
]

ENV_PLAN = "DSS_FAULT_PLAN"

ACTIONS = ("error", "partition", "device_lost", "delay")


class FaultError(RuntimeError):
    """An injected fault.  `site` names the seam, `kind` the action
    ("error" | "partition" | "device_lost")."""

    def __init__(self, site: str, message: str = "", kind: str = "error"):
        super().__init__(
            message or f"injected fault at {site} ({kind})"
        )
        self.site = site
        self.kind = kind


class DeviceLostError(FaultError):
    """Injected device loss: the serving stack must absorb this (host
    fallback + DEVICE_LOST ladder entry), never surface it as a 5xx."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(site, message, kind="device_lost")


def is_device_loss(e: BaseException) -> bool:
    """Is this exception a device-loss signal the coalescer should
    absorb (host fallback + ladder report) rather than deliver?
    Injected DeviceLostError always; a real backend's device-loss
    shapes can be added here without touching any call site."""
    return isinstance(e, DeviceLostError)


class FaultEvent:
    """One scheduled event: matched by site (exact) and optional
    `match` substring against the hit's detail string; triggers on the
    site's matching-hit counter (`after` skipped first, then up to
    `count` injections; -1 = unbounded), thinned by `p` via the plan's
    deterministic RNG."""

    __slots__ = (
        "site", "action", "after", "count", "delay_s", "p", "match",
        "message", "injected", "seen", "_rng",
    )

    def __init__(
        self,
        site: str,
        action: str = "error",
        *,
        after: int = 0,
        count: int = 1,
        delay_s: float = 0.0,
        p: float = 1.0,
        match: Optional[str] = None,
        message: str = "",
    ):
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; one of {ACTIONS}"
            )
        self.site = str(site)
        self.action = action
        self.after = int(after)
        self.count = int(count)
        self.delay_s = float(delay_s)
        self.p = float(p)
        self.match = match
        self.message = message
        self.injected = 0  # times this event fired
        self.seen = 0  # matching hits observed (drives after/count)
        self._rng: Optional[random.Random] = None

    def bind(self, seed: int, index: int) -> None:
        """Give the event its deterministic RNG (seeded per plan seed
        + site + event index, so reordering unrelated events does not
        perturb this one's draws)."""
        self._rng = random.Random(f"{seed}:{self.site}:{index}")

    def matches(self, detail: Optional[str]) -> bool:
        if self.match is None:
            return True
        return self.match in (detail or "")

    def fire(self, detail: Optional[str]):
        """-> ("error"/"partition"/"device_lost"/"delay", event) when
        this hit injects, else None.  Mutates the hit counters — call
        exactly once per site hit (under the registry lock)."""
        if not self.matches(detail):
            return None
        self.seen += 1
        if self.seen <= self.after:
            return None
        if self.count >= 0 and self.injected >= self.count:
            return None
        if self.p < 1.0:
            rng = self._rng or random
            if rng.random() >= self.p:
                return None
        self.injected += 1
        return self.action

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            d["site"],
            d.get("action", "error"),
            after=d.get("after", 0),
            count=d.get("count", 1),
            delay_s=d.get("delay_s", 0.0),
            p=d.get("p", 1.0),
            match=d.get("match"),
            message=d.get("message", ""),
        )


class FaultPlan:
    """A seeded schedule of fault events, replayable byte-for-byte."""

    def __init__(self, events: List[FaultEvent], seed: int = 0):
        self.seed = int(seed)
        self.events = list(events)
        by_site: Dict[str, List[FaultEvent]] = {}
        for i, ev in enumerate(self.events):
            ev.bind(self.seed, i)
            by_site.setdefault(ev.site, []).append(ev)
        self._by_site = by_site

    def events_for(self, site: str) -> List[FaultEvent]:
        return self._by_site.get(site, ())

    @property
    def sites(self):
        return tuple(sorted(self._by_site))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            [FaultEvent.from_dict(e) for e in d.get("events", [])],
            seed=d.get("seed", 0),
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_env(cls, raw: str) -> "FaultPlan":
        """DSS_FAULT_PLAN value: inline JSON (starts with '{') or the
        path of a JSON file."""
        raw = raw.strip()
        if raw.startswith("{"):
            return cls.from_json(raw)
        with open(raw, "r", encoding="utf-8") as fh:
            return cls.from_json(fh.read())


class FaultRegistry:
    """Process-global fault-site registry: per-site hit and injection
    counters (the dss_fault_injected_total{site} gauge family) plus
    the installed plan.  check() is only reached when a plan is
    installed — fault_point() gates on the module flag first, so an
    uninstrumented deployment pays one global read per site hit."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plan: Optional[FaultPlan] = None
        self.hits: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    @property
    def plan(self) -> Optional[FaultPlan]:
        return self._plan

    def install(self, plan: Optional[FaultPlan]) -> None:
        global _ACTIVE
        with self._lock:
            self._plan = plan
        _ACTIVE = plan is not None

    def clear(self) -> None:
        self.install(None)

    def reset_counters(self) -> None:
        with self._lock:
            self.hits.clear()
            self.injected.clear()

    def injected_by_site(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)

    def hits_by_site(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.hits)

    def check(self, site: str, detail: Optional[str] = None):
        """Count the hit and consult the plan -> (action, event) to
        perform, or None.  The caller performs the action (raise /
        sleep)."""
        with self._lock:
            self.hits[site] = self.hits.get(site, 0) + 1
            plan = self._plan
            if plan is None:
                return None
            for ev in plan.events_for(site):
                action = ev.fire(detail)
                if action is not None:
                    self.injected[site] = self.injected.get(site, 0) + 1
                    return (action, ev)
        return None

    def _raise_for(self, site: str, action: str, ev: FaultEvent):
        if action == "device_lost":
            raise DeviceLostError(site, ev.message)
        raise FaultError(site, ev.message, kind=action)

    def fire(self, site: str, detail: Optional[str] = None) -> None:
        hit = self.check(site, detail)
        if hit is None:
            return
        action, ev = hit
        if action == "delay":
            time.sleep(ev.delay_s)
            return
        self._raise_for(site, action, ev)

    async def fire_async(
        self, site: str, detail: Optional[str] = None
    ) -> None:
        hit = self.check(site, detail)
        if hit is None:
            return
        action, ev = hit
        if action == "delay":
            import asyncio

            await asyncio.sleep(ev.delay_s)
            return
        self._raise_for(site, action, ev)


_REGISTRY = FaultRegistry()
_ACTIVE = False  # mirror of "a plan is installed": the zero-overhead gate


def registry() -> FaultRegistry:
    return _REGISTRY


def install_plan(plan) -> None:
    """Install a FaultPlan (or a dict / JSON text coerced into one)."""
    if isinstance(plan, str):
        plan = FaultPlan.from_json(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan.from_dict(plan)
    _REGISTRY.install(plan)


def clear_plan() -> None:
    _REGISTRY.clear()


def fault_point(site: str, detail: Optional[str] = None) -> None:
    """THE sync seam instrumentation call.  One global-bool read when
    no plan is installed (the production case)."""
    if not _ACTIVE:
        return
    _REGISTRY.fire(site, detail)


async def async_fault_point(
    site: str, detail: Optional[str] = None
) -> None:
    """fault_point for event-loop seams: delay events await instead of
    blocking the loop."""
    if not _ACTIVE:
        return
    await _REGISTRY.fire_async(site, detail)


def load_env_plan() -> bool:
    """Install the DSS_FAULT_PLAN plan if the env var is set (called
    at import so any process honors the schedule).  Returns whether a plan was installed."""
    raw = os.environ.get(ENV_PLAN)
    if not raw:
        return False
    _REGISTRY.install(FaultPlan.from_env(raw))
    return True


load_env_plan()

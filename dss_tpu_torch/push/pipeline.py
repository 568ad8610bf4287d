"""PushPipeline: the store-facing spine of the push subsystem.

Wiring (DSSStore.attach_push):

  write txn (store lock held)
    -> MatchStage.match (planner rqmatch route, bit-identical host
       fallback) — the SAME id set `_notify_subs_locked` bumps and the
       HTTP response returns, so enabling push cannot change a
       response byte
    -> bump + journal (unchanged)
    -> PushPipeline.offer(...) — O(1) per matched subscriber: resolve
       the registered webhook, append a durable push_evt, wake the
       delivery pool.  Everything slow (webhook POSTs, retries,
       breaker probes, federation hops) happens on the pool's I/O
       threads, never on the write path and never under the store
       lock.

Federation: a local write is also fanned to every remote region as a
`@region:<id>` pseudo-notification riding the same durable queue —
the owning region's /aux/v1/push/ingest re-runs the match against ITS
subscription DAR (subscriptions live where they were registered, so
the match must too) and enqueues local webhook deliveries.  Remote
ingest never bumps notification indexes (the bump belongs to the
region that owns the write txn) and never re-forwards (no loops).

Health: queue saturation (depth past DSS_PUSH_DEPTH_HIGH of the
bound) or every delivery breaker open flips the store ladder to
push_degraded — the mildest rung: serving is untouched, only webhook
fan-out is behind.  Recovery exits the condition when the depth
drains under the low-water mark and a breaker closes.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from dss_tpu_torch.obs import trace
from dss_tpu_torch.push.deliver import DeliveryPool
from dss_tpu_torch.push.match import MatchStage
from dss_tpu_torch.push.queue import DeliveryLog

__all__ = ["PushPipeline", "empty_stats", "env_knobs"]

_REGION_PREFIX = "@region:"


def env_knobs() -> dict:
    """DSS_PUSH_* boot knobs (the reference's docs/OPERATIONS.md has
    the table)."""

    def _f(name, default, conv):
        v = os.environ.get(name)
        if v is None or v == "":
            return default
        try:
            return conv(v)
        except (TypeError, ValueError):
            return default

    return {
        "log_path": os.environ.get("DSS_PUSH_LOG") or None,
        "fsync": _f("DSS_PUSH_FSYNC", False, lambda v: v == "1"),
        "workers": _f("DSS_PUSH_WORKERS", 2, int),
        "max_depth": _f("DSS_PUSH_MAX_DEPTH", 100_000, int),
        "max_attempts": _f("DSS_PUSH_MAX_ATTEMPTS", 20, int),
        "breaker_threshold": _f("DSS_PUSH_BREAKER_THRESHOLD", 3, int),
        "breaker_reset_s": _f("DSS_PUSH_BREAKER_RESET_S", 2.0, float),
        "timeout_s": _f("DSS_PUSH_TIMEOUT_S", 3.0, float),
        "federate": _f("DSS_PUSH_FEDERATE", True, lambda v: v != "0"),
    }


class PushPipeline:
    """One store's push subsystem: match stages + durable queue +
    delivery pool + webhook registry."""

    def __init__(self, *, log_path: Optional[str] = None,
                 fsync: bool = False, workers: int = 2,
                 max_depth: int = 100_000, max_attempts: int = 20,
                 breaker_threshold: int = 3, breaker_reset_s: float = 2.0,
                 timeout_s: float = 3.0, federate: bool = True,
                 transport=None, metrics=None,
                 depth_high: float = 0.9, depth_low: float = 0.5):
        self.log = DeliveryLog(
            log_path, fsync=fsync, max_depth=max_depth
        )
        if transport is None:
            from dss_tpu_torch.push.deliver import http_transport

            transport = http_transport(timeout_s)
        self.pool = DeliveryPool(
            self.log, workers=workers, transport=transport,
            sender=self._send, max_attempts=max_attempts,
            breaker_threshold=breaker_threshold,
            breaker_reset_s=breaker_reset_s, metrics=metrics,
            on_edge=self._update_health,
        )
        self._transport = transport
        self._metrics = metrics
        self._federate = bool(federate)
        self._depth_high = float(depth_high)
        self._depth_low = float(depth_low)
        self._store = None
        self._health = None
        self._stages: Dict[str, MatchStage] = {}
        self._lock = threading.Lock()
        self._degraded = False
        self.skipped = 0  # matched subs with no registered webhook
        self.fed_forwarded = 0
        self.fed_ingested = 0
        self.offers = 0

    # -- store binding -----------------------------------------------------

    def bind_store(self, store) -> None:
        """Called by DSSStore.attach_push: build a MatchStage per
        subscription class over the store's live indexes, share the
        store's health ladder, and start the delivery pool."""
        self._store = store
        self._health = store.health
        self._stages = {
            "rid_sub": MatchStage(
                store.rid._sub_index, health=store.health,
                metrics=self._metrics,
            ),
            "scd_sub": MatchStage(
                store.scd._sub_index, health=store.health,
                metrics=self._metrics,
            ),
        }
        self.pool.start()

    @property
    def bound(self) -> bool:
        return self._store is not None

    def stage(self, cls: str) -> MatchStage:
        return self._stages[cls]

    # -- matching (the store's write path) ---------------------------------

    def match_ids(self, cls: str, cells, alt_lo=None, alt_hi=None,
                  t_start_ns=None, t_end_ns=None, *,
                  now_ns: int) -> List[str]:
        """One write volume against one subscription class — the
        rqmatch route (host-oracle fallback), sorted ids."""
        return self._stages[cls].match(
            cells, alt_lo, alt_hi, t_start_ns, t_end_ns, now_ns=now_ns
        )

    # -- fan-out (called post-journal, inside the write txn) ---------------

    def offer(self, trigger: str, entity, subs, *,
              removed: bool = False, emergency: bool = False,
              alt_lo=None, alt_hi=None, t_start_ns=None,
              t_end_ns=None) -> int:
        """Durably enqueue one notification per matched+bumped
        subscriber with a registered webhook, plus one federation
        forward per remote region.  Returns notifications enqueued.
        Cheap by contract — WAL appends and a condition notify; all
        I/O happens on the pool."""
        self.offers += 1
        tp = trace.propagation_headers().get("traceparent", "")
        ent = {
            "type": trigger,
            "id": getattr(entity, "id", ""),
            "ovn": getattr(entity, "ovn", ""),
            "owner": str(getattr(entity, "owner", "")),
            "removed": bool(removed),
        }
        n_enq = 0
        for sub in subs:
            hook = self.log.hook_of(str(sub.owner))
            if hook is None:
                self.skipped += 1
                continue
            qos = "emergency" if emergency else hook["qos"]
            body = {
                "trigger": trigger,
                "entity": ent,
                "subscription": {
                    "id": sub.id,
                    "notification_index": sub.notification_index,
                },
            }
            if self.log.enqueue(
                str(sub.owner), hook["url"], body, qos=qos,
                traceparent=tp,
            ) is not None:
                n_enq += 1
        n_enq += self._forward_remote(
            trigger, entity, ent, emergency=emergency,
            alt_lo=alt_lo, alt_hi=alt_hi,
            t_start_ns=t_start_ns, t_end_ns=t_end_ns,
            traceparent=tp,
        )
        self._update_health()
        return n_enq

    def _forward_remote(self, trigger, entity, ent, *, emergency,
                        alt_lo, alt_hi, t_start_ns, t_end_ns,
                        traceparent) -> int:
        store = self._store
        if not self._federate or store is None:
            return 0
        fed = getattr(store, "federation", None)
        if fed is None or not getattr(fed, "peers", None):
            return 0
        cells = np.asarray(
            getattr(entity, "cells", ()), dtype=np.uint64
        ).ravel()
        if cells.size == 0:
            return 0
        payload = {
            "trigger": trigger,
            "entity": ent,
            "emergency": bool(emergency),
            "cells": [int(c) for c in cells],
            "alt_lo": None if alt_lo is None else float(alt_lo),
            "alt_hi": None if alt_hi is None else float(alt_hi),
            "t0_ns": None if t_start_ns is None else int(t_start_ns),
            "t1_ns": None if t_end_ns is None else int(t_end_ns),
            "origin": getattr(fed, "region_id", ""),
        }
        n = 0
        for rid in fed.peers:
            if self.log.enqueue(
                _REGION_PREFIX + rid, rid, payload,
                qos="emergency" if emergency else "bulk",
                traceparent=traceparent,
            ) is not None:
                self.fed_forwarded += 1
                n += 1
        return n

    # -- delivery sender (webhook or federation hop) -----------------------

    def _send(self, n, headers: Dict[str, str]) -> None:
        """DeliveryPool sender: `@region:` pseudo-targets hop to the
        owning region's ingest endpoint through its FederationPeer
        (breaker-counted there too); everything else is a webhook
        POST."""
        if n.uss.startswith(_REGION_PREFIX):
            fed = getattr(self._store, "federation", None)
            if fed is None:
                raise RuntimeError("federation detached")
            peer = fed.peers[n.target]
            if not peer.breaker.allow():
                raise RuntimeError(f"peer {n.target} breaker open")
            peer.call("POST", "/aux/v1/push/ingest", n.body)
            return
        self._transport(n.target, n.body, headers)

    # -- federation fan-in -------------------------------------------------

    def ingest_remote(self, payload: dict) -> dict:
        """Serve a remote region's /aux/v1/push/ingest: match the
        remote write's volume against OUR subscription DAR and enqueue
        local webhook deliveries.  No notification-index bump (the
        writing region owns the txn; our indexes advance only on local
        writes) and no re-forward (origin != local only, no loops)."""
        store = self._store
        if store is None:
            raise RuntimeError("push pipeline not bound to a store")
        trigger = payload.get("trigger", "operations")
        cls = "rid_sub" if trigger == "rid" else "scd_sub"
        cells = np.asarray(
            [int(c) for c in payload.get("cells", ())], dtype=np.uint64
        )
        if cells.size == 0:
            return {"matched": 0, "enqueued": 0}
        sub_store = store.rid if cls == "rid_sub" else store.scd
        now_ns = sub_store._now_ns()
        ids = self.match_ids(
            cls, cells,
            alt_lo=payload.get("alt_lo"), alt_hi=payload.get("alt_hi"),
            t_start_ns=payload.get("t0_ns"),
            t_end_ns=payload.get("t1_ns"), now_ns=now_ns,
        )
        want_constraints = trigger == "constraints"
        ent = dict(payload.get("entity", {}))
        ent["origin"] = payload.get("origin", "")
        emergency = bool(payload.get("emergency", False))
        tp = payload.get("traceparent", "")
        n_enq = 0
        matched = 0
        for i in sorted(ids):
            sub = sub_store._subs.get(i)
            if sub is None:
                continue
            if cls == "scd_sub":
                if want_constraints:
                    if not sub.notify_for_constraints:
                        continue
                elif not sub.notify_for_operations:
                    continue
            matched += 1
            hook = self.log.hook_of(str(sub.owner))
            if hook is None:
                self.skipped += 1
                continue
            body = {
                "trigger": trigger,
                "entity": ent,
                "subscription": {
                    "id": sub.id,
                    "notification_index": sub.notification_index,
                },
            }
            if self.log.enqueue(
                str(sub.owner), hook["url"], body,
                qos="emergency" if emergency else hook["qos"],
                traceparent=tp,
            ) is not None:
                n_enq += 1
        self.fed_ingested += 1
        self._update_health()
        return {"matched": matched, "enqueued": n_enq}

    # -- webhook registry passthrough --------------------------------------

    def register_hook(self, uss: str, url: str,
                      qos: str = "bulk") -> dict:
        return self.log.register_hook(uss, url, qos)

    def unregister_hook(self, uss: str) -> bool:
        return self.log.unregister_hook(uss)

    def hooks(self) -> Dict[str, dict]:
        return self.log.hooks()

    # -- health ------------------------------------------------------------

    def _update_health(self) -> None:
        health = self._health
        if health is None:
            return
        depth = self.log.depth()
        saturated = depth >= self._depth_high * self.log.max_depth
        starved = bool(self.log.hooks()) and self.pool.all_open()
        if saturated or starved:
            if not self._degraded:
                self._degraded = True
                health.enter(
                    "push_degraded",
                    "queue saturated" if saturated
                    else "all delivery breakers open",
                )
        elif self._degraded and depth <= (
            self._depth_low * self.log.max_depth
        ) and not self.pool.all_open():
            self._degraded = False
            health.exit("push_degraded")

    # -- lifecycle / introspection -----------------------------------------

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until the queue is empty (tests/bench); False on
        timeout."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            if self.log.depth() == 0:
                return True
            _time.sleep(0.005)
        return self.log.depth() == 0

    def close(self) -> None:
        self.pool.close()
        self.log.close()

    def status(self) -> dict:
        """Operator view (GET /aux/v1/push/status)."""
        q = self.log.stats()
        p = self.pool.stats()
        return {
            "hooks": self.hooks(),
            "queue": q,
            "delivered": p["delivered"],
            "failures": p["failures"],
            "parked": p["parked"],
            "delivery_lag_ms": self.pool.lag_percentiles_ms(),
            "breakers": {
                u: s for u, s in p["breaker_state"].items()
            },
            "degraded": self._degraded,
            "match": {
                cls: st.stats() for cls, st in self._stages.items()
            },
            "federation": {
                "forwarded": self.fed_forwarded,
                "ingested": self.fed_ingested,
            },
        }

    def stats(self) -> dict:
        """dss_push_* gauges — the same stable key set empty_stats()
        exports when no pipeline is attached."""
        q = self.log.stats()
        p = self.pool.stats()
        return {
            "dss_push_queue_depth": q["depth"],
            "dss_push_queue_depth_emergency": q["depth_emergency"],
            "dss_push_queue_depth_bulk": q["depth_bulk"],
            "dss_push_enqueued_total": q["enqueued"],
            "dss_push_acked_total": q["acked"],
            "dss_push_dropped_total": q["dropped"],
            "dss_push_requeued_total": q["requeued"],
            "dss_push_hooks": q["hooks"],
            "dss_push_delivered_total": p["delivered"],
            "dss_push_failures_total": p["failures"],
            "dss_push_parked_total": p["parked"],
            "dss_push_delivery_lag_p50_ms": p["lag_p50_ms"],
            "dss_push_delivery_lag_p99_ms": p["lag_p99_ms"],
            "dss_push_oldest_pending_s": round(
                self.log.oldest_pending_age_s(), 3
            ),
            "dss_push_skipped_total": self.skipped,
            "dss_push_fed_forwarded_total": self.fed_forwarded,
            "dss_push_fed_ingested_total": self.fed_ingested,
            "dss_push_match_batches_total": sum(
                st.batches for st in self._stages.values()
            ),
            "dss_push_match_queries_total": sum(
                st.queries for st in self._stages.values()
            ),
            "dss_push_match_absorbed_total": sum(
                st.absorbed for st in self._stages.values()
            ),
            "dss_push_breaker_state": dict(p["breaker_state"]),
        }


def empty_stats() -> dict:
    """The stable dss_push_* key set for stores without a pipeline —
    dashboards never miss a series (same discipline as federation and
    the shm front)."""
    return {
        "dss_push_queue_depth": 0,
        "dss_push_queue_depth_emergency": 0,
        "dss_push_queue_depth_bulk": 0,
        "dss_push_enqueued_total": 0,
        "dss_push_acked_total": 0,
        "dss_push_dropped_total": 0,
        "dss_push_requeued_total": 0,
        "dss_push_hooks": 0,
        "dss_push_delivered_total": 0,
        "dss_push_failures_total": 0,
        "dss_push_parked_total": 0,
        "dss_push_delivery_lag_p50_ms": 0.0,
        "dss_push_delivery_lag_p99_ms": 0.0,
        "dss_push_oldest_pending_s": 0.0,
        "dss_push_skipped_total": 0,
        "dss_push_fed_forwarded_total": 0,
        "dss_push_fed_ingested_total": 0,
        "dss_push_match_batches_total": 0,
        "dss_push_match_queries_total": 0,
        "dss_push_match_absorbed_total": 0,
        "dss_push_breaker_state": {},
    }

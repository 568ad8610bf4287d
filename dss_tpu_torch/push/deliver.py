"""Webhook fan-out workers: breakers, backoff, QoS, lag accounting.

The DeliveryPool drains the DeliveryLog with plain I/O threads — the
pool never touches the store lock, the device, or the coalescer, so
fan-out to any number of subscribers cannot block the device owner's
serve path (the shm-front deployment keeps its owner threads fenced
from delivery entirely: the only shared state is the WAL-backed
queue).

Per-USS flow control, all through the shared chaos machinery
(chaos/retry.py — no new retry dialect):

  breaker   one CircuitBreaker per USS (BreakerRegistry): consecutive
            webhook failures open it, and an open breaker removes the
            USS from the take() rotation — a dead USS costs zero
            attempts while every other USS keeps draining.  Surfaced
            as dss_push_breaker_state{uss}.
  backoff   the shared jittered-exponential RetryPolicy stamps a
            per-USS not-before hold after each failure, so a flapping
            USS is retried on the policy's schedule instead of
            hot-looped.
  parking   past max_attempts a notification is parked (durably acked
            so it never redelivers, counted as dss_push_parked_total)
            — the dead-letter seam, NOT a success.

QoS: the queue hands out the emergency band strictly before bulk; the
pool adds nothing — preemption is a property of what take() returns.

Every delivery POST carries the traceparent captured when the WRITE
enqueued it plus X-Request-Id, so write -> match -> deliver stitches
into one trace at the receiver; the attempt duration lands in the
dss_stage_duration_seconds{stage="push_deliver_ms"} histogram and the
enqueue->ack wall time feeds the delivery-lag reservoir behind
dss_push_delivery_lag_p50_ms/p99_ms.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from dss_tpu_torch import chaos
from dss_tpu_torch.push.queue import DeliveryLog, Notification

__all__ = ["DeliveryPool", "http_transport"]


def http_transport(timeout_s: float = 3.0) -> Callable:
    """The production webhook sender: POST the notification body as
    JSON.  Any non-2xx or transport error raises."""
    import urllib.request

    def send(url: str, body: dict, headers: Dict[str, str]) -> None:
        req = urllib.request.Request(
            url,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **headers},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            if not (200 <= resp.status < 300):
                raise OSError(f"webhook status {resp.status}")

    return send


class DeliveryPool:
    """N worker threads draining a DeliveryLog.

    `transport(url, body, headers)` raises on failure; `sender`, when
    given, overrides transport per notification (the pipeline routes
    `@region:` pseudo-targets to federation peers through it)."""

    def __init__(self, log: DeliveryLog, *, workers: int = 2,
                 transport: Optional[Callable] = None,
                 sender: Optional[Callable] = None,
                 retry: Optional[chaos.RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 2.0,
                 max_attempts: int = 20,
                 metrics=None,
                 clock=time.monotonic,
                 wall_clock_ns=time.time_ns,
                 on_edge: Optional[Callable[[], None]] = None):
        self._log = log
        self._workers = max(1, int(workers))
        self._transport = transport or http_transport()
        self._sender = sender
        self._retry = retry or chaos.RetryPolicy(
            base_s=0.05, cap_s=5.0, seed=0x9157
        )
        self.breakers = chaos.BreakerRegistry(
            fail_threshold=breaker_threshold,
            reset_s=breaker_reset_s, clock=clock,
        )
        self.max_attempts = max(1, int(max_attempts))
        self._metrics = metrics
        self._clock = clock
        self._wall_ns = wall_clock_ns
        self._on_edge = on_edge  # pipeline's ladder re-evaluation hook
        self._lock = threading.Lock()
        self._holds: Dict[str, float] = {}  # uss -> not-before (mono)
        self._lags_ms: deque = deque(maxlen=4096)
        self.delivered = 0
        self.failures = 0
        self.parked = 0
        self._threads = []
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        for i in range(self._workers):
            t = threading.Thread(
                target=self._run, name=f"dss-push-deliver-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    # -- flow control ------------------------------------------------------

    def _blocked(self):
        now = self._clock()
        with self._lock:
            held = {u for u, t in self._holds.items() if t > now}
            for u in [u for u, t in self._holds.items() if t <= now]:
                del self._holds[u]
        # breaker-open USSs are skipped without an attempt; half-open
        # lets the probe through (allow() flips the state)
        for uss, state in self.breakers.states().items():
            if state == chaos.BREAKER_OPEN:
                b = self.breakers.get(uss)
                if not b.allow():
                    held.add(uss)
        return held

    def _hold(self, uss: str, attempts: int) -> None:
        with self._lock:
            self._holds[uss] = self._clock() + self._retry.backoff_s(
                min(attempts, 10)
            )

    # -- the worker loop ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            n = self._log.take(blocked=self._blocked(), timeout_s=0.2)
            if n is None:
                continue
            self._attempt(n)

    def _attempt(self, n: Notification) -> None:
        headers = {}
        if n.traceparent:
            headers["traceparent"] = n.traceparent
            # trace id = chars 3..35 of the traceparent; the receiver
            # greps its logs by request id exactly like our own front
            parts = n.traceparent.split("-")
            if len(parts) == 4:
                headers["X-Request-Id"] = parts[1]
        headers["X-DSS-Notification-Id"] = str(n.nid)
        breaker = self.breakers.get(n.uss)
        t0 = time.perf_counter()
        try:
            chaos.fault_point("push.deliver", detail=n.uss)
            if self._sender is not None:
                self._sender(n, headers)
            else:
                self._transport(n.target, n.body, headers)
        except Exception:  # noqa: BLE001 — any failure is a retry
            breaker.record_failure()
            self.failures += 1
            if n.attempts + 1 >= self.max_attempts:
                self._log.park(n.nid, reason="max_attempts")
                self.parked += 1
            else:
                self._hold(n.uss, n.attempts)
                self._log.requeue(n)
            if self._on_edge is not None:
                self._on_edge()
            return
        dur_s = time.perf_counter() - t0
        breaker.record_success()
        self._log.ack(n.nid)
        self.delivered += 1
        lag_ms = max(0.0, (self._wall_ns() - n.enqueued_ns) / 1e6)
        with self._lock:
            self._lags_ms.append(lag_ms)
        if self._metrics is not None:
            self._metrics.observe_stage("push", "push_deliver_ms", dur_s)
        if self._on_edge is not None:
            self._on_edge()

    # -- views -------------------------------------------------------------

    def lag_percentiles_ms(self) -> Dict[str, float]:
        with self._lock:
            lags = sorted(self._lags_ms)
        if not lags:
            return {"p50": 0.0, "p99": 0.0}

        def pct(p):
            i = min(len(lags) - 1, int(p * (len(lags) - 1)))
            return round(lags[i], 3)

        return {"p50": pct(0.50), "p99": pct(0.99)}

    def all_open(self) -> bool:
        return self.breakers.all_open()

    def stats(self) -> dict:
        lag = self.lag_percentiles_ms()
        return {
            "delivered": self.delivered,
            "failures": self.failures,
            "parked": self.parked,
            "lag_p50_ms": lag["p50"],
            "lag_p99_ms": lag["p99"],
            "breaker_state": self.breakers.states(),
        }

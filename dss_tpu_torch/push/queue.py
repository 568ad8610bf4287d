"""The durable per-USS delivery queue: WAL-backed cursor + ack.

Durability contract (what the crash drill asserts):

  - `enqueue` appends a `push_evt` record BEFORE the notification is
    visible to any worker: a notification that was ever handed to a
    delivery worker is on disk.
  - `ack` appends a `push_ack` record when (and only when) the webhook
    POST succeeded: an acked notification survives any crash and is
    never redelivered.
  - replay reconstructs pending = enqueued − acked, so an unacked
    notification is redelivered after restart — at-least-once, the
    only honest contract a webhook can carry (the POST may have landed
    just before the crash; the receiver dedupes on the notification
    id, which is stable across redeliveries).

Webhook registrations (`push_hook` / `push_unhook`) ride the same log
so a restarted instance still knows where to deliver.

The queue is two QoS bands — "emergency" drains strictly before
"bulk" (a contingent-operation notification must not sit behind ten
thousand routine bumps) — of per-notification entries; per-USS
fairness and backoff live in deliver.py (the queue only skips USSs
the pool currently holds blocked).  Depth is bounded: past max_depth
new BULK notifications are dropped-and-counted (the saturation alert's
trigger) while emergency ones are always admitted — the bound exists
to protect the process from a dead USS, not to shed the traffic the
QoS tier exists for.

Reuses dar/wal.py's WriteAheadLog (same fsync knob, same torn-tail
recovery) rather than inventing a second record format.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dss_tpu_torch.dar.wal import WriteAheadLog

__all__ = ["DeliveryLog", "Notification", "QOS_BANDS"]

QOS_BANDS = ("emergency", "bulk")


@dataclasses.dataclass
class Notification:
    """One queued delivery.  `body` is the webhook payload; `target`
    is the registered webhook URL — or a `@region:<id>` pseudo-target
    for federation fan-out (pipeline.py routes those to the owning
    region's /aux/v1/push/ingest instead of a USS webhook)."""

    nid: int
    uss: str
    target: str
    qos: str
    body: dict
    traceparent: str = ""
    enqueued_ns: int = 0
    attempts: int = 0

    def to_doc(self) -> dict:
        return {
            "nid": self.nid, "uss": self.uss, "target": self.target,
            "qos": self.qos, "body": self.body,
            "tp": self.traceparent, "ts_ns": self.enqueued_ns,
        }

    @classmethod
    def from_doc(cls, d: dict) -> "Notification":
        return cls(
            nid=int(d["nid"]), uss=d["uss"], target=d["target"],
            qos=d.get("qos", "bulk"), body=d.get("body", {}),
            traceparent=d.get("tp", ""),
            enqueued_ns=int(d.get("ts_ns", 0)),
        )


class DeliveryLog:
    """WAL-backed notification queue + webhook registry."""

    def __init__(self, path: Optional[str] = None, *,
                 fsync: bool = False, max_depth: int = 100_000,
                 wall_clock_ns=time.time_ns):
        self._wal = WriteAheadLog(path, fsync=fsync)
        self._wall_ns = wall_clock_ns
        self.max_depth = max(1, int(max_depth))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # qos band -> FIFO of pending notifications
        self._pending: Dict[str, deque] = {q: deque() for q in QOS_BANDS}
        # nid -> notification, for everything enqueued-not-acked
        # (pending OR held by a worker) — the redelivery set
        self._open: Dict[int, Notification] = {}
        self._hooks: Dict[str, dict] = {}  # uss -> {url, qos}
        self._next_nid = 1
        self.enqueued = 0
        self.acked = 0
        self.dropped = 0
        self.requeued = 0
        self._closed = False
        self._replay()

    # -- boot --------------------------------------------------------------

    def _replay(self) -> None:
        acked = set()
        evts: Dict[int, Notification] = {}
        for rec in self._wal.replay():
            t = rec.get("t", "")
            if t == "push_hook":
                self._hooks[rec["uss"]] = {
                    "url": rec["url"], "qos": rec.get("qos", "bulk"),
                }
            elif t == "push_unhook":
                self._hooks.pop(rec["uss"], None)
            elif t == "push_evt":
                n = Notification.from_doc(rec)
                evts[n.nid] = n
                self._next_nid = max(self._next_nid, n.nid + 1)
            elif t == "push_ack":
                acked.add(int(rec["nid"]))
        for nid in sorted(evts):
            if nid in acked:
                continue
            n = evts[nid]
            self._open[nid] = n
            self._pending[n.qos if n.qos in QOS_BANDS else "bulk"].append(n)

    # -- webhook registry --------------------------------------------------

    def register_hook(self, uss: str, url: str,
                      qos: str = "bulk") -> dict:
        if qos not in QOS_BANDS:
            raise ValueError(f"unknown qos band {qos!r}")
        with self._lock:
            self._hooks[uss] = {"url": url, "qos": qos}
            self._wal.append({
                "t": "push_hook", "uss": uss, "url": url, "qos": qos,
            })
            return dict(self._hooks[uss])

    def unregister_hook(self, uss: str) -> bool:
        with self._lock:
            had = self._hooks.pop(uss, None) is not None
            if had:
                self._wal.append({"t": "push_unhook", "uss": uss})
            return had

    def hook_of(self, uss: str) -> Optional[dict]:
        with self._lock:
            h = self._hooks.get(uss)
            return None if h is None else dict(h)

    def hooks(self) -> Dict[str, dict]:
        with self._lock:
            return {u: dict(h) for u, h in self._hooks.items()}

    # -- queue -------------------------------------------------------------

    def enqueue(self, uss: str, target: str, body: dict, *,
                qos: str = "bulk", traceparent: str = "") -> Optional[int]:
        """Durably append + make visible to workers.  Returns the nid,
        or None when a BULK notification was shed at the depth bound
        (emergency notifications are always admitted)."""
        if qos not in QOS_BANDS:
            qos = "bulk"
        with self._lock:
            if self._closed:
                return None
            if qos == "bulk" and len(self._open) >= self.max_depth:
                self.dropped += 1
                return None
            n = Notification(
                nid=self._next_nid, uss=uss, target=target, qos=qos,
                body=body, traceparent=traceparent,
                enqueued_ns=self._wall_ns(),
            )
            self._next_nid += 1
            rec = n.to_doc()
            rec["t"] = "push_evt"
            self._wal.append(rec)
            self._open[n.nid] = n
            self._pending[qos].append(n)
            self.enqueued += 1
            self._cv.notify()
            return n.nid

    def take(self, *, blocked=(), timeout_s: float = 0.2
             ) -> Optional[Notification]:
        """Pop the next deliverable notification: the emergency band
        drains strictly before bulk, skipping USSs in `blocked` (open
        breakers / backoff holds — deliver.py's set).  Blocks up to
        timeout_s when nothing is deliverable."""
        blocked = set(blocked)
        with self._cv:
            n = self._take_locked(blocked)
            if n is None and timeout_s > 0:
                self._cv.wait(timeout_s)
                n = self._take_locked(blocked)
            return n

    def _take_locked(self, blocked) -> Optional[Notification]:
        for qos in QOS_BANDS:
            q = self._pending[qos]
            for _ in range(len(q)):
                n = q.popleft()
                if n.uss in blocked:
                    q.append(n)  # rotate past the blocked USS
                    continue
                return n
        return None

    def requeue(self, n: Notification) -> None:
        """A failed attempt: back of its band, attempts bumped (the
        pool's backoff/parking decisions read the count)."""
        with self._cv:
            if n.nid not in self._open:
                return  # acked or parked concurrently
            n.attempts += 1
            self._pending[n.qos].append(n)
            self.requeued += 1
            self._cv.notify()

    def ack(self, nid: int) -> bool:
        """Durably mark delivered.  After this record is on disk the
        notification is never handed out again — including across a
        crash+replay."""
        with self._cv:
            n = self._open.pop(nid, None)
            if n is None:
                return False
            self._wal.append({"t": "push_ack", "nid": nid})
            self.acked += 1
            return True

    def park(self, nid: int, reason: str = "") -> bool:
        """Give up on a notification (attempt cap): acked on disk so
        it never redelivers, but counted separately — parked is a
        delivery FAILURE the dead-letter gauge surfaces, not a
        success."""
        with self._cv:
            n = self._open.pop(nid, None)
            if n is None:
                return False
            self._wal.append({
                "t": "push_ack", "nid": nid, "parked": True,
                "reason": reason,
            })
            return True

    # -- views -------------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._open)

    def oldest_pending_age_s(self) -> float:
        with self._lock:
            if not self._open:
                return 0.0
            oldest = min(n.enqueued_ns for n in self._open.values())
            return max(0.0, (self._wall_ns() - oldest) / 1e9)

    @property
    def seq(self) -> int:
        return self._wal.seq

    def sync(self) -> None:
        self._wal.sync()

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._open),
                "depth_emergency": len(self._pending["emergency"]),
                "depth_bulk": len(self._pending["bulk"]),
                "enqueued": self.enqueued,
                "acked": self.acked,
                "dropped": self.dropped,
                "requeued": self.requeued,
                "hooks": len(self._hooks),
            }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._wal.close()

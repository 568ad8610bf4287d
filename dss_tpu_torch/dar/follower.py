"""WalFollower: tail a leader's write-ahead log into a read replica.

The multi-worker serving architecture (SURVEY §1 L1 scale-out; the
role goroutine-per-RPC + CRDB ranges play in the reference,
cmds/grpc-backend/main.go:201-214): one leader process owns all
mutations + the WAL; N read-worker processes each hold a full DSSStore
replica rebuilt by replaying the WAL and kept fresh by tailing it.
Readers get lock-free local serving; staleness is bounded by the poll
interval (+ a read-your-writes wait on proxied mutations, see
cmds/server.py worker mode).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from dss_tpu_torch.parallel.replica import _WalTail

log = logging.getLogger("dss.follower")


class WalFollower:
    """Applies a WAL file's records into a DSSStore as they appear."""

    def __init__(self, store, wal_path: str, interval_s: float = 0.02):
        self._store = store
        self._tail = _WalTail(wal_path)
        self._interval = interval_s
        self._applied_seq = 0
        self._apply_errors = 0
        self._stop = threading.Event()
        self._seq_cond = threading.Condition()
        # serializes tail reads: the background loop and wait_for's
        # active catchup share one _WalTail (stateful file offset)
        self._poll_mutex = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def applied_seq(self) -> int:
        return self._applied_seq

    def poll_once(self) -> int:
        """Apply any new records; -> count applied.  A single bad
        record is skipped and counted — it must not wedge the tail."""
        recs = self._tail.poll()
        if not recs:
            return 0
        store = self._store
        with store._lock:
            store._replaying = True
            try:
                for rec in recs:
                    try:
                        store.apply_log_record(rec)
                    except Exception:  # noqa: BLE001 — isolate bad records
                        self._apply_errors += 1
                        log.exception(
                            "follower failed to apply %r; skipped",
                            rec.get("t"),
                        )
            finally:
                store._replaying = False
        with self._seq_cond:
            self._applied_seq = max(
                self._applied_seq, max(r.get("seq", 0) for r in recs)
            )
            self._seq_cond.notify_all()
        return len(recs)

    def wait_for(self, seq: int, timeout_s: float = 1.0) -> bool:
        """Block until the replica has applied WAL seq >= seq (the
        read-your-writes courtesy after a proxied mutation, and the
        shm ring's record-assembly bound).  False on timeout — the
        caller proceeds with bounded staleness.

        Catchup is ACTIVE: a behind caller pulls the tail itself
        instead of sleeping until the next background tick, so the
        wait is bounded by a page-cache file read (the target records
        are already appended — the leader's seq only moves after the
        append), not by the poll interval.  Under a miss burst the
        mutex collapses concurrent pullers into one read; the rest
        wake on the same seq condition."""
        if self._applied_seq >= seq:
            return True
        deadline = time.monotonic() + timeout_s
        while True:
            if self._poll_mutex.acquire(timeout=0.005):
                try:
                    if self._applied_seq < seq:
                        self.poll_once()
                except Exception:  # noqa: BLE001 — keep serving
                    log.exception("active catchup poll failed")
                finally:
                    self._poll_mutex.release()
            if self._applied_seq >= seq:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return self._applied_seq >= seq
            with self._seq_cond:
                self._seq_cond.wait_for(
                    lambda: self._applied_seq >= seq,
                    min(remaining, 0.02),
                )

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self._interval):
                try:
                    with self._poll_mutex:
                        self.poll_once()
                except Exception:  # noqa: BLE001 — keep the tailer alive
                    log.exception("follower poll failed")

        # initial full replay happens on the first poll (offset 0)
        self.poll_once()
        self._thread = threading.Thread(
            target=loop, name="wal-follower", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def stats(self) -> dict:
        return {
            "follower_applied_seq": self._applied_seq,
            "follower_apply_errors": self._apply_errors,
        }

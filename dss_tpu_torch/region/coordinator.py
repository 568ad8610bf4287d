"""Region coordinator: write-through + tail-poll replication for a store.

The port of the reference's `dss_tpu/region/coordinator.py`.  This is
the piece that makes N DSS instances one region (the role CRDB
replication plays in the upstream DSS, README.md:22-49,
implementation_details.md:11-42).  One coordinator per DSS instance.
On a `cuda` store the tail poller's applies, a rollback's undo records
and a resync's swap of every index all land in the card's DarTables
from whichever thread runs them, under the store lock, as the
reference's land in HBM:

  WRITE PATH (region-serializable, lease-fenced):
    txn() wraps every logical store mutation.  The outermost entry
      1. acquires the region write lease (fencing token),
      2. catches up to the log head (applies remote entries),
      3. runs the local validation + mutation (journal records are
         buffered, not written),
      4. appends the buffered records to the region log as ONE entry
         (the txn's atomic batch) at exactly the local applied index,
      5. advances the applied index, uploads a state snapshot every
         `snapshot_every` entries, and releases the lease.
    Validation therefore always runs against region-current state, and
    the writing instance has read-your-writes (local apply precedes the
    ack).

  ROLLBACK:
    an aborted txn that already journaled records is rolled back
    record-by-record from the per-record "undo" lists the store
    captures (capture_undo) — the reference's txn rollback analog.
    The same rollback covers append failures: a fenced append (batch
    definitely not logged) leaves rolled-back state final; an
    ambiguous network failure (batch MAY have been logged) rolls back
    to the last log-consistent point and the tail poller re-applies
    the batch from the log if it landed.  Either way local state
    converges to the log without a resync; a full resync remains only
    for dirty recovery and falling behind compaction.

  READ PATH (bounded staleness, monotonic):
    a daemon thread tail-polls the log every `poll_interval_s` and
    applies new ENTRIES under the store lock, each entry's records
    together, in log order — a writer's transaction becomes visible as
    a unit (entry = txn batch).  Staleness on a non-writing instance is
    bounded by poll interval + transfer.

  RECOVERY (bounded by snapshots):
    boot/late-join/resync fetch the latest state snapshot + the log
    tail after it, instead of replaying from index 0; the log server
    compacts entries below the snapshot (log_server.put_snapshot).
    Resync fetches everything over the network FIRST and only then
    swaps local state, so a failed resync leaves the previous
    (stale-but-consistent) state serving reads while writes refuse
    with UNAVAILABLE until clean.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.region.client import (
    EpochChanged,
    OptimisticRejected,
    RegionClient,
    RegionError,
    SnapshotRequired,
)

log = logging.getLogger("dss.region")

# warn when a snapshot upload nears the log server's 256 MB body cap
_SNAPSHOT_WARN_BYTES = 192 * 1024 * 1024


class RegionCoordinator:
    def __init__(
        self,
        client: RegionClient,
        rid_store,
        scd_store,
        lock: threading.RLock,
        *,
        poll_interval_s: float = 0.05,
        snapshot_every: int = 512,
        optimistic: bool = True,
        conflict_backoff_s: float = 2.0,
        lease_retain_s: Optional[float] = None,
    ):
        self._client = client
        self._rid = rid_store
        self._scd = scd_store
        self._lock = lock
        self._poll_s = poll_interval_s
        self._snapshot_every = max(int(snapshot_every), 1)
        self._applied = 0  # next log ENTRY index to apply
        self._last_snapshot = 0  # entry index of the last snapshot upload
        self._buffer: Optional[List[dict]] = None  # active txn's records
        self._depth = 0  # txn nesting (guarded by lock)
        self._dirty = False  # local state diverged; resync required
        self._resyncs = 0
        self._rollbacks = 0
        self._optimistic = optimistic
        # conflict cool-down rides the shared jittered policy
        # (chaos/retry.py): `conflict_backoff_s` is now the
        # CAP, the base is a quarter of it, and consecutive conflicts
        # grow the window — so two coordinators that collide once
        # cannot re-collide in lockstep the way the old fixed 2.0 s
        # sleep guaranteed.  A successful optimistic commit resets the
        # growth (the deadline-awareness: cool-downs never outlive the
        # conflict streak that earned them).
        self._conflict_policy = chaos.RetryPolicy(
            base_s=max(1e-3, conflict_backoff_s / 4.0),
            cap_s=max(1e-3, conflict_backoff_s),
            multiplier=2.0,
            jitter=0.5,
        )
        self._conflict_streak = 0
        self._last_conflict_backoff_s = 0.0
        self._lease_only_until = 0.0
        self._opt_commits = 0
        self._opt_conflicts = 0
        # lease retention: back-to-back lease-path
        # txns keep the lease instead of release+reacquire, so the
        # steady conflict-fallback write pays ONE round trip (the
        # append) like the optimistic path.  While we hold the lease
        # nothing else can land (other leases block, optimistic
        # appends are refused "lease_held"), so a retained lease also
        # proves currency — no catch-up fetch.  The tail poller
        # releases after `lease_retain_s` idle, bounding how long a
        # burst's tail can stall another instance's writer; 0 disables.
        if lease_retain_s is None:
            lease_retain_s = float(
                os.environ.get("DSS_REGION_LEASE_RETAIN_S", "0.1")
            )
        self._lease_retain_s = lease_retain_s
        # (token, last_use_monotonic, hard_expiry_monotonic) | None
        self._held_lease = None
        self._lease_reuses = 0
        # per-phase wall time on the write path (ms totals), so the
        # lease-path overhead is attributable round trip by round trip
        self._phase_ms = {
            "lease": 0.0,
            "catchup": 0.0,
            "append": 0.0,
            "release": 0.0,
            "opt_append": 0.0,
        }
        self._lease_txns = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ---------------------------------------------------------------

    @property
    def collecting(self) -> bool:
        return self._buffer is not None

    @property
    def applied(self) -> int:
        return self._applied

    def journal(self, rec: dict) -> None:
        """Buffer one journal record for the active txn's batch append.
        Called by the store's journal hook under the store lock."""
        if self._buffer is None:
            raise errors.internal(
                "region-mode mutation outside a region transaction"
            )
        self._buffer.append(rec)

    def bootstrap(self) -> None:
        """Initial catch-up (snapshot + tail), then start tail polling."""
        with self._lock:
            self._catch_up_locked()
        self._thread = threading.Thread(
            target=self._poll_loop, name="region-tail", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._lock:
            held, self._held_lease = self._held_lease, None
        if held is not None:
            self._client.release_lease(held[0])

    def stats(self) -> dict:
        return {
            "region_applied": self._applied,
            "region_dirty": int(self._dirty),
            "region_resyncs": self._resyncs,
            "region_rollbacks": self._rollbacks,
            "region_optimistic_commits": self._opt_commits,
            "region_optimistic_conflicts": self._opt_conflicts,
            # the last conflict cool-down drawn from the shared policy
            # (the coordinator's analog of region_mirror_backoff_s):
            # nonzero means this instance recently lost a disjointness
            # race and is routing writes through the lease
            "region_conflict_backoff_s": round(
                self._last_conflict_backoff_s, 3
            ),
            # transport-level failover/retry counters (client-side view
            # of mirror failovers and region hiccups)
            "region_failovers": getattr(self._client, "failovers", 0),
            "region_client_retries": getattr(
                self._client, "transport_retries", 0
            ),
            # write-path phase accounting (ms totals; lease-path txns
            # split into their round trips, optimistic txns into one)
            "region_txn_lease_count": self._lease_txns,
            "region_txn_lease_reuses": self._lease_reuses,
            "region_txn_lease_ms_total": round(self._phase_ms["lease"], 3),
            "region_txn_catchup_ms_total": round(
                self._phase_ms["catchup"], 3
            ),
            "region_txn_append_ms_total": round(
                self._phase_ms["append"], 3
            ),
            "region_txn_release_ms_total": round(
                self._phase_ms["release"], 3
            ),
            "region_txn_opt_append_ms_total": round(
                self._phase_ms["opt_append"], 3
            ),
        }

    # -- write-through transaction -------------------------------------------

    @staticmethod
    def _footprint(buf: List[dict]):
        """The txn's cell footprint (ints) from its journal records'
        docs + undo docs, or None when it can't be proven complete.
        Notification bumps are excluded deliberately: increments
        commute, so two disjoint-area txns bumping the same spanning
        subscription serialize correctly in any order."""
        cells = set()
        for rec in buf:
            t = rec.get("t", "")
            if t.endswith("_bump"):
                continue
            got = False
            doc = rec.get("doc")
            if isinstance(doc, dict) and doc.get("cells"):
                cells.update(int(c) for c in doc["cells"])
                got = True
            for u in rec.get("undo", []):
                ud = u.get("doc")
                if isinstance(ud, dict) and ud.get("cells"):
                    cells.update(int(c) for c in ud["cells"])
                    got = True
            if not got:
                return None  # can't bound this record's effect
        return cells

    @contextlib.contextmanager
    def txn(self):
        """Region-serializable transaction (reentrant).  The
        outermost level commits via an OPTIMISTIC disjoint-cell append
        (no lease round trips; disjoint-area writers on different
        instances proceed in parallel — the CRDB per-range write
        analog) and falls back to the single write lease after a
        conflict (lease-only for a cool-down window, since a conflicted
        optimistic txn cannot be revalidated without re-running it)."""
        with self._lock:
            if self._depth:
                self._depth += 1
                try:
                    yield
                finally:
                    self._depth -= 1
                return

            if self._dirty:
                # a previous failure left local state diverged; restore
                # before accepting writes (reads serve the stale-but-
                # consistent previous state meanwhile)
                try:
                    self._resync_locked()
                except RegionError as e:
                    raise self._unavailable(f"region resync: {e}")

            if (
                self._optimistic
                and time.monotonic() >= self._lease_only_until
                and self._held_lease is None
                # a retained lease makes the lease path FREE (zero
                # acquire round trips) while an optimistic append
                # would be rejected "lease_held" by our own lease —
                # prefer the lease until the poller releases it
            ):
                # NO pre-body catch-up round trip: validation runs
                # against local applied state, and the server checks
                # every log entry in [our applied index, head) for cell
                # overlap with this txn's footprint at append time —
                # exactly the window local state might be missing.  A
                # disjoint gap cannot affect validation; an overlapping
                # gap rejects the append and the retry (lease path)
                # catches up first.
                self._depth = 1
                self._buffer = []
                try:
                    yield
                except BaseException:
                    if self._buffer:
                        self._rollback_locked(self._buffer)
                    raise
                finally:
                    buf, self._buffer = self._buffer, None
                    self._depth = 0
                if buf:
                    self._commit_optimistic_locked(buf)
                return

            self._lease_txns += 1
            token = self._take_retained_lease_locked()
            if token is not None:
                # retained from the previous txn: zero acquire round
                # trips, and holding it proves nothing landed since —
                # skip the catch-up fetch too
                head = self._applied
                self._lease_reuses += 1
            else:
                t_ph = time.perf_counter()
                try:
                    token, head = self._client.acquire_lease()
                except EpochChanged:
                    log.warning(
                        "region log epoch changed at lease acquire; "
                        "resyncing before validating this write"
                    )
                    try:
                        self._resync_locked()
                        token, head = self._client.acquire_lease()
                    except RegionError as e:  # incl. a second epoch flip
                        raise self._unavailable(
                            f"region write lease: {e}"
                        )
                except RegionError as e:
                    raise self._unavailable(f"region write lease: {e}")
                finally:
                    self._phase_ms["lease"] += (
                        time.perf_counter() - t_ph
                    ) * 1000
                self._lease_expiry = (
                    time.monotonic() + self._client.lease_ttl_s
                )
            released = False
            try:
                t_ph = time.perf_counter()
                try:
                    if head is None or head > self._applied:
                        # behind the log: fetch + apply the gap.  When
                        # the grant says we're current, skip the fetch
                        # round trip entirely (the lease guarantees
                        # nothing lands meanwhile).
                        self._catch_up_locked()
                except RegionError as e:
                    raise self._unavailable(f"region catch-up: {e}")
                finally:
                    self._phase_ms["catchup"] += (
                        time.perf_counter() - t_ph
                    ) * 1000
                self._depth = 1
                self._buffer = []
                try:
                    yield
                except BaseException:
                    if self._buffer:
                        # mutated locally but nothing was logged: undo
                        # the buffered records (txn rollback)
                        self._rollback_locked(self._buffer)
                    raise
                finally:
                    buf, self._buffer = self._buffer, None
                    self._depth = 0
                if buf:
                    # append in one round trip; retention keeps the
                    # lease for an immediate next lease-path txn, else
                    # the release piggybacks on the append
                    self._commit_locked(token, buf)
                    released = True
            finally:
                if not released:
                    t_ph = time.perf_counter()
                    try:
                        self._client.release_lease(token)
                    finally:
                        self._phase_ms["release"] += (
                            time.perf_counter() - t_ph
                        ) * 1000

    def _unavailable(self, msg: str):
        """503 for a region-path failure, carrying an HONEST
        Retry-After (the client's breaker cooldown) instead of letting
        clients guess — the degradation ladder's REGION_LOG_DOWN
        contract: writes shed with a horizon, reads keep serving."""
        e = errors.unavailable(msg)
        ra = getattr(self._client, "retry_after_s", None)
        e.retry_after_s = ra() if ra is not None else 1.0
        return e

    def _conflict_cooldown_s(self) -> float:
        """Next lease-only cool-down: jittered, exponential in the
        consecutive-conflict streak, capped at conflict_backoff_s."""
        d = self._conflict_policy.backoff_s(self._conflict_streak)
        self._conflict_streak += 1
        self._last_conflict_backoff_s = d
        return d

    def _commit_optimistic_locked(self, buf: List[dict]) -> None:
        wire = [
            {k: v for k, v in rec.items() if k != "undo"} for rec in buf
        ]
        cells = self._footprint(buf)
        if cells is None:
            # can't prove disjointness: roll back and route the retry
            # through the lease for a while
            self._rollback_locked(buf)
            self._lease_only_until = (
                time.monotonic() + self._conflict_cooldown_s()
            )
            e = errors.unavailable(
                "region txn footprint unknown; retry (lease path)"
            )
            e.retryable_write_conflict = True
            raise e
        t_ph = time.perf_counter()
        try:
            idx = self._client.append_optimistic(self._applied, wire, cells)
        except OptimisticRejected as e:
            # definite no-append: roll back, cool down to the lease
            # path (this txn's validation is stale and a txn body can
            # only run once), surface a retryable 503
            self._rollback_locked(buf)
            self._opt_conflicts += 1
            self._lease_only_until = (
                time.monotonic() + self._conflict_cooldown_s()
            )
            err = errors.unavailable(
                f"region write conflict ({e}); rolled back, retry"
            )
            err.retryable_write_conflict = True
            raise err
        except RegionError as e:
            # ambiguous network failure: same convergence story as the
            # lease path (rollback; tail re-applies if it landed)
            self._rollback_locked(buf)
            raise self._unavailable(
                f"region append failed; local txn rolled back "
                f"(re-applied from the log if it landed): {e}"
            )
        finally:
            self._phase_ms["opt_append"] += (
                time.perf_counter() - t_ph
            ) * 1000
        self._opt_commits += 1
        self._conflict_streak = 0  # a landed append ends the streak
        if idx == self._applied:
            self._applied += 1
            return
        # disjoint-cell entries interleaved between our validation
        # point and the append: bring them ALL in (they commute with
        # our local txn), paging until we reach our own entry at idx
        # (which is already applied locally and must be skipped)
        try:
            while self._applied < idx:
                entries, _head = self._client.fetch(self._applied)
                progressed = False
                for i, recs in entries:
                    if self._applied <= i < idx:
                        self._apply_entry_locked(recs)
                        self._applied = i + 1
                        progressed = True
                if not progressed:
                    raise RegionError(
                        f"no progress paging gap entries at "
                        f"{self._applied} (idx {idx})"
                    )
        except RegionError as e:
            # converge via the poller instead: undo ours; the tail
            # applies everything (theirs + ours) in log order
            self._rollback_locked(buf)
            raise self._unavailable(
                f"region interleave fetch failed; rolled back, "
                f"converging via the log: {e}"
            )
        self._applied = idx + 1

    def _take_retained_lease_locked(self):
        """-> a still-safe retained lease token (consumed), else None.
        Safety margin: never reuse within 2s (or 20%) of the TTL —
        an append on an expired token is fenced, forcing the rollback-
        and-converge path for what should be a committed write."""
        held, self._held_lease = self._held_lease, None
        if held is None:
            return None
        token, _last_use, expiry = held
        margin = max(2.0, 0.2 * self._client.lease_ttl_s)
        if time.monotonic() < expiry - margin:
            self._lease_expiry = expiry
            return token
        # too close to expiry to trust: drop it and let the server TTL
        # collect it — no network round trip under the store lock
        return None

    def _release_idle_lease(self) -> None:
        """Poller tick: drop a retained lease once it has sat idle for
        the retention window (bounds how long a finished burst can
        block other instances' writers)."""
        with self._lock:
            held = self._held_lease
            if held is None:
                return
            token, last_use, _expiry = held
            if time.monotonic() - last_use < self._lease_retain_s:
                return
            self._held_lease = None
        self._client.release_lease(token)

    def _commit_locked(self, token: int, buf: List[dict]) -> None:
        # "undo" lists are local rollback state, not region history
        wire = [
            {k: v for k, v in rec.items() if k != "undo"} for rec in buf
        ]
        retain = self._lease_retain_s > 0
        t_ph = time.perf_counter()
        try:
            idx = self._client.append(token, wire, release=not retain)
        except RegionError as e:
            # Fenced (definite no-append) or network error (append
            # MAY have landed): either way, undo the local mutations —
            # local state returns to the last log-consistent point, and
            # if the append did land the tail poller re-applies it from
            # the log.  Converges without a resync in both cases.
            self._rollback_locked(buf)
            raise self._unavailable(
                f"region append failed; local txn rolled back "
                f"(re-applied from the log if it landed): {e}"
            )
        finally:
            self._phase_ms["append"] += (
                time.perf_counter() - t_ph
            ) * 1000
        if idx != self._applied:
            # someone slipped between our catch-up and append — the
            # lease should make this impossible.  The batch IS in the
            # log at idx: undo locally and let the poller apply the
            # intervening entries + ours in log order.
            self._rollback_locked(buf)
            if retain:
                # after the rollback: local consistency must never
                # hinge on a lease-release round trip succeeding
                self._client.release_lease(token)
            raise self._unavailable(
                f"region log order broke (appended at {idx}, expected "
                f"{self._applied}); rolled back, converging via the log"
            )
        self._applied += 1
        if retain:
            # keep the lease warm for an immediately-following
            # lease-path txn (released by the poller after
            # lease_retain_s idle)
            self._held_lease = (
                token, time.monotonic(), self._lease_expiry
            )
        # snapshot upload is poller-driven (_maybe_upload_snapshot):
        # the commit path never pays serialization or HTTP for it

    def _rollback_locked(self, buf: List[dict]) -> None:
        """Undo an aborted txn's journaled records in reverse order.
        Falls back to a full resync only if a record carries no undo
        list (capture_undo disabled — shouldn't happen in region mode)."""
        if not all("undo" in rec for rec in buf):
            log.warning(
                "txn abort without undo info; falling back to resync"
            )
            self._resync_or_mark_dirty()
            return
        for rec in reversed(buf):
            for u in reversed(rec["undo"]):
                self._apply_locked(u)
        self._rollbacks += 1

    def _maybe_upload_snapshot(self) -> None:
        """Poller-driven snapshot: every snapshot_every applied entries,
        serialize state (under the lock — any consistent applied index
        is a valid snapshot point) and upload it OUTSIDE the lock, so
        the user-facing commit path never pays serialization or HTTP
        for compaction.  Best-effort: a failed or rejected upload only
        delays compaction by one interval."""
        if self._applied - self._last_snapshot < self._snapshot_every:
            return
        with self._lock:
            if self._dirty or self.collecting:
                return  # only snapshot log-consistent state
            if self._applied - self._last_snapshot < self._snapshot_every:
                return
            idx = self._applied
            rid_refs = self._rid.snapshot_refs()
            scd_refs = self._scd.snapshot_refs()
        # serialize OUTSIDE the lock: the refs are a consistent cut
        # (records are immutable), so reads/writes never stall behind a
        # 1M-intent JSON dump
        state = {
            "rid": type(self._rid).serialize_refs(rid_refs),
            "scd": type(self._scd).serialize_refs(scd_refs),
        }
        state_json = json.dumps(state, separators=(",", ":"))
        if len(state_json) > _SNAPSHOT_WARN_BYTES:
            log.warning(
                "region snapshot at %d is %.0f MB — approaching the "
                "server's upload cap; compaction may stall if it grows",
                idx, len(state_json) / 1e6,
            )
        try:
            if not self._client.put_snapshot(idx, state_json=state_json):
                log.warning(
                    "region snapshot at %d rejected; backing off one "
                    "interval", idx,
                )
        except RegionError as e:
            log.warning(
                "region snapshot upload at %d failed (%s); backing off "
                "one interval", idx, e,
            )
        finally:
            with self._lock:
                # advance even on failure: back off instead of
                # re-serializing on every poll tick — but never past
                # the CURRENT applied index: a concurrent epoch resync
                # may have rewound it, and a mark above it would
                # suppress snapshots (and compaction) until applied
                # re-passed the stale value
                self._last_snapshot = max(
                    self._last_snapshot, min(idx, self._applied)
                )

    # -- apply / resync (store lock held) ------------------------------------

    def _apply_locked(self, rec: dict) -> None:
        t = rec.get("t", "")
        if t.startswith("isa") or t.startswith("rid"):
            self._rid.apply_wal(rec)
        else:
            self._scd.apply_wal(rec)

    def _apply_entry_locked(self, recs: List[dict]) -> None:
        for rec in recs:
            self._apply_locked(rec)

    def _restore_snapshot_locked(self, index: int, state: dict) -> None:
        self._rid.restore_state(state.get("rid", {}))
        self._scd.restore_state(state.get("scd", {}))
        self._applied = index
        self._last_snapshot = index

    def _catch_up_locked(self) -> None:
        while True:
            try:
                entries, head = self._client.fetch(self._applied)
            except SnapshotRequired:
                snap = self._client.get_snapshot()
                if snap is None:
                    raise RegionError(
                        "log compacted but no snapshot available"
                    )
                self._restore_snapshot_locked(*snap)
                continue
            except EpochChanged:
                # the log server rebooted (possibly having regressed):
                # writes must not validate against diverged local
                # state — adopt the log's truth, then finish catching
                # up against the new epoch
                log.warning(
                    "region log epoch changed during catch-up; "
                    "resyncing"
                )
                self._resync_locked()
                continue
            for idx, recs in entries:
                if idx >= self._applied:
                    self._apply_entry_locked(recs)
                    self._applied = idx + 1
            if self._applied >= head:
                return

    def _resync_locked(self) -> None:
        """Rebuild local state from snapshot + tail.  All network
        fetches happen BEFORE any local state is touched, so a region
        outage mid-resync leaves the previous state intact (reads stay
        consistent; writes refuse while dirty)."""
        self._resyncs += 1
        log.warning("region resync: fetching snapshot + log tail")
        # resync rebuilds from the log's CURRENT truth: accept its
        # epoch so the fetches below don't re-raise EpochChanged
        self._client.adopt_epoch()
        snap = None
        start = 0
        try:
            fetched: List[Tuple[int, List[dict]]] = []
            try:
                entries, head = self._client.fetch(start)
            except SnapshotRequired:
                snap = self._client.get_snapshot()
                if snap is None:
                    raise RegionError(
                        "log compacted but no snapshot available"
                    )
                start = snap[0]
                entries, head = self._client.fetch(start)
            while True:
                fetched.extend(entries)
                nxt = (
                    fetched[-1][0] + 1 if fetched else start
                )
                if nxt >= head:
                    break
                entries, head = self._client.fetch(nxt)
        except RegionError:
            self._dirty = True
            raise
        # network done — swap state locally (no I/O below).  Any
        # failure mid-swap (e.g. a corrupt snapshot doc) leaves the
        # store wiped/partial, so it MUST mark dirty: writes refuse and
        # the poller keeps retrying the resync.
        try:
            self._rid.reset_state()
            self._scd.reset_state()
            self._applied = 0
            if snap is not None:
                self._restore_snapshot_locked(*snap)
            for idx, recs in fetched:
                if idx >= self._applied:
                    self._apply_entry_locked(recs)
                    self._applied = idx + 1
        except Exception:
            self._dirty = True
            raise
        self._dirty = False
        # a regressed log can leave the old (higher) snapshot mark in
        # place, which would suppress snapshot uploads — and therefore
        # log compaction — until _applied re-passed it
        self._last_snapshot = min(self._last_snapshot, self._applied)

    def _resync_or_mark_dirty(self) -> None:
        try:
            self._resync_locked()
        except RegionError as e:
            # region unreachable: previous state keeps serving reads
            # (stale but consistent); writes refuse until the tail
            # poller completes a resync
            log.error("region resync failed (%s); marking dirty", e)

    # -- tail poller ----------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self._release_idle_lease()
                self._maybe_upload_snapshot()
                if self._dirty:
                    with self._lock:
                        if self._dirty:
                            self._resync_locked()
                    continue
                # fetch over HTTP without the lock; the idx guard under
                # the lock drops anything applied concurrently
                try:
                    entries, _head = self._client.fetch(self._applied)
                except (SnapshotRequired, EpochChanged) as e:
                    # behind compaction -> snapshot restore; OR the
                    # log server rebooted and may have REGRESSED (lost
                    # acked-but-unsynced entries in a crash, or an
                    # operator restored an older WAL) — the epoch
                    # nonce is the detection mechanism, since index
                    # comparisons can miss a regression once new
                    # writes push the head back past our cursor.
                    # Either way: adopt the log's truth via resync.
                    if isinstance(e, EpochChanged):
                        log.warning(
                            "region log epoch changed; resyncing to "
                            "the log's state"
                        )
                    with self._lock:
                        self._resync_locked()
                    continue
                if not entries:
                    continue
                with self._lock:
                    for idx, recs in entries:
                        if idx >= self._applied:
                            self._apply_entry_locked(recs)
                            self._applied = idx + 1
            except RegionError:
                continue  # transient; next tick retries
            except Exception:  # noqa: BLE001 — keep the poller alive
                log.exception("region tail poller error")

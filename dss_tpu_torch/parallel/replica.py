"""ShardedDar refresh: tail a durable log into serving multi-device
read replicas — one per entity class.

The port of the reference's `dss_tpu/parallel/replica.py`.  SURVEY §7 step
7 (second half): writes land in the single-device store + WAL; this
replica tails that log and
periodically folds each entity class (SCD operations, RID ISAs, RID
subscriptions, SCD subscriptions) into a fresh `ShardedDar` snapshot on
the device mesh, swapping it in atomically for readers — the same
source-of-truth/read-replica split the reference gets from CRDB ranges
(implementation_details.md:11-42, where range sharding covers EVERY
table).

Consistency: readers grab ONE class snapshot reference per query, so a
query always runs against a complete snapshot — concurrent refreshes
are invisible until their atomic swap.  Staleness is bounded by the
poll interval + rebuild time and exposed via stats.

Refreshes ship TIER DELTAS, not full tables (mirroring the DarTable
tier stack, dar/tiers.py): each class keeps a large, rarely
rebuilt BASE ShardedDar plus a small DELTA ShardedDar holding the
records written since the base was built, with a shadow set hiding
base copies superseded or deleted since.  A routine refresh rebuilds
only the delta dar — O(churn), not O(table) — and a major rebuild
(full repack) runs only when the churn ratio crosses the same
DSS_TIER_RATIO policy the DarTable uses.

Sources (exactly one):
  - `wal_path`: tail a standalone server's WriteAheadLog file
    incrementally (remembers the byte offset, only consumes whole
    lines, tolerates a torn tail write until the next poll);
  - `region_client`: fetch entries from a region log server
    (`_RegionTail`: snapshot + tail, rebuilt wholesale when the log's
    epoch changes).

On a card, a rebuild's host->device copies finish (its stream is
synchronized, `ShardedDar`) before the atomic swap publishes the
snapshot, so a reader on any stream sees whole postings; the copies
come from registered host memory (one copy a device: `ShardedDar`),
never from pinned blocks of PyTorch's caching host allocator.  A
replica keeps one such staging buffer (`Staging`) for all its folds.
It grows to the largest dar built so far, a major fold's whole base
tier (about 93 MB for 1M corridor intents of 8 cells each, where a
minor fold of 18,432 records takes 1.7 MB of it), and stays page-locked
for the replica's life.

With tracing on (`obs/trace.py`), the write path records, wherever its
tail and folds run (the background loop, or a caller's `sync()`):

    replica.poll          poll_once: the log's new records applied
                          attrs: records, errors (records that failed)
    replica.plan          plan_rebalance's scan (every key of every
                          class concatenated and sorted), when the
                          move-interval rate limit lets it run
    replica.refresh       one class's fold
                          attrs: cls, major (0: the delta tier only),
                          records, bytes (the dar built)
      dar.pack            ShardedDar: pack_records, shard_postings
      dar.upload          the copies to the cards, K1's entity rows,
                          until the copies are complete
      replica.warm        the warm searches of the new dar (their own
                          mesh.* phases beneath)

`stats()` (and so `/metrics`) counts the folds' cost beside
`replica_delta_refreshes` and `replica_major_rebuilds`:
`replica_fold_h2d_bytes` (host->device bytes of every dar built, the
sum of their `nbytes`) and `replica_minor_fold_records` (the records
the minor folds built).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from dss_tpu_torch.clock import to_nanos
from dss_tpu_torch.dar import codec
from dss_tpu_torch.dar import oracle
from dss_tpu_torch.dar import tiers as tiersmod
from dss_tpu_torch.dar import wal as _walmod
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.obs import trace as _trace
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu_torch.parallel.sharded import (
    ShardedDar,
    Staging,
    imbalance_factor,
    shard_of_keys,
    weighted_boundaries,
)

log = logging.getLogger("dss.replica")


def env_rebalance_ratio() -> float:
    """DSS_SHARD_REBALANCE_RATIO: the hysteresis threshold — boundary
    moves happen only when predicted per-shard load imbalance
    (max/mean) exceeds this.  <= 1 disables rebalancing (static
    equal-count placement, the pre-r07 behavior)."""
    try:
        return float(os.environ.get("DSS_SHARD_REBALANCE_RATIO", 1.5))
    except ValueError:
        raise ValueError(
            "DSS_SHARD_REBALANCE_RATIO="
            f"{os.environ['DSS_SHARD_REBALANCE_RATIO']!r} is not a float"
        )


def env_move_interval_s() -> float:
    """DSS_SHARD_MOVE_INTERVAL_S: the move-rate cap — at most one
    boundary move per interval, so rebalance-forced major folds can
    never starve serving."""
    try:
        return float(os.environ.get("DSS_SHARD_MOVE_INTERVAL_S", 5.0))
    except ValueError:
        raise ValueError(
            "DSS_SHARD_MOVE_INTERVAL_S="
            f"{os.environ['DSS_SHARD_MOVE_INTERVAL_S']!r} is not a float"
        )

# entity classes the replica serves (replica class name -> WAL prefix)
CLASSES = ("ops", "isas", "rid_subs", "scd_subs", "constraints")


class _ClsSnap(NamedTuple):
    """One class's published snapshot: base + delta tier dars.  A base
    id in `shadow` is superseded (its current version lives in the
    delta dar) or deleted — queries drop it, so the newest tier wins."""

    base: Optional[ShardedDar]
    base_ids: List[str]
    shadow: frozenset  # base entity_ids hidden by newer state
    delta: Optional[ShardedDar]
    delta_ids: List[str]

    @property
    def live_records(self) -> int:
        return len(self.base_ids) - len(self.shadow) + len(self.delta_ids)


class _WalTail:
    """Incremental reader of a WriteAheadLog file (JSON lines).
    The first record is checked against the supported log format
    (the same boot gate as WriteAheadLog.replay)."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._checked_head = False

    @property
    def position(self) -> int:
        """Consumed byte offset — the multihost refresh-cut currency
        (every process tails the same log; identical offsets mean
        identical record prefixes)."""
        return self._offset

    def at_end(self) -> bool:
        """True when everything durably appended has been consumed —
        the read-your-writes gate for mesh offload (a committed write
        reaches the WAL before its HTTP response)."""
        try:
            return os.path.getsize(self.path) <= self._offset
        except OSError:
            return not os.path.exists(self.path)

    def poll(self, limit: Optional[int] = None) -> List[dict]:
        """`limit` stops consumption at that byte offset (a follower
        tailing to the leader's broadcast cut, never past it)."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "r", encoding="utf-8") as fh:
            fh.seek(self._offset)
            while True:
                pos = fh.tell()
                if limit is not None and pos >= limit:
                    break
                line = fh.readline()
                if not line:
                    break
                if not line.endswith("\n"):
                    # torn tail write: re-read from here next poll
                    fh.seek(pos)
                    break
                line = line.strip()
                if not line:
                    self._offset = fh.tell()
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # torn write that still got a newline: stop here
                    # and retry next poll
                    fh.seek(pos)
                    break
                if not self._checked_head and pos == 0:
                    _walmod.check_format_record(rec, self.path)
                    self._checked_head = True
                    # the head is log metadata, not a data record:
                    # validated here, never surfaced to the applier
                    if rec.get("t") == _walmod.FORMAT_RECORD_TYPE:
                        self._offset = fh.tell()
                        continue
                out.append(rec)
                self._offset = fh.tell()
        return out


def _keys_of(cells) -> np.ndarray:
    return np.unique(
        s2cell.cell_to_dar_key(np.asarray(cells, dtype=np.uint64))
    ).astype(np.int32)


class _RegionTail:
    """Incremental reader of a region log (batch entries)."""

    def __init__(self, client):
        self.client = client
        self._applied = 0
        self.errors = 0  # consecutive fetch failures (operability)
        self.caught_up = False  # reached head at the last poll

    @property
    def position(self) -> int:
        """Next log entry index to apply (the reference's multihost
        refresh-cut currency in region mode)."""
        return self._applied

    def at_end(self) -> bool:
        """Best-effort: head reached at the LAST poll.  Region-mode
        reads are bounded-stale by design (non-writing instances serve
        tail-poll state), so mesh offload matches that contract rather
        than strict read-your-writes."""
        return self.caught_up

    def poll(self, limit: Optional[int] = None) -> List[dict]:
        from dss_tpu_torch.region.client import (
            EpochChanged,
            RegionError,
            SnapshotRequired,
        )

        out = []
        try:
            while True:
                try:
                    entries, head = self.client.fetch(self._applied)
                    self.errors = 0
                except SnapshotRequired:
                    snap = self.client.get_snapshot()
                    if snap is None:
                        return out
                    idx, state = snap
                    # the snapshot carries full docs: replace local
                    # state wholesale, then resume tailing after it
                    out.append({"t": "__replica_reset__", "state": state})
                    self._applied = idx
                    continue
                except EpochChanged:
                    # the log server rebooted and may have regressed
                    # (lost unsynced acked entries, or an older WAL
                    # restored): our incrementally-applied state may
                    # contain entries the reborn log never will —
                    # rebuild wholesale from the log's truth instead
                    # of silently skipping new entries
                    log.warning(
                        "replica: region log epoch changed; rebuilding"
                    )
                    # fetch the rebuild material FIRST: adopting the
                    # epoch before a failed get_snapshot would silence
                    # the regression forever (no dirty flag here — the
                    # next poll must re-raise EpochChanged until the
                    # reset actually happens)
                    snap = self.client.get_snapshot()
                    self.client.adopt_epoch()
                    if snap is not None:
                        idx, state = snap
                        out.append(
                            {"t": "__replica_reset__", "state": state}
                        )
                        self._applied = idx
                    else:
                        out.append(
                            {"t": "__replica_reset__", "state": {}}
                        )
                        self._applied = 0
                    continue
                for idx, recs in entries:
                    if idx >= self._applied and (
                        limit is None or idx < limit
                    ):
                        out.extend(recs)
                        self._applied = idx + 1
                if limit is not None and self._applied >= limit:
                    return out
                if self._applied >= head:
                    self.caught_up = True
                    return out
                self.caught_up = False
        except RegionError as e:
            # transient (next poll retries) — but a replica cut off
            # from the region must be VISIBLY stale, not silently so
            self.errors += 1
            self.caught_up = False
            log.warning(
                "replica region tail failed (%d consecutive): %s",
                self.errors, e,
            )
            return out


class ShardedReplica:
    """Multi-device read replica of EVERY entity class on a ("dp",
    "sp") mesh, refreshed from a WAL or region-log tail."""

    def __init__(
        self,
        mesh,
        *,
        wal_path: Optional[str] = None,
        region_client=None,
        max_results: int = 512,
        shard_results: Optional[int] = None,
        warm_batches=(1,),
        tier_ratio: Optional[float] = None,  # None = DSS_TIER_RATIO env
        load: Optional[tiersmod.RangeLoad] = None,
        rebalance_ratio: Optional[float] = None,  # None = env
        move_interval_s: Optional[float] = None,  # None = env
        capacity_weights=None,  # per-sp-shard host capacity vector
        #   (weighted_boundaries member_capacity; assembled from the
        #   member hosts' autotune profiles' capacity_weight scalars);
        #   None = homogeneous members, the historical split
    ):
        if (wal_path is None) == (region_client is None):
            raise ValueError("exactly one of wal_path / region_client")
        self.mesh = mesh
        self.max_results = max_results
        if shard_results is None:
            # autotune-profile seam: DSS_SHARD_RESULTS carries the
            # measured per-shard result capacity base (plan/autotune
            # measure_hit_concentration); unset keeps the legacy
            # max_results-sized default
            raw = os.environ.get("DSS_SHARD_RESULTS", "")
            shard_results = int(raw) if raw else None
        self.shard_results = shard_results
        # boundary-aware autotuned capacity (leader-computed at each
        # boundary move from the post-rebalance predicted per-shard
        # load, broadcast with the move): what builds actually use.
        # None = no move yet, the configured base stands.
        self.shard_results_effective: Optional[int] = None
        if capacity_weights is None:
            self.capacity_weights = None
        else:
            cw = np.asarray(capacity_weights, np.float64).ravel()
            # reject bad vectors HERE, not at some later fold: a zero
            # entry would otherwise surface as inf imbalance + a
            # ValueError from inside the leader's serving sync path
            if not np.all(np.isfinite(cw)) or not np.all(cw > 0):
                raise ValueError(
                    "capacity_weights entries must be finite and > 0"
                )
            self.capacity_weights = cw
        self._tier_ratio = (
            tiersmod.env_policy().ratio
            if tier_ratio is None
            else float(tier_ratio)
        )
        # -- skew-aware placement state ---------------------------------------
        # measured query load per key range; server mode swaps in the
        # store's shared instance (use_load) so coalescer-served
        # traffic drives the same map the splitter consumes
        self.load = load if load is not None else tiersmod.RangeLoad()
        self.rebalance_ratio = (
            env_rebalance_ratio()
            if rebalance_ratio is None
            else float(rebalance_ratio)
        )
        self.move_interval_s = (
            env_move_interval_s()
            if move_interval_s is None
            else float(move_interval_s)
        )
        # the published boundary map (None = equal-count split) and
        # its generation — the currency a multihost leader broadcasts
        # with the fold cut so every process splits identically
        self.boundaries: Optional[np.ndarray] = None
        # boundary_gen is the LOCKSTEP currency (compared against the
        # leader's broadcast bgen; reset to 0 by a reform on every
        # process so joiners and incumbents agree); boundary_moves is
        # the monotonic operator gauge and never resets
        self.boundary_gen = 0
        self.boundary_moves = 0
        self.moved_bytes = 0
        self._imbalance = 1.0  # predicted under current boundaries
        # -inf so the FIRST justified move is never rate-capped (a
        # fresh boot's monotonic clock can be younger than the cap)
        self._last_move = float("-inf")
        self._last_decay = float("-inf")
        self._last_plan = float("-inf")
        self._force_major: Dict[str, bool] = {c: False for c in CLASSES}
        # per-shard measured hits absorbed from retired dars (the live
        # dars' counters reset on every rebuild swap)
        self._shard_hits_total = np.zeros(
            mesh.shape["sp"], np.int64
        )
        # batch sizes to warm per rebuild (the reference's pow2 jit
        # buckets; here each runs the new dar once, so the first
        # oversized batch after a swap finds its torch kernels loaded)
        self.warm_batches = tuple(warm_batches)
        self._tail = (
            _WalTail(wal_path) if wal_path else _RegionTail(region_client)
        )
        self._records: Dict[str, Dict[str, Record]] = {
            c: {} for c in CLASSES
        }
        # tier bookkeeping per class: ids inside the published base
        # dar (membership only — the records themselves stay in
        # self._records), records newer than it, and base ids to hide
        self._base: Dict[str, set] = {c: set() for c in CLASSES}
        self._delta: Dict[str, Dict[str, Record]] = {c: {} for c in CLASSES}
        self._shadow: Dict[str, set] = {c: set() for c in CLASSES}
        self._owners: Dict[str, int] = {}
        self._dirty = {c: False for c in CLASSES}
        self._gen = {c: 0 for c in CLASSES}  # tail-applied write gen
        self._mu = threading.Lock()  # guards records + tail + rebuild
        # serializes whole refresh() runs: publish order must match
        # build order (the warmup happens outside _mu, so without this
        # a slower older build could overwrite a newer snapshot)
        self._refresh_mu = threading.Lock()
        self._snapshots: Dict[str, Optional[_ClsSnap]] = {
            c: None for c in CLASSES
        }
        self._applied_records = 0
        self._apply_errors = 0
        # per class: searches answered, slots decoded over every tier
        # (before the shadow drop), base ids the shadow dropped; the
        # coalescer and the fronts query from several threads
        self._served = {c: [0, 0, 0] for c in CLASSES}
        self._served_mu = threading.Lock()
        # host->device bytes materialized by snapshot builds (per-host
        # refresh traffic: on a multi-host mesh this is what each
        # process ships to its addressable shards per refresh)
        self.device_bytes_built = 0
        # the page-locked buffer every dar build's upload goes through,
        # registered once (builds run one at a time, under _refresh_mu)
        self._staging = Staging()
        self._rebuilds = 0
        self._delta_refreshes = 0
        self._minor_fold_records = 0  # records the minor folds built
        self._major_rebuilds = 0
        self._warm_ms_total = 0.0  # publish-gating warm time per
        #                            rebuild
        self._last_fresh = 0.0  # monotonic time of last caught-up sync
        # -- demand-paced refresh ----------------------------------------------
        # The dar rebuild + publish-gating warm is the expensive half
        # of a sync tick; on a small host it can eat a third of total
        # serving capacity keeping a mesh replica fresh that no query
        # is using.  The background loop therefore always applies the
        # cheap tail (writes keep accumulating), but only rebuilds
        # while a mesh-shaped batch has consulted fresh() within the
        # pace window (or during the boot grace, so the first demanded
        # query finds a warm replica).  An idle replica goes stale by
        # construction, fresh() then steers the planner local, and the
        # SAME fresh() probe is the demand signal that resumes
        # rebuilding — one or two ticks later the mesh route is warm
        # again.  Pace <= 0 restores the historical always-rebuild
        # loop (multihost lockstep never runs this loop and is
        # unaffected).
        raw_pace = os.environ.get("DSS_REPLICA_DEMAND_PACE_S", "")
        self.demand_pace_s = float(raw_pace) if raw_pace else 10.0
        self._demand_last = 0.0
        self._started_at = 0.0
        self._refresh_skips = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ingest ---------------------------------------------------------------

    def _intern(self, owner: str) -> int:
        return self._owners.setdefault(owner, len(self._owners))

    def _rec_from_op_doc(self, doc: dict) -> Record:
        op = codec.doc_to_op(doc)
        return Record(
            entity_id=op.id,
            keys=_keys_of(op.cells),
            alt_lo=(
                -np.inf if op.altitude_lower is None else float(op.altitude_lower)
            ),
            alt_hi=(
                np.inf if op.altitude_upper is None else float(op.altitude_upper)
            ),
            t_start=to_nanos(op.start_time),
            t_end=to_nanos(op.end_time),
            owner_id=self._intern(op.owner),
        )

    def _rec_from_entity(self, ent) -> Record:
        """ISA / RID sub / SCD sub share the cells + altitude_lo/hi +
        start/end field shape."""
        return Record(
            entity_id=ent.id,
            keys=_keys_of(ent.cells),
            alt_lo=(
                -np.inf if ent.altitude_lo is None else float(ent.altitude_lo)
            ),
            alt_hi=(
                np.inf if ent.altitude_hi is None else float(ent.altitude_hi)
            ),
            t_start=(
                NO_TIME_LO if ent.start_time is None
                else to_nanos(ent.start_time)
            ),
            t_end=(
                NO_TIME_HI if ent.end_time is None
                else to_nanos(ent.end_time)
            ),
            owner_id=self._intern(ent.owner),
        )

    def _put(self, cls: str, rec: Record) -> None:
        self._records[cls][rec.entity_id] = rec
        if rec.entity_id in self._base[cls]:
            self._shadow[cls].add(rec.entity_id)  # newer than base
        self._delta[cls][rec.entity_id] = rec
        self._dirty[cls] = True
        # per-class write generation: tail application IS the replica's
        # write path, so the freshness surface (/status, stats) can
        # compare replica generations against the primary's cell-clock
        # generations when verifying fence behaviour
        self._gen[cls] += 1

    def _del(self, cls: str, eid: str) -> None:
        if self._records[cls].pop(eid, None) is not None:
            self._delta[cls].pop(eid, None)
            if eid in self._base[cls]:
                self._shadow[cls].add(eid)
            self._dirty[cls] = True
            self._gen[cls] += 1

    def _apply_locked(self, rec: dict) -> None:
        t = rec.get("t", "")
        if t == "__replica_reset__":
            # build the replacement off to the side and swap only once
            # every doc parsed: a corrupt doc mid-snapshot must not
            # leave truncated state serving as complete
            state = rec["state"]
            fresh: Dict[str, Dict[str, Record]] = {c: {} for c in CLASSES}
            for d in state.get("scd", {}).get("ops", []):
                r = self._rec_from_op_doc(d)
                fresh["ops"][r.entity_id] = r
            for d in state.get("scd", {}).get("subs", []):
                r = self._rec_from_entity(codec.doc_to_scd_sub(d))
                fresh["scd_subs"][r.entity_id] = r
            for d in state.get("rid", {}).get("isas", []):
                r = self._rec_from_entity(codec.doc_to_isa(d))
                fresh["isas"][r.entity_id] = r
            for d in state.get("rid", {}).get("subs", []):
                r = self._rec_from_entity(codec.doc_to_rid_sub(d))
                fresh["rid_subs"][r.entity_id] = r
            # absent on pre-constraint snapshots (rolling upgrade)
            for d in state.get("scd", {}).get("constraints", []):
                r = self._rec_from_op_doc(d)
                fresh["constraints"][r.entity_id] = r
            self._records = fresh
            for c in CLASSES:
                # wholesale replacement invalidates the tier split: the
                # next refresh of each class is a major rebuild
                self._base[c] = set()
                self._delta[c] = {}
                self._shadow[c] = set()
                self._dirty[c] = True
                self._gen[c] += 1
        elif t == "scd_op_put":
            self._put("ops", self._rec_from_op_doc(rec["doc"]))
        elif t == "scd_op_del":
            self._del("ops", rec["id"])
        elif t == "isa_put":
            self._put(
                "isas", self._rec_from_entity(codec.doc_to_isa(rec["doc"]))
            )
        elif t == "isa_del":
            self._del("isas", rec["id"])
        elif t == "rid_sub_put":
            self._put(
                "rid_subs",
                self._rec_from_entity(codec.doc_to_rid_sub(rec["doc"])),
            )
        elif t == "rid_sub_del":
            self._del("rid_subs", rec["id"])
        elif t == "scd_sub_put":
            self._put(
                "scd_subs",
                self._rec_from_entity(codec.doc_to_scd_sub(rec["doc"])),
            )
        elif t == "scd_sub_del":
            self._del("scd_subs", rec["id"])
        elif t == "scd_cst_put":
            # constraint docs share the op doc's spatial field shape
            # (altitude_lower/upper, start/end, cells)
            self._put("constraints", self._rec_from_op_doc(rec["doc"]))
        elif t == "scd_cst_del":
            self._del("constraints", rec["id"])
        # rid_sub_bump / scd_sub_bump only touch notification indexes,
        # which the spatial replica does not serve
        self._applied_records += 1

    def tail_position(self) -> int:
        """The tail's consumed position (WAL byte offset / region
        entry index) — the multihost refresh-cut currency."""
        return self._tail.position

    def state_fingerprint(self) -> dict:
        """Cheap per-class divergence detector for lockstep folds:
        processes that consumed the same log prefix MUST agree on
        these counts before issuing the fold's collectives (a
        divergent fold would build different array shapes and wedge or
        corrupt the mesh)."""
        with self._mu:
            return {
                "applied": self._applied_records,
                "apply_errors": self._apply_errors,
                "classes": {
                    c: [
                        len(self._records[c]),
                        len(self._delta[c]),
                        len(self._shadow[c]),
                        len(self._base[c]),
                    ]
                    for c in CLASSES
                },
            }

    def poll_once(self, limit: Optional[int] = None) -> int:
        """Ingest any new log records; -> number applied.  One record
        that fails to apply (version skew, corrupt doc) is skipped and
        counted — it must not drop the rest of its batch (the tail
        cursor has already advanced past it).

        With tracing on, a `replica.poll` span covers the call, with
        the records read and the ones that failed to apply."""
        with _trace.span("replica.poll") as sp, self._mu:
            errors = self._apply_errors
            recs = self._tail.poll(limit=limit)
            for rec in recs:
                try:
                    self._apply_locked(rec)
                except Exception:  # noqa: BLE001 — isolate bad records
                    self._apply_errors += 1
                    log.exception(
                        "replica failed to apply record %r; skipped",
                        rec.get("t"),
                    )
            if sp.span_id is not None:
                sp.set(records=len(recs),
                       errors=self._apply_errors - errors)
            return len(recs)

    # -- skew-aware placement -------------------------------------------------

    def use_load(self, load: tiersmod.RangeLoad) -> None:
        """Adopt a shared RangeLoad (the store's, in server mode) so
        coalescer-served traffic and replica-served traffic accumulate
        into ONE map."""
        self.load = load

    def note_query_load(self, keys, work: float) -> None:
        self.load.record(keys, work)

    def _all_posting_keys(self) -> np.ndarray:
        """Sorted concatenation of every class's record keys — the
        postings population the splitter plans over (classes share one
        S2 key space and one boundary map)."""
        with self._mu:
            parts = [
                r.keys
                for recs in self._records.values()
                for r in recs.values()
            ]
        if not parts:
            return np.zeros(0, np.int32)
        return np.sort(np.concatenate(parts).astype(np.int32))

    def _predicted_shard_loads(
        self, keys: np.ndarray, w: np.ndarray, boundaries
    ) -> np.ndarray:
        n_sp = self.mesh.shape["sp"]
        loads = np.zeros(n_sp, np.float64)
        if not len(keys):
            return loads
        if boundaries is None:
            # equal-count split: contiguous index ranges
            ps = max((len(keys) + n_sp - 1) // n_sp, 8)
            for i in range(n_sp):
                loads[i] = w[i * ps : (i + 1) * ps].sum()
        else:
            np.add.at(loads, shard_of_keys(keys, boundaries, n_sp), w)
        return loads

    def plan_rebalance(self, now: Optional[float] = None) -> bool:
        """Evaluate the measured load map against the current split
        and move the boundaries when the hot spot justifies it.
        Leader-side only (multihost followers APPLY broadcast
        boundaries, never plan).  -> True when boundaries moved.

        Hysteresis: no move unless predicted imbalance (max/mean
        per-shard load) exceeds `rebalance_ratio`.  Move-rate cap: at
        most one move per `move_interval_s`.  A move forces a major
        rebuild of every class at the NEXT fold — the cost an operator
        trades for spreading the hot range.

        With tracing on, a `replica.plan` span covers each planning
        scan that the rate limit lets through."""
        t = time.monotonic() if now is None else now
        # the whole planning scan (concat+sort of every class's keys)
        # is rate-limited to the move cadence: a 0.5s refresh loop
        # must not pay an O(total postings) sort per tick just to
        # re-learn that the split is still balanced
        if t - max(self._last_plan, self._last_move) < self.move_interval_s:
            return False
        self._last_plan = t
        with _trace.span("replica.plan"):
            return self._plan(t)

    def _plan(self, t: float) -> bool:
        """plan_rebalance's scan at monotonic time `t`, past its rate
        limit."""
        # decay runs even with rebalancing disabled: the load map (and
        # its gauges) must not grow without bound under a static split
        if t - self._last_decay >= self.move_interval_s:
            self.load.decay()
            self._last_decay = t
        if self.rebalance_ratio <= 1.0:
            return False
        if self.load.total() <= 0:
            self._imbalance = 1.0
            return False
        keys = self._all_posting_keys()
        if not len(keys):
            self._imbalance = 1.0
            return False
        w = self.load.weights_for(keys)
        n_sp = self.mesh.shape["sp"]
        cap = self.capacity_weights
        if cap is not None and len(cap) != n_sp:
            # mesh reshaped under an old capacity vector (reform /
            # degrade): heterogeneity no longer maps — fall back to
            # homogeneous rather than split against the wrong hosts
            cap = None
        cur = self._predicted_shard_loads(keys, w, self.boundaries)
        # hysteresis on CAPACITY-NORMALIZED load: a slow host at its
        # (lighter) target is balanced, not a hot spot
        self._imbalance = imbalance_factor(
            cur if cap is None else cur / cap
        )
        if self._imbalance <= self.rebalance_ratio:
            return False
        new_b = weighted_boundaries(keys, w, n_sp, member_capacity=cap)
        if new_b is None or (
            self.boundaries is not None
            and np.array_equal(new_b, self.boundaries)
        ):
            return False
        # move accounting: postings whose shard assignment changed
        # (key+slot int32 pairs — the per-host re-ship upper bound)
        old_shard = (
            shard_of_keys(keys, self.boundaries, n_sp)
            if self.boundaries is not None
            else self._equal_count_shards(len(keys), n_sp)
        )
        moved = int(
            (old_shard != shard_of_keys(keys, new_b, n_sp)).sum()
        )
        self.moved_bytes += moved * 8
        self.boundaries = new_b
        self.boundary_gen += 1
        self.boundary_moves += 1
        self._last_move = t
        # boundary-aware result-capacity autotune: size the per-shard
        # result slots from the POST-rebalance predicted per-shard
        # load (recomputed only at moves — the value ships with the
        # boundary broadcast, so every lockstep process builds the
        # same shapes)
        self.shard_results_effective = self._auto_shard_results(
            keys, w, new_b
        )
        with self._mu:
            for c in CLASSES:
                self._force_major[c] = True
                self._dirty[c] = True
        log.info(
            "shard rebalance #%d: imbalance %.2f > %.2f, %d postings "
            "move (%d B)",
            self.boundary_moves, self._imbalance, self.rebalance_ratio,
            moved, moved * 8,
        )
        return True

    def _auto_shard_results(
        self, keys: np.ndarray, w: np.ndarray, boundaries
    ) -> Optional[int]:
        """Boundary-aware per-shard result capacity (the skew-aware
        follow-up): the configured `shard_results` is the
        BALANCED-load budget (e.g. the autotune profile's measured
        hit-concentration base).  When the predicted per-shard load
        share concentrates — exactly what a boundary move produces
        when it isolates a hot range into one narrow shard — a query
        over the hot range draws most of its hits from that one
        shard, and a flat constant re-opens the result-slot
        overflow -> exact-scan fallback the rebalance was meant to
        kill.  Capacity therefore rises toward max_results in
        proportion to the hottest shard's predicted load share (2x
        safety), and never drops below the configured base.  Returns
        None when no raise applies (unset base, or base already at
        max_results)."""
        base = self.shard_results
        if base is None or base >= self.max_results:
            return None
        loads = self._predicted_shard_loads(keys, w, boundaries)
        total = float(loads.sum())
        if total <= 0:
            return None
        share = float(loads.max()) / total
        need = int(np.ceil(self.max_results * min(1.0, 2.0 * share)))
        return int(min(self.max_results, max(base, need)))

    def _build_shard_results(self) -> Optional[int]:
        """What ShardedDar builds actually use: the boundary-aware
        effective capacity when a move computed one, else the
        configured base."""
        return (
            self.shard_results
            if self.shard_results_effective is None
            else self.shard_results_effective
        )

    @staticmethod
    def _equal_count_shards(n: int, n_sp: int) -> np.ndarray:
        ps = max((n + n_sp - 1) // n_sp, 8)
        return np.minimum(
            np.arange(n, dtype=np.int64) // ps, n_sp - 1
        ).astype(np.int32)

    def apply_boundaries(self, boundaries, bgen: int,
                         shard_results: Optional[int] = None) -> None:
        """Adopt a leader-broadcast boundary map (multihost follower
        path): the split — and the boundary-aware result capacity the
        leader sized from the post-rebalance predicted load — is
        applied verbatim, no local planning, so every process builds
        identical shard rows (and identical result-slot shapes) for
        the identical record prefix."""
        if bgen == self.boundary_gen:
            return
        self.boundaries = (
            None if boundaries is None
            else np.asarray(boundaries, np.int32)
        )
        self.shard_results_effective = (
            None if shard_results is None else int(shard_results)
        )
        self.boundary_gen = int(bgen)
        self.boundary_moves += 1
        with self._mu:
            for c in CLASSES:
                self._force_major[c] = True
                self._dirty[c] = True

    def reset_boundaries(self) -> None:
        """Drop to the equal-count cold-start split (mesh shape
        changed: degrade re-home or membership reform — the old n_sp's
        boundary map no longer applies)."""
        self.boundaries = None
        # lockstep currency resets with the map (a reform runs this on
        # EVERY process — incumbents and joiners then agree on bgen 0,
        # so the next broadcast bgen drives identical force-major
        # decisions everywhere); boundary_moves (the gauge) keeps
        # counting.  The boundary-aware result capacity was sized for
        # the dropped map — reset with it.
        self.shard_results_effective = None
        self.boundary_gen = 0
        self._shard_hits_total = np.zeros(
            self.mesh.shape["sp"], np.int64
        )

    def measured_shard_loads(self) -> np.ndarray:
        """Per-shard unique-hit work measured by the sharded kernels:
        retired-dar totals plus the live dars' counters."""
        n_sp = self.mesh.shape["sp"]
        out = np.zeros(n_sp, np.int64)
        tot = self._shard_hits_total
        out[: min(len(tot), n_sp)] += tot[: min(len(tot), n_sp)]
        for snap in self._snapshots.values():
            if snap is None:
                continue
            for dar in (snap.base, snap.delta):
                if dar is not None and dar.n_sp == n_sp:
                    out += dar.shard_hits
        return out

    def refresh(self, *, plan: bool = True) -> bool:
        """Fold ingested records into fresh ShardedDars (one per dirty
        class) and swap them in (atomic per class for readers).
        -> True if any new snapshot was published.

        `plan` runs the rebalance decision first (single-process
        serving); a multihost leader plans and BROADCASTS before
        folding and passes plan=False here, followers always apply
        broadcast boundaries instead."""
        with self._refresh_mu:
            if plan:
                self.plan_rebalance()
            published = False
            for cls in CLASSES:
                published |= self._refresh_class(cls)
            if not self._has_tail_errors():
                self._last_fresh = time.monotonic()
            return published

    def _has_tail_errors(self) -> bool:
        return bool(getattr(self._tail, "errors", 0))

    def _refresh_class(self, cls: str) -> bool:
        """Fold `cls` when it is dirty or has no snapshot yet -> whether
        a snapshot was published.  With tracing on, a `replica.refresh`
        span covers the fold (`cls`; `major`, `records` and `bytes` of
        the dar it built), with `replica.warm` inside it."""
        with self._mu:
            if not self._dirty[cls] and self._snapshots[cls] is not None:
                return False
        with _trace.span("replica.refresh", cls=cls) as sp:
            major, records, built = self._fold(cls)
            if sp.span_id is not None:
                sp.set(major=int(major), records=records,
                       bytes=0 if built is None else built.nbytes)
        return True

    def _fold(self, cls: str) -> tuple:
        """Build, warm and publish a fresh snapshot of `cls` -> (major,
        records in the dar built, the dar built or None)."""
        with self._mu:
            prev = self._snapshots[cls]
            churn = len(self._delta[cls]) + len(self._shadow[cls])
            major = (
                prev is None
                or not self._base[cls]
                or self._force_major[cls]
                or self._tier_ratio <= 0
                or churn > self._tier_ratio * max(len(self._base[cls]), 1)
            )
            bounds = self.boundaries
            if major:
                # full repack: fresh base tier, tombstones GC'd (and,
                # after a boundary move, the rebuild that re-homes
                # every shard row under the new key ranges)
                self._force_major[cls] = False
                recs = list(self._records[cls].values())
                base = (
                    ShardedDar(
                        recs,
                        self.mesh,
                        max_results=self.max_results,
                        shard_results=self._build_shard_results(),
                        boundaries=bounds,
                        staging=self._staging,
                    )
                    if recs
                    else None
                )
                snap = _ClsSnap(
                    base=base,
                    base_ids=[r.entity_id for r in recs],
                    shadow=frozenset(),
                    delta=None,
                    delta_ids=[],
                )
                self._base[cls] = set(self._records[cls])
                self._delta[cls] = {}
                self._shadow[cls] = set()
            else:
                # ship the tier delta only: rebuild the small delta dar
                # (O(churn)); the base dar and its device residency are
                # untouched
                drecs = list(self._delta[cls].values())
                delta = (
                    ShardedDar(
                        drecs,
                        self.mesh,
                        max_results=self.max_results,
                        shard_results=self._build_shard_results(),
                        boundaries=bounds,
                        staging=self._staging,
                    )
                    if drecs
                    else None
                )
                snap = _ClsSnap(
                    base=prev.base,
                    base_ids=prev.base_ids,
                    shadow=frozenset(self._shadow[cls]),
                    delta=delta,
                    delta_ids=[r.entity_id for r in drecs],
                )
            built = snap.delta if not major else snap.base
            records = len(recs) if major else len(drecs)
            # records ingested while we build/warm re-mark dirty and
            # are picked up by the next refresh
            self._dirty[cls] = False
        # warm the new dar BEFORE publishing: one query per warm
        # batch runs every torch op of the route on it (the first call
        # loads their kernels), so the first real offload after a swap
        # pays no first-call cost — readers keep hitting the old
        # snapshot until the warmed one swaps in.  The build itself
        # synchronized its copies (ShardedDar).  Warm time is
        # accounted (replica_warm_ms_total): it is the rebuild cost an
        # operator trades for a stall-free first query.
        if built is not None:
            t_warm = time.perf_counter()
            with _trace.span("replica.warm"):
                for wb in self.warm_batches:
                    try:
                        built.query_batch(
                            np.full((wb, 16), -1, np.int32),
                            np.full(wb, -np.inf, np.float32),
                            np.full(wb, np.inf, np.float32),
                            np.full(wb, NO_TIME_LO, np.int64),
                            np.full(wb, NO_TIME_HI, np.int64),
                            now=0,
                        )
                    except Exception:  # noqa: BLE001 — warmup best-effort
                        pass
            self._warm_ms_total += (time.perf_counter() - t_warm) * 1000
        with self._mu:
            old = self._snapshots[cls]
            if old is not None:
                # retiring dars take their measured per-shard work
                # with them; absorb it so the load heat map survives
                # rebuild swaps
                retired = (
                    (old.base, old.delta) if major else (old.delta,)
                )
                n_sp = len(self._shard_hits_total)
                for dar in retired:
                    if dar is not None and dar.n_sp == n_sp:
                        self._shard_hits_total += dar.shard_hits
            self._snapshots[cls] = snap
            self._rebuilds += 1
            if built is not None:
                self.device_bytes_built += built.nbytes
            if major:
                self._major_rebuilds += 1
            else:
                self._delta_refreshes += 1
                self._minor_fold_records += records
        return major, records, built

    def sync(self) -> None:
        """poll + refresh in one call (tests / benchmarks)."""
        self.poll_once()
        self.refresh()

    # -- background tailing ---------------------------------------------------

    def start(self, interval_s: float = 0.5) -> None:
        self._interval_s = interval_s
        self._started_at = time.monotonic()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll_once()
                    if self._stop.is_set():
                        break  # close(): stop between steps
                    if self._refresh_due():
                        self.refresh()
                    else:
                        self._refresh_skips += 1
                        # an idle replica with NOTHING to fold is still
                        # current — the tail is applied and no class is
                        # dirty — so keep the staleness clock honest
                        # instead of letting it climb into the stale
                        # alert at quiescent steady state (deferred-
                        # backlog idleness is excused in the alert via
                        # replica_demand_idle instead)
                        with self._mu:
                            backlog = any(self._dirty.values())
                        if not backlog and not self._has_tail_errors():
                            self._last_fresh = time.monotonic()
                except Exception:  # noqa: BLE001 — keep the tailer alive
                    log.exception("replica refresh failed")

        self._thread = threading.Thread(
            target=loop, name="sharded-replica", daemon=True
        )
        self._thread.start()

    def _refresh_due(self) -> bool:
        """Demand pacing: rebuild only while the mesh route has a
        consumer (fresh() consulted within the pace window) or during
        the boot grace.  The tail is ALWAYS applied by the loop before
        this check, so skipping a rebuild defers work, never loses it
        — the first demanded refresh folds the whole backlog."""
        pace = self.demand_pace_s
        if pace <= 0:
            return True
        now = time.monotonic()
        if now - self._started_at <= pace:
            return True  # boot grace: warm before the first demand
        return now - self._demand_last <= pace

    def close(self) -> None:
        """Stop the tail and wait until its thread has stopped.  The
        loop stops between steps, so this waits out at most the step in
        progress (one poll or one refresh, which may be inside a torch
        call); the reference's timed join (5 s) could return while the
        thread still ran, and a daemon thread inside a torch call at
        interpreter exit aborts the process."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    # -- serving reads --------------------------------------------------------

    def staleness_s(self) -> float:
        """Seconds since the replica last finished a caught-up sync."""
        if self._last_fresh == 0.0:
            return float("inf")
        return time.monotonic() - self._last_fresh

    def fresh(self, bound_s: Optional[float] = None) -> bool:
        """Mesh-offload gate: the replica must have synced recently,
        have no un-rebuilt class, AND have consumed the whole log.  For
        WAL tails `at_end()` stats the file at call time, so a write
        that committed before this query started is guaranteed visible
        (read-your-writes); region tails give the same bounded
        staleness as any non-writing region instance."""
        if bound_s is None:
            bound_s = 4 * getattr(self, "_interval_s", 0.5)
        # a freshness probe IS the demand signal: a mesh-shaped batch
        # wanted this replica, so the paced background loop resumes
        # rebuilding (a stale answer here steers the caller local and
        # the route re-warms within a tick or two)
        self._demand_last = time.monotonic()
        if self.staleness_s() > bound_s:
            return False
        if any(self._dirty.values()):
            return False
        at_end = getattr(self._tail, "at_end", None)
        return at_end() if at_end is not None else False

    def query(
        self,
        keys: np.ndarray,  # int32 DAR keys
        alt_lo: Optional[float] = None,
        alt_hi: Optional[float] = None,
        t_start: Optional[int] = None,
        t_end: Optional[int] = None,
        *,
        now: int,
        cls: str = "ops",
        owner: Optional[str] = None,
    ) -> List[str]:
        """Entity ids intersecting the query volume, from the current
        snapshot of `cls` (one atomic snapshot grab per query).
        `owner` post-filters to that owner's entities — REQUIRED for
        the subscription classes, whose ids are owner-private (the
        store surfaces scope them the same way)."""
        keys = np.asarray(keys, np.int32).ravel()
        if keys.size == 0:
            return []
        rows = self.query_batch(
            [keys],
            np.asarray([-np.inf if alt_lo is None else alt_lo], np.float32),
            np.asarray([np.inf if alt_hi is None else alt_hi], np.float32),
            np.asarray(
                [NO_TIME_LO if t_start is None else t_start], np.int64
            ),
            np.asarray([NO_TIME_HI if t_end is None else t_end], np.int64),
            now=now,
            cls=cls,
        )
        return self.filter_owner(rows[0], cls, owner)

    def filter_owner(
        self, ids: List[str], cls: str, owner: Optional[str]
    ) -> List[str]:
        """Post-filter ids to one owner's entities (the subscription
        surfaces, whose ids are owner-private)."""
        if owner is None:
            return ids
        oid = self._owners.get(owner)
        recs = self._records[cls]
        return [
            i for i in ids
            if oid is not None and i in recs and recs[i].owner_id == oid
        ]

    def pad_query_batch(
        self,
        keys_list,  # sequence of int32 DAR-key arrays
        alt_lo,
        alt_hi,
        t_start,
        t_end,
        *,
        now,  # scalar or i64[B]
    ):
        """Normalize a batch to the padded arrays the mesh consumes —
        split out so a multihost leader can broadcast EXACTLY what it
        executes (identical shapes => identical collectives on every
        process)."""
        from dss_tpu_torch.dar.pack import pow2_at_least

        b = len(keys_list)
        width = pow2_at_least(
            max((len(k) for k in keys_list), default=1), lo=16
        )
        qkeys = np.full((b, width), -1, np.int32)
        for i, k in enumerate(keys_list):
            u = np.unique(np.asarray(k, np.int32))
            qkeys[i, : len(u)] = u
        now_arr = np.broadcast_to(
            np.asarray(now, np.int64), (b,)
        ).copy()
        return (
            qkeys,
            np.asarray(alt_lo, np.float32),
            np.asarray(alt_hi, np.float32),
            np.asarray(t_start, np.int64),
            np.asarray(t_end, np.int64),
            now_arr,
        )

    def query_batch(
        self,
        keys_list,  # sequence of int32 DAR-key arrays
        alt_lo: np.ndarray,
        alt_hi: np.ndarray,
        t_start: np.ndarray,
        t_end: np.ndarray,
        *,
        now,  # scalar or i64[B]
        cls: str = "ops",
    ) -> List[List[str]]:
        """Batched mesh query -> entity-id lists (sorted).  Hits merge
        across the base and delta tiers; base ids in the shadow set
        (superseded/deleted since the base was built) are dropped, so
        the newest tier wins.

        With tracing on, flat spans cover the call in order:
        `replica.pad`, then query_padded's, then `replica.load`."""
        with _trace.span("replica.pad") as sp:
            qkeys, alo, ahi, ts, te, now_arr = self.pad_query_batch(
                keys_list, alt_lo, alt_hi, t_start, t_end, now=now
            )
            if sp.span_id is not None:
                sp.set(queries=len(keys_list))
        rows = self.query_padded(cls, qkeys, alo, ahi, ts, te, now_arr)
        # serving-entry load accounting: this query's covering stamps
        # its key-range buckets with its measured candidate work (the
        # input the skew-aware splitter plans from)
        with _trace.span("replica.load"):
            for i, row in enumerate(rows):
                self.load.record(keys_list[i], len(row))
        return rows

    def query_padded(
        self,
        cls: str,
        qkeys: np.ndarray,  # [B, width] int32, pad -1
        alt_lo: np.ndarray,
        alt_hi: np.ndarray,
        t_start: np.ndarray,
        t_end: np.ndarray,
        now_arr: np.ndarray,
    ) -> List[List[str]]:
        """The per-tier mesh query over pre-padded arrays (the shape
        every lockstep process replays verbatim).

        With tracing on, each tier's `ShardedDar.query_batch` spans
        (`mesh.*`) and `replica.ids` (its slots to entity ids, the
        shadow drop) carry the tier's name; `replica.sort` ends the
        call."""
        snap = self._snapshots[cls]
        b = qkeys.shape[0]
        if snap is None or (snap.base is None and snap.delta is None):
            self._count_served(cls, b, 0, 0)
            return [[] for _ in range(b)]
        out = [set() for _ in range(b)]
        hits = drops = 0
        for tier, dar, ids, drop in (
            ("base", snap.base, snap.base_ids, snap.shadow),
            ("delta", snap.delta, snap.delta_ids, None),
        ):
            if dar is None:
                continue
            rows = dar.query_batch(
                qkeys,
                alt_lo,
                alt_hi,
                t_start,
                t_end,
                now=now_arr,
                tier=tier,
            )
            with _trace.span("replica.ids", tier=tier) as sp:
                tier_hits, drops0 = sum(map(len, rows)), drops
                for i, row in enumerate(rows):
                    for s in row:
                        if s < len(ids):
                            eid = ids[s]
                            if drop is None or eid not in drop:
                                out[i].add(eid)
                            else:
                                drops += 1
                hits += tier_hits
                if sp.span_id is not None:
                    sp.set(hits=tier_hits, shadow_drops=drops - drops0)
                # the tier's slot lists are freed inside the span that
                # read them, not between spans
                del rows
        with _trace.span("replica.sort"):
            out = [sorted(s) for s in out]
        self._count_served(cls, b, hits, drops)
        return out

    def _count_served(self, cls: str, queries: int, hits: int,
                      drops: int) -> None:
        with self._served_mu:
            served = self._served[cls]
            served[0] += queries
            served[1] += hits
            served[2] += drops

    def query_batch_host(
        self,
        keys_list,
        alt_lo,
        alt_hi,
        t_start,
        t_end,
        *,
        now,
        cls: str = "ops",
    ) -> List[List[str]]:
        """Exact host-side answer straight from the record map — the
        degraded-mode path when no mesh (global or local) is usable.
        Same record state the mesh folds from, so results match."""
        b = len(keys_list)
        now_arr = np.broadcast_to(np.asarray(now, np.int64), (b,))
        with self._mu:
            recs = dict(self._records[cls])
        out = []
        for i in range(b):
            alo = float(np.asarray(alt_lo).ravel()[i])
            ahi = float(np.asarray(alt_hi).ravel()[i])
            ts = int(np.asarray(t_start).ravel()[i])
            te = int(np.asarray(t_end).ravel()[i])
            out.append(
                sorted(
                    oracle.search(
                        recs,
                        np.asarray(keys_list[i], np.int32),
                        None if alo == -np.inf else alo,
                        None if ahi == np.inf else ahi,
                        None if ts == NO_TIME_LO else ts,
                        None if te == NO_TIME_HI else te,
                        int(now_arr[i]),
                    )
                )
            )
        return out

    def shard_stats(self) -> dict:
        """The skew-aware placement gauge family (satellite of the
        load-weighted sharding work; flows into /metrics and the
        Grafana heat panel).  dss_shard_load is a per-shard vector
        (rendered as a labeled gauge); the rest are scalars."""
        loads = self.measured_shard_loads()
        return {
            "dss_shard_load": {
                str(i): float(v) for i, v in enumerate(loads)
            },
            "dss_shard_imbalance_factor": round(self._imbalance, 4),
            "dss_shard_boundary_moves": self.boundary_moves,
            "dss_shard_moved_bytes": self.moved_bytes,
            # per-shard result capacity the builds actually use (the
            # boundary-aware autotune raises it toward max_results
            # when predicted load concentrates; 0 = legacy
            # max_results-sized default)
            "dss_shard_results_cap": int(
                self._build_shard_results() or 0
            ),
            "dss_shard_members": len(self.mesh.processes()),
        }

    def stats(self) -> dict:
        out = {
            "replica_applied_records": self._applied_records,
            "replica_apply_errors": self._apply_errors,
            "replica_tail_errors": getattr(self._tail, "errors", 0),
            "replica_rebuilds": self._rebuilds,
            "replica_delta_refreshes": self._delta_refreshes,
            "replica_major_rebuilds": self._major_rebuilds,
            # host->device bytes of every snapshot built, and the
            # records the minor (delta tier) folds built
            "replica_fold_h2d_bytes": self.device_bytes_built,
            "replica_minor_fold_records": self._minor_fold_records,
            "replica_warm_ms_total": round(self._warm_ms_total, 1),
            "replica_refresh_skips": self._refresh_skips,
            "replica_demand_idle": int(
                self.demand_pace_s > 0
                and self._started_at > 0
                and not self._refresh_due()
            ),
            "replica_staleness_s": (
                -1.0
                if self._last_fresh == 0.0
                else round(self.staleness_s(), 3)
            ),
        }
        out.update(self.shard_stats())
        with self._served_mu:
            served = {c: tuple(v) for c, v in self._served.items()}
        for cls in CLASSES:
            (out[f"replica_{cls}_queries"], out[f"replica_{cls}_hits"],
             out[f"replica_{cls}_shadow_drops"]) = served[cls]
            snap = self._snapshots[cls]
            out[f"replica_{cls}_records"] = len(self._records[cls])
            out[f"replica_{cls}_snapshot_records"] = (
                0 if snap is None else snap.live_records
            )
            fallbacks = 0
            if snap is not None:
                for dar in (snap.base, snap.delta):
                    if dar is not None:
                        fallbacks += dar.overflow_fallbacks
            out[f"replica_{cls}_overflow_fallbacks"] = fallbacks
            out[f"replica_{cls}_delta_records"] = (
                0 if snap is None else len(snap.delta_ids)
            )
            out[f"replica_{cls}_shadowed"] = (
                0 if snap is None else len(snap.shadow)
            )
            out[f"replica_{cls}_dirty"] = int(self._dirty[cls])
            out[f"replica_{cls}_generation"] = self._gen[cls]
        return out


class ShardedOpReplica(ShardedReplica):
    """Back-compat alias: the r3/r4 SCD-operations-only replica surface
    (query defaults to cls='ops')."""

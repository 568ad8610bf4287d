"""DarTable: a device-resident spatial index for one entity class.

The port of the reference's `dss_tpu/dar/snapshot.py`.  One DarTable
holds one entity class (ISAs, RID subscriptions, SCD operations, SCD
subscriptions); its snapshots live on `device` (default `cuda`).

LSM-shaped for lock-free reads.  ALL state a reader touches is
published as ONE immutable `_State` object, swapped atomically by
reference assignment:

  - `tiers`: the device snapshots — each a FastTable (exact block
    columns, dss_tpu_torch.ops.fastpath) plus host-side slot->id/owner
    maps.  Device/host arrays inside a snapshot are never mutated
    after publication.
  - `overlay`: records written since the snapshot build, packed into
    small sorted numpy postings for a vectorized host scan.  Updated
    O(Δ) per write: the new record's postings are spliced into copies
    of the packed arrays (contiguous memcpy), never re-packed from the
    record dicts (which cost O(overlay) python per write).
  - `dead`: snapshot slots superseded or removed since the build;
    readers drop them after the fused query.  (The FastTable's own
    mark_dead is NOT used here — mutating the shared live column would
    race in-flight readers that captured an older overlay.)

A reader therefore sees a consistent (snapshot, overlay, dead) triple:
an entity live at the time the reader grabbed the state is visible via
exactly the snapshot or the overlay; an entity updated by a concurrent
writer is visible as exactly one of its versions.

SNAPSHOTS ARE TIERED (dss_tpu_torch.dar.tiers): the published state
holds a stack of immutable snapshots — a large, rarely-rewritten L0
base plus a small L1 delta tier.  A minor FOLD (overlay -> L1) runs OFF
the write lock: a folder thread copies the writer-tracked delta record
set under the lock (records newer than L0 — O(delta) pointer copy),
builds a fresh L1 aside (pack + device upload of the DELTA ONLY), then swaps
under the lock, reconciling the writes that landed mid-fold by object
identity (they simply stay in the overlay of the new state).  A MAJOR
compaction (L1 + tombstones -> fresh L0) is the only O(table) rebuild
and triggers on the churn ratio (tiers.TierPolicy).  Shadowing is
enforced at write time: updating/removing an entity marks its slot
dead in every tier holding it live, so the newest tier always wins and
queries just merge per-tier hits.  Folds trigger on overlay overflow
(`delta_capacity` postings) and opportunistically when the table has
been write-idle, so read-heavy phases serve from the snapshot path.

Queries run the batched fused kernel (dss_tpu_torch.ops.fused_filter)
for batches beyond FastTable.HOST_MAX_BATCH, and the exact host scan
below it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from dss_tpu_torch.dar import budget
from dss_tpu_torch.dar import tiers as tiersmod
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.pack import pow2_at_least
from dss_tpu_torch.dar.tiers import EMPTY_SNAPSHOT, Tier, TierSnapshot
from dss_tpu_torch.ops import fastpath
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO


class _Overlay(NamedTuple):
    """Records since the snapshot build, packed for a vectorized scan
    (the host-side analog of the device postings layout).  Arrays are
    immutable once published; writers splice copies."""

    ids: List[str]  # local index -> entity_id
    key: np.ndarray  # i32[P] sorted
    ent: np.ndarray  # i32[P] local index per posting
    alt_lo: np.ndarray  # f32[n]
    alt_hi: np.ndarray  # f32[n]
    t0: np.ndarray  # i64[n]
    t1: np.ndarray  # i64[n]
    owner: np.ndarray  # i32[n]


class _State(NamedTuple):
    tiers: "tuple[Tier, ...]"  # oldest (L0) first; () before any fold
    pending: Dict[str, Record]  # overlay source records (immutable)
    overlay: Optional[_Overlay]  # packed form of pending (None if empty)

    @property
    def snap(self) -> TierSnapshot:
        """The base (L0) tier's snapshot."""
        return self.tiers[0].snap if self.tiers else EMPTY_SNAPSHOT


_EMPTY_STATE = _State((), {}, None)


def _pack_overlay(pending: Dict[str, Record]) -> Optional[_Overlay]:
    if not pending:
        return None
    recs = list(pending.values())
    ids = [r.entity_id for r in recs]
    key = np.concatenate([r.keys for r in recs]).astype(np.int32)
    ent = np.repeat(
        np.arange(len(recs), dtype=np.int32),
        [len(r.keys) for r in recs],
    )
    order = np.argsort(key, kind="stable")
    return _Overlay(
        ids=ids,
        key=key[order],
        ent=ent[order],
        alt_lo=np.asarray([r.alt_lo for r in recs], np.float32),
        alt_hi=np.asarray([r.alt_hi for r in recs], np.float32),
        t0=np.asarray([r.t_start for r in recs], np.int64),
        t1=np.asarray([r.t_end for r in recs], np.int64),
        owner=np.asarray([r.owner_id for r in recs], np.int32),
    )


def _overlay_upsert(
    ov: Optional[_Overlay], rec: Record, idx: Optional[int]
) -> "tuple[_Overlay, int]":
    """O(Δ) overlay update: splice the record's postings into copies of
    the packed arrays (contiguous memcpy, not a python repack).
    `idx` is the record's existing local index (update) or None (new).
    Returns (new_overlay, local_index)."""
    k = np.asarray(rec.keys, np.int32)
    if ov is None:
        return (
            _Overlay(
                ids=[rec.entity_id],
                key=k.copy(),
                ent=np.zeros(len(k), np.int32),
                alt_lo=np.asarray([rec.alt_lo], np.float32),
                alt_hi=np.asarray([rec.alt_hi], np.float32),
                t0=np.asarray([rec.t_start], np.int64),
                t1=np.asarray([rec.t_end], np.int64),
                owner=np.asarray([rec.owner_id], np.int32),
            ),
            0,
        )
    if idx is None:
        idx = len(ov.ids)
        ids = ov.ids + [rec.entity_id]
        alt_lo = np.append(ov.alt_lo, np.float32(rec.alt_lo))
        alt_hi = np.append(ov.alt_hi, np.float32(rec.alt_hi))
        t0 = np.append(ov.t0, np.int64(rec.t_start))
        t1 = np.append(ov.t1, np.int64(rec.t_end))
        owner = np.append(ov.owner, np.int32(rec.owner_id))
        key, ent = ov.key, ov.ent
    else:
        ids = ov.ids
        alt_lo = ov.alt_lo.copy()
        alt_lo[idx] = rec.alt_lo
        alt_hi = ov.alt_hi.copy()
        alt_hi[idx] = rec.alt_hi
        t0 = ov.t0.copy()
        t0[idx] = rec.t_start
        t1 = ov.t1.copy()
        t1[idx] = rec.t_end
        owner = ov.owner.copy()
        owner[idx] = rec.owner_id
        keep = ov.ent != idx
        key, ent = ov.key[keep], ov.ent[keep]
    pos = np.searchsorted(key, k)
    key = np.insert(key, pos, k)
    ent = np.insert(ent, pos, np.full(len(k), idx, np.int32))
    return (
        _Overlay(ids, key, ent, alt_lo, alt_hi, t0, t1, owner),
        idx,
    )


def _overlay_drop(ov: _Overlay, idx: int) -> Optional[_Overlay]:
    """Remove a record's postings (its attr slot stays, orphaned —
    bounded by the fold threshold)."""
    keep = ov.ent != idx
    if not keep.any() and len(ov.ids) == 1:
        return None
    return ov._replace(key=ov.key[keep], ent=ov.ent[keep])


def _scatter_hits(out_sets, qidx, slots, ids) -> None:
    """Distribute deduped (query, slot) hits into out_sets[q] as
    entity ids.  One vectorized dedup + grouped set.update per query —
    the per-hit int()/add loop it replaces was ~a third of
    query_many's host cost at serving batch sizes.  Slots beyond
    len(ids) (pad lanes) are dropped."""
    if len(qidx) == 0:
        return
    pairs = np.unique(qidx * np.int64(2**32) + slots)
    qi = (pairs >> np.int64(32)).astype(np.int64)
    sl = pairs & np.int64(0xFFFFFFFF)
    ok = sl < len(ids)
    if not ok.all():
        qi, sl = qi[ok], sl[ok]
    # pairs are sorted, so each query's hits are one contiguous run
    bounds = np.searchsorted(qi, np.arange(len(out_sets) + 1))
    sl_list = sl.tolist()
    getter = ids.__getitem__
    for i in range(len(out_sets)):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            out_sets[i].update(map(getter, sl_list[lo:hi]))


def _overlay_search(
    ov: _Overlay,
    qkeys: np.ndarray,  # i32[B, W] pad -1
    alt_lo, alt_hi, t_start, t_end,  # per-query arrays
    now_arr: np.ndarray,
    owner_ids: Optional[np.ndarray],
):
    """Vectorized host scan of the overlay -> (qidx, local_ent) pairs."""
    B, W = qkeys.shape
    flat = qkeys.ravel()
    lo = np.searchsorted(ov.key, flat, side="left")
    hi = np.searchsorted(ov.key, flat, side="right")
    n = hi - lo
    nonempty = n > 0
    lo, n = lo[nonempty], n[nonempty]
    flat_q = np.repeat(np.arange(B), W)[nonempty]
    total = int(n.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cand = ov.ent[np.repeat(lo, n) + fastpath.segmented_arange(n)]
    cq = np.repeat(flat_q, n)
    keep = (
        (ov.alt_hi[cand] >= alt_lo[cq])
        & (ov.alt_lo[cand] <= alt_hi[cq])
        & (ov.t1[cand] >= np.maximum(t_start[cq], now_arr[cq]))
        & (ov.t0[cand] <= t_end[cq])
    )
    if owner_ids is not None:
        keep &= (owner_ids[cq] < 0) | (ov.owner[cand] == owner_ids[cq])
    return cq[keep].astype(np.int64), cand[keep].astype(np.int64)


class _PendingQuery:
    """One in-flight query_many batch: the immutable state it runs
    against plus either ready host-path hits or a device PendingBatch.
    Produced by DarTable.query_many_submit, resolved by
    DarTable.query_many_collect — the two halves a pipelined caller
    overlaps (pack batch N+1 while batch N is on the device)."""

    __slots__ = (
        "st", "b", "qkeys", "alt_lo", "alt_hi", "t_start", "t_end",
        "now_arr", "owner_ids", "tier_host", "tier_pending",
    )

    def __init__(self, st, b, qkeys, alt_lo, alt_hi, t_start, t_end,
                 now_arr, owner_ids, tier_host, tier_pending):
        self.st = st
        self.b = b
        self.qkeys = qkeys
        self.alt_lo = alt_lo
        self.alt_hi = alt_hi
        self.t_start = t_start
        self.t_end = t_end
        self.now_arr = now_arr
        self.owner_ids = owner_ids
        # per-tier (aligned with st.tiers): exact host-path hits, or a
        # fastpath.PendingBatch when that tier went to the device
        self.tier_host = tier_host  # list of (qidx, slots) | None
        self.tier_pending = tier_pending  # list of PendingBatch | None

    def wait_device(self) -> None:
        """Block until the device results are ready (no data fetch, no
        decode) — lets the pipelined caller time the pure device wait
        separately from the host decode in collect."""
        for p in self.tier_pending:
            if p is not None:
                p.ready()

    def used_device(self) -> bool:
        """Did this batch touch the device?  (Any tier that could not
        answer from its host postings copy submitted a kernel.)"""
        return any(p is not None for p in self.tier_pending)


def _release(pendings) -> None:
    """Hand back the resident replay units of tier batches that will
    not be collected (a submit or collect failed beside them)."""
    for p in pendings:
        if p is not None:
            p.release()


class DarTable:
    """Device spatial index for one entity class: lock-free reads
    against the published immutable state; copy-on-write writes;
    background folds.  Snapshots live on `device` (default `cuda`,
    which raises on a machine without a card)."""

    def __init__(
        self,
        *,
        device=None,
        delta_capacity: int = 8192,
        idle_fold_s: float = 0.5,  # fold the overlay after this long
        #                            without writes (0 disables)
        tier_ratio: Optional[float] = None,  # major-compaction churn
        #                            ratio; None = DSS_TIER_RATIO env
        #                            (0 disables tiering: every fold is
        #                            a full rebuild)
        tier_min_l0: Optional[int] = None,  # L0 sizes below this always
        #                            compact major; None = env default
    ):
        self.device = fastpath.resolve_device(device)
        policy = tiersmod.env_policy()
        self._tier_ratio = (
            policy.ratio if tier_ratio is None else float(tier_ratio)
        )
        self._tier_min_l0 = (
            policy.min_l0 if tier_min_l0 is None else int(tier_min_l0)
        )
        self._write_lock = threading.RLock()
        self._rebuild_postings = delta_capacity
        # per-cell write clock (tiers.CellClock): every upsert/remove
        # stamps the affected DAR keys AFTER the state publish, so a
        # version-fenced cache entry stamped before a write can never
        # survive it.  Lives on the table, not in
        # the published state — minor folds and major compactions swap
        # snapshots without ever touching the stamps.
        self.cell_clock = tiersmod.CellClock()
        self.records: Dict[str, Record] = {}  # authoritative, writer-owned
        self._state: _State = _EMPTY_STATE
        # writer-owned overlay index (id -> local idx in the overlay);
        # reset on every fold/rebuild.  Readers never touch it.
        self._overlay_idx: Dict[str, int] = {}
        # writer-owned delta set: records newer than the L0 base (the
        # minor-fold source; cleared by major compactions/rebuilds).
        # Readers never touch it — they see its packed forms (L1 tier +
        # overlay) through the published state.
        self._delta: Dict[str, Record] = {}
        # background folding
        self._idle_fold_s = idle_fold_s
        self._gen = 0  # bumped by synchronous rebuilds: abandons folds
        self._folding = False
        self._fold_removed: List[str] = []  # ids removed mid-fold
        self._fold_event = threading.Event()
        self._fold_thread: Optional[threading.Thread] = None
        self._last_write = 0.0
        self._closed = False
        # resident warm hook (ops/resident.py): called with a freshly
        # built snapshot's FastTable BEFORE it is swapped in, so the
        # new table has its captured buckets scheduled (async — a
        # capture must never stall the fold) as early as possible
        self._resident_warm = None
        self._stats_folds = 0
        self._stats_fold_ms = 0.0
        self._stats_swap_ms = 0.0
        self._stats_minor_folds = 0
        self._stats_minor_ms = 0.0
        self._stats_compactions = 0
        self._stats_compact_ms = 0.0

    # -- write path ----------------------------------------------------------

    def upsert(
        self,
        entity_id: str,
        keys: np.ndarray,
        alt_lo: Optional[float],
        alt_hi: Optional[float],
        t_start: int,
        t_end: int,
        owner_id: int,
    ) -> None:
        """Insert or replace an entity. keys are int32 DAR keys."""
        keys = np.unique(np.asarray(keys, dtype=np.int32))
        rec = Record(
            entity_id=entity_id,
            keys=keys,
            alt_lo=-np.inf if alt_lo is None else float(alt_lo),
            alt_hi=np.inf if alt_hi is None else float(alt_hi),
            t_start=int(t_start),
            t_end=int(t_end),
            owner_id=int(owner_id),
        )
        with self._write_lock:
            old = self.records.get(entity_id)
            self.records[entity_id] = rec
            self._delta[entity_id] = rec
            st = self._state
            pending = dict(st.pending)
            pending[entity_id] = rec
            # shadow every older tier copy (newest tier wins)
            tiers = tiersmod.mark_dead(st.tiers, entity_id)
            overlay, idx = _overlay_upsert(
                st.overlay, rec, self._overlay_idx.get(entity_id)
            )
            self._overlay_idx[entity_id] = idx
            # one atomic publish: tiers + overlay + dead sets together
            self._state = _State(tiers, pending, overlay)
            # clock bump LAST (after the publish): a concurrent
            # lock-free cache miss that read its fence before this
            # write can only produce an entry stamped too OLD, which
            # the next fence check discards — never one stamped fresh
            # over pre-write data.  Old + new coverings both bump: a
            # record leaving cell X changes X's answers too.
            self.cell_clock.bump(
                None if old is None else old.keys, keys
            )
            self._last_write = time.monotonic()
            if len(overlay.key) > self._rebuild_postings:
                self._request_fold()
            elif self._idle_fold_s > 0:
                self._ensure_folder()  # idle compaction needs the thread

    def remove(self, entity_id: str) -> bool:
        with self._write_lock:
            rec = self.records.pop(entity_id, None)
            if rec is None:
                return False
            self._delta.pop(entity_id, None)
            st = self._state
            pending = st.pending
            overlay = st.overlay
            if entity_id in pending:
                pending = dict(pending)
                del pending[entity_id]
                idx = self._overlay_idx.pop(entity_id, None)
                if overlay is not None and idx is not None:
                    overlay = _overlay_drop(overlay, idx)
            tiers = tiersmod.mark_dead(st.tiers, entity_id)
            if self._folding:
                self._fold_removed.append(entity_id)
            self._state = _State(tiers, pending, overlay)
            self.cell_clock.bump(rec.keys)  # after publish, like upsert
            self._last_write = time.monotonic()
            return True

    # -- folding (overlay -> snapshot), off the write lock -------------------

    def _ensure_folder(self):
        if self._fold_thread is None or not self._fold_thread.is_alive():
            self._fold_thread = threading.Thread(
                target=self._fold_loop, name="dar-folder", daemon=True
            )
            self._fold_thread.start()

    def _request_fold(self):
        self._ensure_folder()
        self._fold_event.set()

    def close(self, join: bool = True):
        """Stop the folder thread (tables created in tests/benchmarks
        must not leak a wake-every-idle_fold_s daemon each); with
        join=False only tell it to stop (it ends after the fold in
        progress, if any).  Reads go on working."""
        self._closed = True
        self._fold_event.set()
        th = self._fold_thread
        if join and th is not None and th is not threading.current_thread():
            th.join(timeout=5)

    def _fold_loop(self):
        while not self._closed:
            triggered = self._fold_event.wait(
                self._idle_fold_s if self._idle_fold_s > 0 else None
            )
            self._fold_event.clear()
            if self._closed:
                return
            try:
                if triggered:
                    self.fold()
                else:
                    # idle compaction: fold a quiet non-empty overlay
                    # (or a tier stack whose churn crossed the major
                    # threshold) so read-heavy phases serve from the
                    # snapshot path.  has_churn gates the major check:
                    # without it an empty/small table would wake into a
                    # guaranteed-no-op fold every idle tick forever
                    st = self._state
                    has_churn = bool(
                        self._delta
                        or len(st.tiers) > 1
                        or any(t.dead_count for t in st.tiers)
                    )
                    if (
                        st.pending
                        or (has_churn and self._want_major())
                    ) and (
                        time.monotonic() - self._last_write
                        >= self._idle_fold_s
                    ):
                        self.fold()
            except Exception:  # noqa: BLE001 — folder must survive
                import logging

                logging.getLogger("dss.dar").exception("fold failed")

    def _want_major(self) -> bool:
        """Major-compaction trigger: the tier stack's churn (delta
        records + shadowed rows) crossed the size-ratio threshold, or
        there is no L0 yet.  Advisory — safe to read without the lock
        (the fold re-decides under it)."""
        st = self._state
        if not st.tiers:
            return True  # first fold builds the base
        if self._tier_ratio <= 0:
            return True  # tiering disabled: every fold is a rebuild
        l0_n = len(st.tiers[0].snap.ids)
        if l0_n < self._tier_min_l0:
            return True  # small tables repack in microseconds
        churn = len(self._delta) + sum(t.dead_count for t in st.tiers)
        return churn > self._tier_ratio * max(l0_n, 1)

    def compact(self) -> bool:
        """Force a major compaction: L1 + tombstones merged into a
        fresh L0 (off the write lock, like any fold).  -> True if a new
        snapshot was published."""
        return self.fold(major=True)

    def fold(self, *, major: Optional[bool] = None) -> bool:
        """Fold the overlay into the tier stack OFF the write lock and
        swap atomically, keeping mid-fold writes in the new overlay.

        Minor (the common case): rebuild ONLY the small L1 tier from
        the writer-tracked delta set — O(overlay + L1), never O(table);
        the L0 base (and its device residency) is untouched.  Major
        (`major=True`, or the churn-ratio policy): rebuild L0 from all
        records, clearing the delta set and garbage-collecting every
        tombstone.  -> True if a new snapshot was published."""
        t_all = time.perf_counter()
        with self._write_lock:
            if self._folding:
                return False  # a fold is already running
            st = self._state
            if major is None:
                major = self._want_major()
            if not st.tiers:
                major = True  # no base to tier onto yet
            if major:
                if (
                    not st.pending
                    and not self._delta
                    and len(st.tiers) <= 1
                    and not any(t.dead_count for t in st.tiers)
                ):
                    return False  # nothing to compact
                recs = list(self.records.values())  # O(n) pointer copy
            else:
                if not st.pending:
                    return False  # overlay empty; L1 already == delta
                recs = list(self._delta.values())  # O(delta) copy
            self._folding = True
            self._fold_removed = []
            gen0 = self._gen
        try:
            snap = self._build_snapshot(recs)  # pack + upload, unlocked
            if self._resident_warm is not None and snap.fast is not None:
                try:
                    # schedule the new table's captured buckets (async;
                    # until a bucket lands, submits launch B1 eagerly)
                    self._resident_warm(snap.fast)
                except Exception:  # noqa: BLE001 — warm is best-effort
                    import logging

                    logging.getLogger("dss.dar").exception(
                        "resident warm failed"
                    )
            t_swap = time.perf_counter()
            with self._write_lock:
                if self._gen != gen0:
                    return False  # a synchronous rebuild superseded us
                built = snap.recs
                cur = self._state
                # writes that landed mid-fold: record object differs
                # from what we built (or is brand new)
                new_pending = {
                    i: r
                    for i, r in cur.pending.items()
                    if built.get(i) is not r
                }
                dead = set()
                for i in new_pending:
                    s = snap.slot_of.get(i)
                    if s is not None:
                        dead.add(s)
                for i in self._fold_removed:
                    s = snap.slot_of.get(i)
                    if s is not None:
                        dead.add(s)
                new_tier = tiersmod.make_tier(snap, dead)
                if major:
                    # fresh base: delta keeps only mid-compaction writes
                    self._delta = {
                        i: r
                        for i, r in self._delta.items()
                        if built.get(i) is not r
                    }
                    tiers = (new_tier,) if snap.ids else ()
                else:
                    # L0 carries over untouched (mid-fold writes already
                    # grew its dead set in cur); the fresh L1 — built
                    # from the FULL delta set — replaces the old one
                    tiers = (
                        (cur.tiers[0], new_tier)
                        if snap.ids
                        else (cur.tiers[0],)
                    )
                overlay = _pack_overlay(new_pending)
                self._overlay_idx = {
                    i: k for k, i in enumerate(new_pending)
                }
                self._state = _State(tiers, new_pending, overlay)
                self._stats_swap_ms += (
                    time.perf_counter() - t_swap
                ) * 1000
            dur_ms = (time.perf_counter() - t_all) * 1000
            self._stats_folds += 1
            self._stats_fold_ms += dur_ms
            if major:
                self._stats_compactions += 1
                self._stats_compact_ms += dur_ms
            else:
                self._stats_minor_folds += 1
                self._stats_minor_ms += dur_ms
            return True
        finally:
            with self._write_lock:
                self._folding = False
                self._fold_removed = []

    def _build_snapshot(self, live: List[Record]) -> TierSnapshot:
        return tiersmod.build_snapshot(live, device=self.device)

    def _rebuild_locked(self):
        """Synchronous in-lock rebuild (bulk loads / explicit calls).
        Bumps the generation so any in-flight background fold abandons
        its (now stale) snapshot instead of swapping it in."""
        self._gen += 1
        snap = self._build_snapshot(list(self.records.values()))
        self._state = _State(
            (tiersmod.make_tier(snap),) if snap.ids else (),
            {},
            None,
        )
        self._overlay_idx = {}
        self._delta = {}

    def rebuild(self):
        with self._write_lock:
            self._rebuild_locked()

    def bulk_load(self, records) -> None:
        """Replace the table contents with `records` (list of Record) in
        one rebuild — the snapshot-refresh path (WAL replay / bench
        population) that skips per-entity overlay churn.  Duplicate
        entity_ids keep the last occurrence (WAL replay order)."""
        with self._write_lock:
            self.records = {r.entity_id: r for r in records}
            self._rebuild_locked()
            # wholesale replacement: raise the clock floor (O(1))
            # instead of stamping every record's covering
            self.cell_clock.bump_all()

    def set_resident_warm(self, fn) -> None:
        """Install the fold-time resident warm hook: fn(fast_table) is
        called with each freshly built snapshot's FastTable before the
        swap (the QueryCoalescer installs this when its resident loop
        is enabled)."""
        self._resident_warm = fn

    def warm_resident(self, kernel, batch_buckets=None,
                      window_buckets=None) -> int:
        """Capture the resident bucket grid for every CURRENT tier
        (boot warm; fold-time warm of future tiers goes through
        set_resident_warm).  Returns fresh entries built."""
        n = 0
        for tier in self._state.tiers:
            if tier.snap.fast is not None:
                n += kernel.warm(
                    tier.snap.fast, batch_buckets, window_buckets
                )
        return n

    # -- read path (lock-free) -----------------------------------------------

    def query(
        self,
        keys: np.ndarray,
        alt_lo: Optional[float] = None,
        alt_hi: Optional[float] = None,
        t_start: Optional[int] = None,
        t_end: Optional[int] = None,
        *,
        now: int,
        owner_id: Optional[int] = None,
    ) -> List[str]:
        """Entity ids intersecting the query volume (live at/after now)."""
        if len(np.asarray(keys).ravel()) == 0:
            return []
        return self.query_many(
            [np.asarray(keys, np.int32).ravel()],
            np.asarray([-np.inf if alt_lo is None else alt_lo], np.float32),
            np.asarray([np.inf if alt_hi is None else alt_hi], np.float32),
            np.asarray(
                [NO_TIME_LO if t_start is None else t_start], np.int64
            ),
            np.asarray([NO_TIME_HI if t_end is None else t_end], np.int64),
            now=now,
            owner_ids=None
            if owner_id is None
            else np.asarray([owner_id], np.int32),
        )[0]

    def query_many_submit(
        self,
        keys_list,  # sequence of int32 arrays (DAR keys per query)
        alt_lo: np.ndarray,  # f32[B], -inf unbounded
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # i64[B] ns, NO_TIME_LO unbounded
        t_end: np.ndarray,
        *,
        now,  # int scalar or i64[B] per-query
        owner_ids: Optional[np.ndarray] = None,  # i32[B], -1 = no filter
        state: Optional[_State] = None,  # pre-grabbed state (internal)
        host_route: bool = False,  # force chunked exact host scans
        kernel=None,  # resident selector (ops/resident.py): device
        #               tiers replay their captured bucket instead of
        #               launching B1 eagerly
    ) -> Optional[_PendingQuery]:
        """The host/pack half of query_many: grab ONE immutable state,
        pack the query batch, and either answer small batches from the
        exact host postings copy or launch the fused device kernel
        (async — nothing here blocks on the device).  Returns a handle
        for query_many_collect; None for an empty batch.  Pipelined
        callers overlap this with a previous batch's collect.

        host_route=True is the forced host path: every tier is served
        as chunked exact host scans (FastTable.query_host_chunked, the
        HOST_MAX_BATCH bucket per chunk) instead of the fused device
        kernel — identical results, no device round trip.
        A tier whose chunks exceed the raised host-candidate cap falls
        back to the device submit for that tier only (correctness over
        routing intent)."""
        st = state if state is not None else self._state
        b = len(keys_list)
        if b == 0:
            return None
        now_arr = np.broadcast_to(np.asarray(now, np.int64), (b,))
        width = max(16, pow2_at_least(max(len(k) for k in keys_list), lo=16))
        qkeys = np.full((b, width), -1, np.int32)
        for i, k in enumerate(keys_list):
            k = np.asarray(k, np.int32)
            qkeys[i, : len(k)] = k
        # row-dedup in one vectorized pass instead of per-item
        # np.unique (a third of this function's host cost at batch 32):
        # sort each row, then blank repeats to the -1 pad key.  Key
        # order within a row is irrelevant (set semantics) and pads
        # find empty postings ranges wherever they sit.
        qkeys.sort(axis=1)
        dup = qkeys[:, 1:] == qkeys[:, :-1]
        if dup.any():
            qkeys[:, 1:][dup] = -1

        # per-tier answers, host path first: small batches answer from
        # each tier's host postings copy (exact) instead of paying a
        # device round trip — the tiny L1 tier
        # almost always stays on the host even when L0 needs the device
        tier_host: List = []
        need_device: List[int] = []
        for ti, tier in enumerate(st.tiers):
            if tier.snap.fast is None:
                tier_host.append(None)
                continue
            if host_route:
                host = tier.snap.fast.query_host_chunked(
                    qkeys, alt_lo, alt_hi, t_start, t_end, now=now_arr
                )
            else:
                host = tier.snap.fast.query_host_auto(
                    qkeys, alt_lo, alt_hi, t_start, t_end, now=now_arr
                )
            tier_host.append(host)
            if host is None:
                need_device.append(ti)
        if need_device and budget.is_host_only():
            # caller is on the event loop: re-run via executor
            raise budget.NeedsDevice()
        tier_pending: List = [None] * len(st.tiers)
        try:
            for ti in need_device:
                tier_pending[ti] = st.tiers[ti].snap.fast.submit(
                    qkeys, alt_lo, alt_hi, t_start, t_end, now=now_arr,
                    kernel=kernel,
                )
        except BaseException:
            _release(tier_pending)
            raise
        return _PendingQuery(
            st, b, qkeys, alt_lo, alt_hi, t_start, t_end, now_arr,
            owner_ids, tier_host, tier_pending,
        )

    def query_many_collect(self, pq: Optional[_PendingQuery]) -> List[List[str]]:
        """The collect/decode half of query_many: resolve the device
        batch (the one host sync), then dead-slot/owner filtering, the
        overlay scan, and id assembly — all against the state grabbed
        at submit time, so the (snapshot, overlay, dead) triple stays
        consistent across the pipeline gap."""
        if pq is None:
            return []
        st = pq.st
        out_sets = [set() for _ in range(pq.b)]
        for tier, host, pending in zip(
            st.tiers, pq.tier_host, pq.tier_pending
        ):
            if tier.snap.fast is None:
                continue
            if host is not None:
                qidx, slots = host
            else:
                try:
                    qidx, slots = tier.snap.fast.collect(pending)
                except BaseException:
                    _release(pq.tier_pending)  # the later tiers' units
                    raise
            if len(qidx):
                # per-tier shadowing: slots superseded by a newer tier
                # (or the overlay) were marked dead at write/fold time,
                # so dropping them here makes the newest tier win
                qidx, slots = tiersmod.filter_dead(tier, qidx, slots)
                if pq.owner_ids is not None and len(qidx):
                    keep = (pq.owner_ids[qidx] < 0) | (
                        tier.snap.owner[slots] == pq.owner_ids[qidx]
                    )
                    qidx, slots = qidx[keep], slots[keep]
            _scatter_hits(out_sets, qidx, slots, tier.snap.ids)

        if st.overlay is not None:
            oq, oent = _overlay_search(
                st.overlay, pq.qkeys, pq.alt_lo, pq.alt_hi, pq.t_start,
                pq.t_end, pq.now_arr, pq.owner_ids,
            )
            _scatter_hits(out_sets, oq, oent, st.overlay.ids)

        # an entity updated since a tier was built appears via a newer
        # tier or the overlay only (its old slot is in that tier's dead
        # set); sets dedup any transient double-sighting.  Sorted for
        # deterministic responses.
        return [sorted(s) for s in out_sets]

    def query_many(
        self,
        keys_list,  # sequence of int32 arrays (DAR keys per query)
        alt_lo: np.ndarray,  # f32[B], -inf unbounded
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # i64[B] ns, NO_TIME_LO unbounded
        t_end: np.ndarray,
        *,
        now,  # int scalar or i64[B] per-query
        owner_ids: Optional[np.ndarray] = None,  # i32[B], -1 = no filter
        state: Optional[_State] = None,  # pre-grabbed state (internal)
        host_route: bool = False,  # force chunked exact host scans
        kernel=None,  # resident selector (ops/resident.py)
    ) -> List[List[str]]:
        """Batched search via the fused fast path + overlay scan.
        Lock-free: runs against ONE atomically-grabbed immutable state.
        submit+collect in one call; a pipelined caller calls the halves
        separately to overlap host pack with device work."""
        return self.query_many_collect(
            self.query_many_submit(
                keys_list, alt_lo, alt_hi, t_start, t_end,
                now=now, owner_ids=owner_ids, state=state,
                host_route=host_route, kernel=kernel,
            )
        )

    def max_owner_count(self, keys: np.ndarray, owner_id: int, *, now: int) -> int:
        """DSS0030 quota metric: max per-cell count of live entities owned
        by owner_id over the query cells
        (pkg/rid/cockroach/subscriptions.go:86-116).

        The whole computation runs against ONE grabbed immutable state
        (query + per-cell counts), so the counts can never disagree with
        the snapshot the query matched — writer-owned `self.records` is
        never touched."""
        qk = np.unique(np.asarray(keys, np.int32).ravel())
        if len(qk) == 0:
            return 0
        st = self._state
        ids = self.query_many(
            [qk],
            np.asarray([-np.inf], np.float32),
            np.asarray([np.inf], np.float32),
            np.asarray([NO_TIME_LO], np.int64),
            np.asarray([NO_TIME_HI], np.int64),
            now=now,
            owner_ids=np.asarray([owner_id], np.int32),
            state=st,
        )[0]
        counts = {int(k): 0 for k in qk}
        for eid in ids:
            rec = st.pending.get(eid) or tiersmod.resolve_record(
                st.tiers, eid
            )
            if rec is None:
                continue
            for k in np.intersect1d(rec.keys, qk):
                counts[int(k)] += 1
        return max(counts.values(), default=0)

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        st = self._state
        tier = tiersmod.stats(st.tiers)
        out = {
            "live_records": len(self.records),
            # total snapshot rows across tiers (dead rows included,
            # matching the pre-tier meaning of this gauge)
            "snapshot_records": (
                tier["tier_l0_records"] + tier["tier_l1_records"]
            ),
            "pending_records": len(st.pending),
            "dead_slots": tier["tier_shadowed_rows"],
            "folds": self._stats_folds,
            "fold_ms_total": round(self._stats_fold_ms, 1),
            "fold_swap_ms_total": round(self._stats_swap_ms, 3),
            # tiered-compaction gauges (dss_dar_<class>_tier_* in
            # /metrics): tier sizes, shadowed rows, and the minor-fold
            # vs major-compaction duration split
            "tier_delta_records": len(self._delta),
            "tier_minor_folds": self._stats_minor_folds,
            "tier_minor_fold_ms_total": round(self._stats_minor_ms, 1),
            "tier_compactions": self._stats_compactions,
            "tier_compact_ms_total": round(self._stats_compact_ms, 1),
            "tier_ratio": self._tier_ratio,
            # version-fence introspection (/status + /metrics): the
            # write generation and the cell-clock high-water mark the
            # read cache fences against
            "write_generation": self.cell_clock.generation,
            "cell_clock_high_water": self.cell_clock.high_water,
        }
        out.update(tier)
        return out

"""The store implementation: host-authoritative state + spatial index + WAL.

The port of the reference's `dss_tpu/dar/dss_store.py`, standalone
and region mode.  One implementation serves both backends — the
spatial index strategy is injected (`storage="memory"` ->
MemorySpatialIndex linear scans, `storage="cuda"` -> CudaSpatialIndex,
the DarTable on the card), mirroring how the upstream DSS selects its
store behind the repository seam.  The tuner comes with a later
slice; asking for it raises.

Semantics mirrored from the reference:
  - RID fenced writes on the commit-timestamp version
    (pkg/rid/cockroach/identification_service_area.go:97-162)
  - RID notification fanout = bump live subs intersecting cells
    (pkg/rid/cockroach/subscriptions.go:204-219)
  - SCD upsert fencing + OVN key check for Accepted/Activated
    (pkg/scd/store/cockroach/operations.go:304-372)
  - SCD delete with implicit-subscription GC
    (operations.go:239-301)
  - SCD subscription quota / dependent-op delete block
    (subscriptions.go:369-495)

Every mutation appends to the WAL after applying; replay rebuilds the
dicts and the spatial indexes (the HBM snapshot is a cache of the WAL,
the checkpoint/resume story per SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.clock import Clock, to_nanos
from dss_tpu_torch.dar import codec
from dss_tpu_torch.dar import readcache as rcache
from dss_tpu_torch.obs import trace
from dss_tpu_torch.dar import tiers as tiersmod
from dss_tpu_torch.dar.index import CudaSpatialIndex, MemorySpatialIndex
from dss_tpu_torch.dar.store import RIDStore, SCDStore
from dss_tpu_torch.dar.wal import WriteAheadLog
from dss_tpu_torch.geo.covering import canonical_cells
from dss_tpu_torch.models import rid as ridm
from dss_tpu_torch.models import scd as scdm
from dss_tpu_torch.models.core import Version, new_ovn_from_time

MAX_RID_SUBSCRIPTIONS_PER_AREA = 10  # DSS0030
MAX_SCD_SUBSCRIPTIONS_PER_AREA = 10

def _copy_rec(rec):
    """Shallow defensive copy for search-result assembly: callers may
    mutate the returned object (e.g. the SCD service blanks `ovn` for
    non-owners) without touching the shared stored record.  Equivalent
    to `dataclasses.replace(rec)` for these pure-data records but
    ~1.5x cheaper — per-record assembly is the read path's largest
    single cost at poll-heavy hit rates."""
    return copy.copy(rec)


def _lock_txn(lock):
    """Default transaction factory: just the store lock."""

    @contextlib.contextmanager
    def txn():
        with lock:
            yield

    return txn


def _bump_sub(subs: Dict[str, object], sub_id: str):
    """Copy-on-write notification-index bump: replaces the stored record
    (lock-free readers may hold a reference to the current object).
    Returns the bumped record, or None if absent."""
    sub = subs.get(sub_id)
    if sub is None:
        return None
    bumped = dataclasses.replace(
        sub, notification_index=sub.notification_index + 1
    )
    subs[sub_id] = bumped
    return bumped


class _PushMixin:
    """Reverse-query push wiring shared by both sub-stores
    (dss_tpu_torch/push/): DSSStore.attach_push hands the pipeline to the
    unwrapped impls; the notify paths then (a) run subscriber matching
    through the pipeline's rqmatch route instead of the read-side
    coalescer — bit-identical by the MatchStage contract, but priced
    and counted as write-side work — and (b) fan the bumped subscriber
    set into the durable delivery queue after the journal record
    lands.  Without a pipeline everything behaves exactly as before
    push existed."""

    _push = None

    def set_push(self, pipeline) -> None:
        self._push = pipeline

    def _push_match_ids(self, cls, cells, *, alt_lo=None, alt_hi=None,
                        t_start_ns=None, t_end_ns=None):
        """The subscriber-id match for a write volume: the push
        pipeline's MatchStage when attached (planner rqmatch route,
        host-oracle fallback), else the index's own query path.
        Returns ids in arbitrary order — callers sort."""
        push = self._push
        if push is not None and push.bound:
            return push.match_ids(
                cls, cells, alt_lo=alt_lo, alt_hi=alt_hi,
                t_start_ns=t_start_ns, t_end_ns=t_end_ns,
                now_ns=self._now_ns(),
            )
        return self._sub_index.query_ids(
            cells, alt_lo=alt_lo, alt_hi=alt_hi,
            t_start=t_start_ns, t_end=t_end_ns, now=self._now_ns(),
        )

    def _offer_push(self, trigger, entity, subs, *, removed=False,
                    emergency=False, alt_lo=None, alt_hi=None,
                    t_start=None, t_end=None) -> None:
        """Hand the bumped subscriber set to the delivery pipeline —
        post-journal, O(1) per subscriber (durable append + worker
        wake); webhook I/O never runs on the write path."""
        push = self._push
        if push is None or not push.bound:
            return
        push.offer(
            trigger, entity, subs, removed=removed,
            emergency=emergency, alt_lo=alt_lo, alt_hi=alt_hi,
            t_start_ns=None if t_start is None else to_nanos(t_start),
            t_end_ns=None if t_end is None else to_nanos(t_end),
        )


class _TxnTimeMixin:
    """Per-transaction pinned 'now' (the stand-in for CRDB's txn
    timestamp): every visibility/expiry check inside one transaction
    reads the same instant, so a precheck and the mutation that follows
    it can never disagree about which records are visible (a record
    expiring mid-txn would otherwise abort the txn after journaling).
    Thread-local so lock-free readers keep their own wall-clock now."""

    def _init_txn_time(self):
        self._txn_time = threading.local()

    @contextlib.contextmanager
    def _txn_scope(self):
        with self._txn():
            tl = self._txn_time
            outer = getattr(tl, "now", None) is None
            if outer:
                tl.now = to_nanos(self._clock.now())
            try:
                yield
            finally:
                if outer:
                    tl.now = None

    def _now_ns(self) -> int:
        pinned = getattr(self._txn_time, "now", None)
        return pinned if pinned is not None else to_nanos(self._clock.now())

    @contextlib.contextmanager
    def transaction(self):
        with self._txn_scope():
            yield self


class _CachedSearchMixin:
    """The version-fenced read-cache seam shared by both sub-stores.

    `_cached_ids` fronts an index query_ids call: the covering is
    canonicalized (sorted, deduped — the same form the pack path
    assumes), the per-cell clock fence is read BEFORE the fresh query
    runs, and a fenced hit returns in microseconds without ever
    reaching the coalescer — no admission, no deadline stamp, no
    Retry-After backlog contribution, no device.  Misses populate on
    the way out (the coalescer's collect path has already resolved by
    then) unless the answer came from the bounded-stale mesh replica,
    which must never be stamped as fresh."""

    _cache: Optional[rcache.ReadCache] = None
    _epoch_fn = staticmethod(lambda: "")

    def _init_cache(self, cache, epoch_fn):
        self._cache = cache
        if epoch_fn is not None:
            self._epoch_fn = epoch_fn

    def _fenced_index_swap(self, *old_indexes):
        """Fresh indexes for a state reset, carrying the old cell
        clocks with a bump_all() floor — THE mid-resync staleness
        invariant, shared by both store classes so the ordering cannot
        drift apart: flush the cache first (reclaims entries the floor
        is about to orphan), build the replacement indexes BEFORE the
        caller clears its dicts (factory cost stays outside the window
        lock-free readers can observe), adopt each predecessor's clock
        (O(1) — no stamp-array churn in the window), then floor it so
        every fence stamped before the reset fails."""
        if self._cache is not None:
            self._cache.invalidate_all()
        fresh = []
        for ix in old_indexes:
            clock = ix.cell_clock
            new_ix = self._index_factory()
            new_ix.adopt_cell_clock(clock)
            clock.bump_all()
            fresh.append(new_ix)
        return fresh

    def _cached_ids(
        self,
        cls: str,
        index,
        cells,  # canonical uint64 covering
        qkey: tuple,  # class-specific window/alt key components
        now_ns: int,  # the query's `now` (its only time-variant input)
        allow_stale: bool,
        run,  # () -> List[str], the fresh path (index.query_ids)
        t_end_of,  # id -> t_end ns (from the record dict) or None
        owner_id: Optional[int] = None,
    ) -> List[str]:
        cache = self._cache
        clock_fence = getattr(index, "clock_fence", None)
        if (
            cache is None
            or not cache.enabled
            or clock_fence is None
            # near-the-area-cap coverings: the O(|cells|) fence walk
            # stops being "microseconds" — serve fresh rather than
            # cache a key nobody repeats cheaply
            or len(cells) > 16384
        ):
            rcache.take_mesh_served()
            ids = run()
            rcache.note_last_search_meshed(rcache.take_mesh_served())
            return ids
        th = trace.current()
        t_cl_w = t_cl0 = 0
        if th is not None:
            t_cl_w, t_cl0 = time.time_ns(), time.perf_counter()
        epoch = self._epoch_fn()
        fence = clock_fence(cells)
        key = (cls, owner_id, qkey, cells.tobytes())
        ids = cache.lookup(
            cls, key, fence, epoch, int(now_ns), allow_stale
        )
        if th is not None:
            trace.add_span(
                th, "cache.lookup", t_cl_w,
                (time.perf_counter() - t_cl0) * 1000,
                attrs={"cls": cls, "hit": ids is not None},
            )
        if ids is not None:
            rcache.note_search(cls, epoch, fence[2], True)
            rcache.note_last_search_meshed(False)
            return ids
        rcache.take_mesh_served()  # clear any stale flag before running
        ids = run()
        meshed = rcache.take_mesh_served()
        rcache.note_last_search_meshed(meshed)
        if not meshed:
            pairs_ids: List[str] = []
            t1s: List[int] = []
            for i in ids:
                t1 = t_end_of(i)
                if t1 is None:
                    # record vanished between query and assembly: the
                    # concurrent remove's clock bump will fence this
                    # entry out; omitting the id matches what the
                    # fresh path would return right now
                    continue
                pairs_ids.append(i)
                t1s.append(t1)
            try:
                # chaos seam: population is best-effort by contract —
                # an injected failure here leaves the next poll a
                # miss, never a wrong answer
                chaos.fault_point("cache.populate", detail=cls)
                cache.insert(
                    cls, key, fence, epoch, int(now_ns), pairs_ids, t1s
                )
            except chaos.FaultError:
                pass
        rcache.note_search(cls, epoch, fence[2], False)
        return ids


class TimestampOracle:
    """Strictly-increasing commit timestamps (microsecond granularity),
    the stand-in for CRDB's transaction_timestamp()."""

    def __init__(self, clock: Clock):
        self._clock = clock
        self._last: Optional[datetime] = None
        self._lock = threading.Lock()

    def commit_ts(self) -> datetime:
        with self._lock:
            now = self._clock.now()
            if self._last is not None and now <= self._last:
                now = self._last + timedelta(microseconds=1)
            self._last = now
            return now


class OwnerInterner:
    """Thread-safe string->id interner.  Lock-free callers (owner-scoped
    searches) may intern concurrently, so the check-then-set must be
    atomic or two owners could share one id (tenant mixing)."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._lock = threading.Lock()

    def intern(self, owner: str) -> int:
        existing = self._ids.get(owner)  # fast path, no lock
        if existing is not None:
            return existing
        with self._lock:
            return self._ids.setdefault(owner, len(self._ids))


class RIDStoreImpl(_PushMixin, _TxnTimeMixin, _CachedSearchMixin, RIDStore):
    def __init__(
        self, *, clock, ts_oracle, owners, lock, journal, index_factory,
        txn=None, capture_undo=False, cache=None, epoch_fn=None,
    ):
        self._clock = clock
        self._ts = ts_oracle
        self._owners = owners
        self._lock = lock
        self._txn = txn if txn is not None else _lock_txn(lock)
        self._journal = journal
        self._index_factory = index_factory
        # region mode: each journal record carries an "undo" list (wal
        # records that revert the mutation) so the coordinator can roll
        # back an aborted txn precisely instead of resyncing from the log
        self._capture_undo = capture_undo
        self._init_txn_time()
        self._init_cache(cache, epoch_fn)
        self._isas: Dict[str, ridm.IdentificationServiceArea] = {}
        self._subs: Dict[str, ridm.Subscription] = {}
        self._isa_index = index_factory()
        self._sub_index = index_factory()

    def reset_state(self):
        """Drop all local state (region resync rebuilds from the log);
        _fenced_index_swap keeps the cache coherent and the readers'
        mid-resync window as narrow as before the cache existed."""
        new_isa, new_sub = self._fenced_index_swap(
            self._isa_index, self._sub_index
        )
        self._isas = {}
        self._subs = {}
        self._isa_index = new_isa
        self._sub_index = new_sub

    def serialize_state(self) -> dict:
        """Full-state snapshot as plain JSON docs (region snapshot
        upload; the CRDB-range-snapshot analog)."""
        return self.serialize_refs(self.snapshot_refs())

    def snapshot_refs(self) -> tuple:
        """Grab record references for a consistent snapshot cut (cheap;
        call under the store lock).  Records are immutable — replaced,
        never mutated — so serialize_refs may run outside the lock."""
        return (list(self._isas.values()), list(self._subs.values()))

    @staticmethod
    def serialize_refs(refs: tuple) -> dict:
        isas, subs = refs
        return {
            "isas": [codec.isa_to_doc(x) for x in isas],
            "subs": [codec.rid_sub_to_doc(x) for x in subs],
        }

    def restore_state(self, state: dict) -> None:
        """Region snapshot install: reset, then one index put per
        record, as the WAL replay does."""
        self.reset_state()
        for d in state.get("isas", []):
            isa = codec.doc_to_isa(d)
            self._isas[isa.id] = isa
            self._index_isa(isa)
        for d in state.get("subs", []):
            sub = codec.doc_to_rid_sub(d)
            self._subs[sub.id] = sub
            self._index_sub(sub)

    # -- ISAs ----------------------------------------------------------------

    def index_stats(self) -> dict:
        return self._isa_index.stats()

    def sub_index_stats(self) -> dict:
        return self._sub_index.stats()

    def get_isa(self, id):
        # lock-free read: dict get is atomic; records are replaced, not
        # mutated, on write
        isa = self._isas.get(id)
        return dataclasses.replace(isa) if isa else None

    def _index_isa(self, isa):
        self._isa_index.put(
            isa.id,
            isa.cells,
            isa.altitude_lo,
            isa.altitude_hi,
            to_nanos(isa.start_time),
            to_nanos(isa.end_time),
            self._owners.intern(isa.owner),
        )

    def insert_isa(self, isa):
        with self._txn_scope():
            old = self._isas.get(isa.id)
            if isa.version is None or isa.version.empty:
                if old is not None:
                    raise errors.internal(
                        "insert of existing ISA (application precheck bypassed)"
                    )
            else:
                if old is None or not isa.version.matches(old.version):
                    return None  # fenced write matched no row
            stored = dataclasses.replace(
                isa, version=Version.from_time(self._ts.commit_ts())
            )
            self._isas[stored.id] = stored
            self._index_isa(stored)
            rec = {"t": "isa_put", "doc": codec.isa_to_doc(stored)}
            if self._capture_undo:
                rec["undo"] = [
                    {"t": "isa_put", "doc": codec.isa_to_doc(old)}
                    if old is not None
                    else {"t": "isa_del", "id": stored.id}
                ]
            self._journal(rec)
            return dataclasses.replace(stored)

    def delete_isa(self, isa):
        with self._txn_scope():
            old = self._isas.get(isa.id)
            if (
                old is None
                or old.owner != isa.owner
                or isa.version is None
                or not isa.version.matches(old.version)
            ):
                return None
            del self._isas[isa.id]
            self._isa_index.remove(isa.id)
            rec = {"t": "isa_del", "id": isa.id}
            if self._capture_undo:
                rec["undo"] = [{"t": "isa_put", "doc": codec.isa_to_doc(old)}]
            self._journal(rec)
            return dataclasses.replace(old)

    def search_isas(self, cells, earliest, latest, *, allow_stale=False):
        # lock-free read against the index's published snapshot;
        # allow_stale additionally permits a fresh mesh-replica answer
        # for oversized coalesced batches (service SEARCH paths only —
        # transactional reads never set it).  The version-fenced cache
        # fronts the whole thing: a fenced hit never reaches the index.
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        if earliest is None:
            raise errors.internal("must call with an earliest start time.")
        cells = canonical_cells(cells)
        e_ns = to_nanos(earliest)
        l_ns = None if latest is None else to_nanos(latest)
        # `earliest` is the query's `now` (the service clamps past
        # starts to the wall clock), and its ONLY effect on the result
        # is the t_end >= earliest expiry filter — which the cache
        # re-applies at now_ns on every hit.  Keying it would stamp
        # the wall clock into the key and make every repeat poll a
        # unique, never-hit line; only `latest` shapes the entry.
        ids = self._cached_ids(
            "isa", self._isa_index, cells,
            qkey=(l_ns,), now_ns=e_ns, allow_stale=allow_stale,
            run=lambda: self._isa_index.query_ids(
                cells, t_start=e_ns, t_end=l_ns, now=e_ns,
                allow_stale=allow_stale,
            ),
            t_end_of=self._isa_t_end,
        )
        out = []
        for i in ids:
            isa = self._isas.get(i)
            if isa is not None:
                out.append(_copy_rec(isa))
        return out

    def _isa_t_end(self, i) -> Optional[int]:
        isa = self._isas.get(i)
        return None if isa is None else to_nanos(isa.end_time)

    def _rid_sub_t_end(self, i) -> Optional[int]:
        sub = self._subs.get(i)
        return None if sub is None else to_nanos(sub.end_time)

    # -- Subscriptions -------------------------------------------------------

    def get_subscription(self, id):
        sub = self._subs.get(id)
        return dataclasses.replace(sub) if sub else None

    def _index_sub(self, sub):
        self._sub_index.put(
            sub.id,
            sub.cells,
            sub.altitude_lo,
            sub.altitude_hi,
            to_nanos(sub.start_time),
            to_nanos(sub.end_time),
            self._owners.intern(sub.owner),
        )

    def insert_subscription(self, sub):
        with self._txn_scope():
            old = self._subs.get(sub.id)
            if sub.version is None or sub.version.empty:
                if old is not None:
                    raise errors.internal(
                        "insert of existing subscription (precheck bypassed)"
                    )
            else:
                if old is None or not sub.version.matches(old.version):
                    return None
            stored = dataclasses.replace(
                sub, version=Version.from_time(self._ts.commit_ts())
            )
            self._subs[stored.id] = stored
            self._index_sub(stored)
            rec = {"t": "rid_sub_put", "doc": codec.rid_sub_to_doc(stored)}
            if self._capture_undo:
                rec["undo"] = [
                    {"t": "rid_sub_put", "doc": codec.rid_sub_to_doc(old)}
                    if old is not None
                    else {"t": "rid_sub_del", "id": stored.id}
                ]
            self._journal(rec)
            return dataclasses.replace(stored)

    def delete_subscription(self, sub):
        with self._txn_scope():
            old = self._subs.get(sub.id)
            if (
                old is None
                or old.owner != sub.owner
                or sub.version is None
                or not sub.version.matches(old.version)
            ):
                return None
            del self._subs[sub.id]
            self._sub_index.remove(sub.id)
            rec = {"t": "rid_sub_del", "id": sub.id}
            if self._capture_undo:
                rec["undo"] = [
                    {"t": "rid_sub_put", "doc": codec.rid_sub_to_doc(old)}
                ]
            self._journal(rec)
            return dataclasses.replace(old)

    def search_subscriptions(self, cells):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("no location provided")
        cells = canonical_cells(cells)
        now = self._now_ns()
        ids = self._cached_ids(
            "rid_sub", self._sub_index, cells,
            qkey=(), now_ns=now, allow_stale=False,
            run=lambda: self._sub_index.query_ids(cells, now=now),
            t_end_of=self._rid_sub_t_end,
        )
        out = []
        for i in ids:
            sub = self._subs.get(i)
            if sub is not None:
                out.append(_copy_rec(sub))
        return out

    def search_subscriptions_by_owner(self, cells, owner):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("no location provided")
        cells = canonical_cells(cells)
        now = self._now_ns()
        oid = self._owners.intern(owner)
        ids = self._cached_ids(
            "rid_sub", self._sub_index, cells,
            qkey=(), now_ns=now, allow_stale=False,
            run=lambda: self._sub_index.query_ids(
                cells, now=now, owner_id=oid
            ),
            t_end_of=self._rid_sub_t_end,
            owner_id=oid,
        )
        out = []
        for i in ids:
            sub = self._subs.get(i)
            if sub is not None:
                out.append(_copy_rec(sub))
        return out

    def max_subscription_count_in_cells_by_owner(self, cells, owner):
        return self._sub_index.max_owner_count(
            cells, self._owners.intern(owner), now=self._now_ns()
        )

    def update_notification_idxs_in_cells(self, cells, *, entity=None,
                                          removed=False):
        """Bump + return RID subscriptions intersecting cells.  The
        service passes the triggering ISA as `entity` so an attached
        push pipeline can fan the bump out as deliveries; without a
        pipeline the extra args are inert."""
        with self._txn_scope():
            ids = self._push_match_ids("rid_sub", cells)
            out = []
            undo = []
            for i in sorted(ids):
                if self._capture_undo:
                    prev = self._subs.get(i)
                    if prev is not None:
                        undo.append(
                            {"t": "rid_sub_put", "doc": codec.rid_sub_to_doc(prev)}
                        )
                bumped = _bump_sub(self._subs, i)
                if bumped is not None:
                    out.append(dataclasses.replace(bumped))
            if out:
                rec = {"t": "rid_sub_bump", "ids": [s.id for s in out]}
                if self._capture_undo:
                    rec["undo"] = undo
                self._journal(rec)
                self._offer_push("rid", entity, out, removed=removed)
            return out

    # -- WAL replay ----------------------------------------------------------

    def apply_wal(self, rec: dict):
        t = rec["t"]
        if t == "isa_put":
            isa = codec.doc_to_isa(rec["doc"])
            self._isas[isa.id] = isa
            self._index_isa(isa)
        elif t == "isa_del":
            self._isas.pop(rec["id"], None)
            self._isa_index.remove(rec["id"])
        elif t == "rid_sub_put":
            sub = codec.doc_to_rid_sub(rec["doc"])
            self._subs[sub.id] = sub
            self._index_sub(sub)
        elif t == "rid_sub_del":
            self._subs.pop(rec["id"], None)
            self._sub_index.remove(rec["id"])
        elif t == "rid_sub_bump":
            for i in rec["ids"]:
                _bump_sub(self._subs, i)


class SCDStoreImpl(_PushMixin, _TxnTimeMixin, _CachedSearchMixin, SCDStore):
    def index_stats(self) -> dict:
        return self._op_index.stats()

    def sub_index_stats(self) -> dict:
        return self._sub_index.stats()

    def cst_index_stats(self) -> dict:
        return self._cst_index.stats()

    def __init__(
        self, *, clock, ts_oracle, owners, lock, journal, index_factory,
        txn=None, capture_undo=False, cache=None, epoch_fn=None,
    ):
        self._clock = clock
        self._ts = ts_oracle
        self._owners = owners
        self._lock = lock
        self._txn = txn if txn is not None else _lock_txn(lock)
        self._journal = journal
        self._index_factory = index_factory
        # region mode: each journal record carries an "undo" list (wal
        # records that revert the mutation) so the coordinator can roll
        # back an aborted txn precisely instead of resyncing from the log
        self._capture_undo = capture_undo
        self._init_txn_time()
        self._init_cache(cache, epoch_fn)
        self._ops: Dict[str, scdm.Operation] = {}
        self._subs: Dict[str, scdm.Subscription] = {}
        self._csts: Dict[str, scdm.Constraint] = {}
        self._op_index = index_factory()
        self._sub_index = index_factory()
        self._cst_index = index_factory()

    def reset_state(self):
        """Drop all local state (region resync rebuilds from the log);
        _fenced_index_swap keeps the cache coherent — see RIDStoreImpl."""
        new_op, new_sub, new_cst = self._fenced_index_swap(
            self._op_index, self._sub_index, self._cst_index
        )
        self._ops = {}
        self._subs = {}
        self._csts = {}
        self._op_index = new_op
        self._sub_index = new_sub
        self._cst_index = new_cst

    def serialize_state(self) -> dict:
        """Full-state snapshot as plain JSON docs (region snapshot
        upload; the CRDB-range-snapshot analog)."""
        return self.serialize_refs(self.snapshot_refs())

    def snapshot_refs(self) -> tuple:
        """Record references for a consistent cut (cheap; call under
        the store lock); serialize_refs may then run outside it."""
        return (
            list(self._ops.values()),
            list(self._subs.values()),
            list(self._csts.values()),
        )

    @staticmethod
    def serialize_refs(refs: tuple) -> dict:
        ops, subs, csts = refs
        return {
            "ops": [codec.op_to_doc(x) for x in ops],
            "subs": [codec.scd_sub_to_doc(x) for x in subs],
            "constraints": [codec.constraint_to_doc(x) for x in csts],
        }

    def restore_state(self, state: dict) -> None:
        """Region snapshot install: reset, then one index put per
        record, as the WAL replay does."""
        self.reset_state()
        for d in state.get("ops", []):
            op = codec.doc_to_op(d)
            self._ops[op.id] = op
            self._index_op(op)
        for d in state.get("subs", []):
            sub = codec.doc_to_scd_sub(d)
            self._subs[sub.id] = sub
            self._index_scd_sub(sub)
        # absent on pre-constraint snapshots (rolling upgrade): .get
        for d in state.get("constraints", []):
            cst = codec.doc_to_constraint(d)
            self._csts[cst.id] = cst
            self._index_cst(cst)

    def _visible_op(self, id) -> Optional[scdm.Operation]:
        """Expired operations are invisible (operations.go:103-112)."""
        op = self._ops.get(id)
        if op is None or to_nanos(op.end_time) < self._now_ns():
            return None
        return op

    def _visible_sub(self, id) -> Optional[scdm.Subscription]:
        sub = self._subs.get(id)
        if sub is None or to_nanos(sub.end_time) < self._now_ns():
            return None
        return sub

    def _visible_cst(self, id) -> Optional[scdm.Constraint]:
        """Expired constraints are invisible, same rule as operations."""
        cst = self._csts.get(id)
        if cst is None or to_nanos(cst.end_time) < self._now_ns():
            return None
        return cst

    # -- Operations ----------------------------------------------------------

    def get_operation(self, id):
        op = self._visible_op(id)
        if op is None:
            raise errors.not_found(id)
        return dataclasses.replace(op)

    def _index_op(self, op):
        self._op_index.put(
            op.id,
            op.cells,
            op.altitude_lower,
            op.altitude_upper,
            to_nanos(op.start_time),
            to_nanos(op.end_time),
            self._owners.intern(op.owner),
        )

    def _index_scd_sub(self, sub):
        self._sub_index.put(
            sub.id,
            sub.cells,
            sub.altitude_lo,
            sub.altitude_hi,
            to_nanos(sub.start_time),
            to_nanos(sub.end_time),
            self._owners.intern(sub.owner),
        )

    def _index_cst(self, cst):
        self._cst_index.put(
            cst.id,
            cst.cells,
            cst.altitude_lower,
            cst.altitude_upper,
            to_nanos(cst.start_time),
            to_nanos(cst.end_time),
            self._owners.intern(cst.owner),
        )

    def _op_t_end(self, i) -> Optional[int]:
        op = self._ops.get(i)
        return None if op is None else to_nanos(op.end_time)

    def _scd_sub_t_end(self, i) -> Optional[int]:
        sub = self._subs.get(i)
        return None if sub is None else to_nanos(sub.end_time)

    def _cst_t_end(self, i) -> Optional[int]:
        cst = self._csts.get(i)
        return None if cst is None else to_nanos(cst.end_time)

    def _search_ops(
        self, cells, alt_lo, alt_hi, earliest, latest, *, allow_stale=False
    ):
        # ONE cached integration point for every operation search:
        # public SEARCH, OVN-conflict prechecks, dependent-operation
        # resolution.  A fenced hit is bit-identical to the fresh path
        # (the precheck runs under the pinned txn timestamp, which is
        # exactly the `now` the cache re-filters at), so serving
        # write-safety checks from it is sound.
        cells = canonical_cells(cells)
        t0_ns = None if earliest is None else to_nanos(earliest)
        t1_ns = None if latest is None else to_nanos(latest)
        now = self._now_ns()
        ids = self._cached_ids(
            "op", self._op_index, cells,
            qkey=(
                None if alt_lo is None else float(alt_lo),
                None if alt_hi is None else float(alt_hi),
                t0_ns, t1_ns,
            ),
            now_ns=now, allow_stale=allow_stale,
            run=lambda: self._op_index.query_ids(
                cells,
                alt_lo=alt_lo,
                alt_hi=alt_hi,
                t_start=t0_ns,
                t_end=t1_ns,
                now=now,
                allow_stale=allow_stale,
            ),
            t_end_of=self._op_t_end,
        )
        # .get(): a concurrent delete between the index query and this
        # assembly must skip, not KeyError (reads are lock-free)
        out = []
        for i in sorted(ids):
            op = self._ops.get(i)
            if op is not None:
                out.append(_copy_rec(op))
        return out

    def search_operations(
        self, cells, alt_lo, alt_hi, earliest, latest, *, allow_stale=False
    ):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        return self._search_ops(
            cells, alt_lo, alt_hi, earliest, latest, allow_stale=allow_stale
        )

    def _search_csts(
        self, cells, alt_lo, alt_hi, earliest, latest, *, allow_stale=False
    ):
        """ONE cached integration point for every constraint search
        (public QUERY + the constraint-aware OVN precheck), the mirror
        of _search_ops: fenced hits are bit-identical to the fresh
        path, so serving write-safety checks from the cache is sound
        for the fifth class exactly as for the other four."""
        cells = canonical_cells(cells)
        t0_ns = None if earliest is None else to_nanos(earliest)
        t1_ns = None if latest is None else to_nanos(latest)
        now = self._now_ns()
        ids = self._cached_ids(
            "constraint", self._cst_index, cells,
            qkey=(
                None if alt_lo is None else float(alt_lo),
                None if alt_hi is None else float(alt_hi),
                t0_ns, t1_ns,
            ),
            now_ns=now, allow_stale=allow_stale,
            run=lambda: self._cst_index.query_ids(
                cells,
                alt_lo=alt_lo,
                alt_hi=alt_hi,
                t_start=t0_ns,
                t_end=t1_ns,
                now=now,
                allow_stale=allow_stale,
            ),
            t_end_of=self._cst_t_end,
        )
        out = []
        for i in sorted(ids):
            cst = self._csts.get(i)
            if cst is not None:
                out.append(_copy_rec(cst))
        return out

    def search_constraints(
        self, cells, alt_lo, alt_hi, earliest, latest, *, allow_stale=False
    ):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        return self._search_csts(
            cells, alt_lo, alt_hi, earliest, latest, allow_stale=allow_stale
        )

    def _notify_subs_locked(
        self, cells, *, trigger: str = "operations",
        alt_lo=None, alt_hi=None, t_start=None, t_end=None,
    ) -> List[scdm.Subscription]:
        """Bump + return live subscriptions intersecting cells whose
        notification trigger matches the writing entity class
        (subscriptions.go:128-173): operation writes bump
        notify_for_operations subscriptions, constraint writes bump
        notify_for_constraints ones.  Constraint callers additionally
        pass the write's altitude/time window so only subscriptions
        whose 4D volumes intersect the constraint fan out (an airport
        closure must not wake a subscriber watching a different
        altitude band).

        With a push pipeline attached the id lookup rides the
        planner's rqmatch route (dss_tpu/push/match.py) — the write IS
        a reverse query — instead of the read-side coalescer; the
        MatchStage contract keeps the id set bit-identical, so the
        returned subscriber list (and the response built from it)
        cannot change."""
        ids = self._push_match_ids(
            "scd_sub", cells, alt_lo=alt_lo, alt_hi=alt_hi,
            t_start_ns=None if t_start is None else to_nanos(t_start),
            t_end_ns=None if t_end is None else to_nanos(t_end),
        )
        want_constraints = trigger == "constraints"
        out = []
        undo = []
        for i in sorted(ids):
            prev = self._subs.get(i)
            if prev is None:
                continue
            if want_constraints:
                if not prev.notify_for_constraints:
                    continue
            elif not prev.notify_for_operations:
                continue
            if self._capture_undo:
                undo.append(
                    {"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(prev)}
                )
            bumped = _bump_sub(self._subs, i)
            if bumped is not None:
                out.append(dataclasses.replace(bumped))
        if out:
            rec = {"t": "scd_sub_bump", "ids": [s.id for s in out]}
            if self._capture_undo:
                rec["undo"] = undo
            self._journal(rec)
        return out

    def _precheck_op_upsert(self, op, key, *, check_key: bool = True):
        """All upsert preconditions (version fencing, ownership, time
        range, OVN key check — operations.go:305-364), no mutation.
        Returns the old record (or None).  check_key=False skips the
        (expensive) OVN conflict search — only valid when the caller
        already ran it inside the same transaction scope (the pinned
        txn timestamp guarantees the same visibility answers)."""
        old = self._visible_op(op.id)
        if old is None and op.version != 0:
            raise errors.not_found(op.id)
        if old is not None and op.version == 0:
            raise errors.already_exists(op.id)
        if old is not None and op.version != old.version:
            raise errors.version_mismatch("old version")
        if old is not None and old.owner != op.owner:
            raise errors.permission_denied(
                f"Operation is owned by {old.owner}"
            )
        op.validate_time_range()

        if check_key and op.state in scdm.OperationState.REQUIRES_KEY:
            conflicting = self._search_ops(
                op.cells,
                op.altitude_lower,
                op.altitude_upper,
                op.start_time,
                op.end_time,
            )
            key_set = set(key)
            missing = [c for c in conflicting if c.ovn not in key_set]
            if op.constraint_aware:
                # constraint-aware deconfliction: the op's USS consumes
                # constraint updates, so its key must also cover every
                # intersecting constraint's OVN — a stale view of an
                # airspace closure is exactly the conflict the key
                # check exists to catch
                missing.extend(
                    c
                    for c in self._search_csts(
                        op.cells,
                        op.altitude_lower,
                        op.altitude_upper,
                        op.start_time,
                        op.end_time,
                    )
                    if c.ovn not in key_set
                )
            if missing:
                raise errors.missing_ovns(missing)
        return old

    def validate_operation_upsert(self, op, key):
        """Read-only precheck, run by the service BEFORE any journaled
        mutation (e.g. the implicit subscription) so a rejected conflict
        — a routine outcome — aborts the transaction with an empty
        journal buffer: nothing to roll back, no region resync.  The
        upsert that follows (with key_checked=True) re-runs only the
        cheap fencing checks; the pinned per-txn timestamp keeps both
        passes' visibility answers identical."""
        with self._txn_scope():
            self._precheck_op_upsert(op, key)

    def upsert_operation(self, op, key, *, key_checked: bool = False):
        with self._txn_scope():
            old = self._precheck_op_upsert(
                op, key, check_key=not key_checked
            )
            ts = self._ts.commit_ts()
            stored = dataclasses.replace(
                op,
                version=(old.version if old else 0) + 1,
                ovn=new_ovn_from_time(ts, op.id),
            )
            if self._capture_undo:
                # exact inverse: restore whatever the id maps to NOW,
                # including an expired (invisible) record `old` misses
                prev_raw = self._ops.get(op.id)
                undo = [
                    {"t": "scd_op_put", "doc": codec.op_to_doc(prev_raw)}
                    if prev_raw is not None
                    else {"t": "scd_op_del", "id": stored.id}
                ]
            self._ops[stored.id] = stored
            self._index_op(stored)
            rec = {"t": "scd_op_put", "doc": codec.op_to_doc(stored)}
            if self._capture_undo:
                rec["undo"] = undo
            self._journal(rec)
            subs = self._notify_subs_locked(stored.cells)
            self._offer_push(
                "operations", stored, subs,
                emergency=stored.state in (
                    scdm.OperationState.NON_CONFORMING,
                    scdm.OperationState.CONTINGENT,
                ),
                alt_lo=stored.altitude_lower,
                alt_hi=stored.altitude_upper,
                t_start=stored.start_time, t_end=stored.end_time,
            )
            return dataclasses.replace(stored), subs

    def delete_operation(self, id, owner):
        with self._txn_scope():
            old = self._visible_op(id)
            if old is None:
                raise errors.not_found(id)
            if old.owner != owner:
                raise errors.permission_denied(f"Operation is owned by {old.owner}")
            subs = self._notify_subs_locked(old.cells)
            del self._ops[id]
            self._op_index.remove(id)
            rec = {"t": "scd_op_del", "id": id}
            if self._capture_undo:
                rec["undo"] = [{"t": "scd_op_put", "doc": codec.op_to_doc(old)}]
            self._journal(rec)
            # implicit-subscription GC (operations.go:249-267,296-298)
            sub = self._subs.get(old.subscription_id)
            if (
                sub is not None
                and sub.implicit_subscription
                and sub.owner == owner
                and not any(
                    o.subscription_id == sub.id for o in self._ops.values()
                )
            ):
                del self._subs[sub.id]
                self._sub_index.remove(sub.id)
                gc_rec = {"t": "scd_sub_del", "id": sub.id}
                if self._capture_undo:
                    gc_rec["undo"] = [
                        {"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(sub)}
                    ]
                self._journal(gc_rec)
            self._offer_push(
                "operations", old, subs, removed=True,
                alt_lo=old.altitude_lower, alt_hi=old.altitude_upper,
                t_start=old.start_time, t_end=old.end_time,
            )
            return dataclasses.replace(old), subs

    # -- Constraints ---------------------------------------------------------
    #
    # The fifth entity class, beyond the reference (which stubs it):
    # same fencing/ownership discipline as operations, fan-out to
    # notify_for_constraints subscriptions whose 4D volumes intersect
    # the write, no OVN key check on the constraint itself.

    def get_constraint(self, id):
        cst = self._visible_cst(id)
        if cst is None:
            raise errors.not_found(id)
        return dataclasses.replace(cst)

    def upsert_constraint(self, cst):
        with self._txn_scope():
            old = self._visible_cst(cst.id)
            if old is None and cst.version != 0:
                raise errors.not_found(cst.id)
            if old is not None and cst.version == 0:
                raise errors.already_exists(cst.id)
            if old is not None and cst.version != old.version:
                raise errors.version_mismatch("old version")
            if old is not None and old.owner != cst.owner:
                raise errors.permission_denied(
                    f"Constraint is owned by {old.owner}"
                )
            cst.validate_time_range()
            ts = self._ts.commit_ts()
            stored = dataclasses.replace(
                cst,
                version=(old.version if old else 0) + 1,
                ovn=new_ovn_from_time(ts, cst.id),
            )
            if self._capture_undo:
                # exact inverse: raw get includes an expired
                # (invisible) record that `old` misses
                prev_raw = self._csts.get(cst.id)
                undo = [
                    {"t": "scd_cst_put",
                     "doc": codec.constraint_to_doc(prev_raw)}
                    if prev_raw is not None
                    else {"t": "scd_cst_del", "id": stored.id}
                ]
            self._csts[stored.id] = stored
            self._index_cst(stored)
            rec = {"t": "scd_cst_put", "doc": codec.constraint_to_doc(stored)}
            if self._capture_undo:
                rec["undo"] = undo
            self._journal(rec)
            subs = self._notify_subs_locked(
                stored.cells, trigger="constraints",
                alt_lo=stored.altitude_lower, alt_hi=stored.altitude_upper,
                t_start=stored.start_time, t_end=stored.end_time,
            )
            self._offer_push(
                "constraints", stored, subs,
                alt_lo=stored.altitude_lower,
                alt_hi=stored.altitude_upper,
                t_start=stored.start_time, t_end=stored.end_time,
            )
            return dataclasses.replace(stored), subs

    def delete_constraint(self, id, owner):
        with self._txn_scope():
            old = self._visible_cst(id)
            if old is None:
                raise errors.not_found(id)
            if old.owner != owner:
                raise errors.permission_denied(
                    f"Constraint is owned by {old.owner}"
                )
            subs = self._notify_subs_locked(
                old.cells, trigger="constraints",
                alt_lo=old.altitude_lower, alt_hi=old.altitude_upper,
                t_start=old.start_time, t_end=old.end_time,
            )
            del self._csts[id]
            self._cst_index.remove(id)
            rec = {"t": "scd_cst_del", "id": id}
            if self._capture_undo:
                rec["undo"] = [
                    {"t": "scd_cst_put", "doc": codec.constraint_to_doc(old)}
                ]
            self._journal(rec)
            self._offer_push(
                "constraints", old, subs, removed=True,
                alt_lo=old.altitude_lower, alt_hi=old.altitude_upper,
                t_start=old.start_time, t_end=old.end_time,
            )
            return dataclasses.replace(old), subs

    # -- Subscriptions -------------------------------------------------------

    def _dependent_ops(self, sub) -> List[str]:
        """The reference populates DependentOperations with the ids of
        operations intersecting the subscription's own 4D volume
        (subscriptions.go:212-249)."""
        if len(np.asarray(sub.cells).ravel()) == 0:
            return []
        ops = self._search_ops(
            sub.cells, sub.altitude_lo, sub.altitude_hi, sub.start_time, sub.end_time
        )
        return [o.id for o in ops]

    def get_subscription(self, id, owner):
        sub = self._visible_sub(id)
        if sub is None or sub.owner != owner:
            raise errors.not_found(id)
        out = dataclasses.replace(sub)
        out.dependent_operations = self._dependent_ops(sub)
        return out

    def upsert_subscription(self, sub):
        with self._txn_scope():
            old = self._visible_sub(sub.id)
            if old is None and sub.version != 0:
                raise errors.not_found(sub.id)
            if old is not None and sub.version == 0:
                raise errors.already_exists(sub.id)
            if old is not None and sub.version != old.version:
                raise errors.version_mismatch("old version")
            if old is not None and old.owner != sub.owner:
                raise errors.permission_denied(
                    f"Subscription is owned by {old.owner}"
                )
            count = self._sub_index.max_owner_count(
                sub.cells, self._owners.intern(sub.owner), now=self._now_ns()
            )
            if count >= MAX_SCD_SUBSCRIPTIONS_PER_AREA:
                msg = "too many existing subscriptions in this area already"
                if old is not None:
                    msg += ", rejecting update request"
                raise errors.exhausted(msg)
            stored = dataclasses.replace(
                sub, version=(old.version if old else 0) + 1
            )
            if self._capture_undo:
                # exact inverse: raw get includes an expired (invisible)
                # record that `old` (visibility-filtered) misses
                prev_raw = self._subs.get(sub.id)
                undo = [
                    {"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(prev_raw)}
                    if prev_raw is not None
                    else {"t": "scd_sub_del", "id": stored.id}
                ]
            self._subs[stored.id] = stored
            self._index_scd_sub(stored)
            rec = {"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(stored)}
            if self._capture_undo:
                rec["undo"] = undo
            self._journal(rec)
            affected = (
                self._search_ops(
                    stored.cells,
                    stored.altitude_lo,
                    stored.altitude_hi,
                    stored.start_time,
                    stored.end_time,
                )
                if len(np.asarray(stored.cells).ravel())
                else []
            )
            return dataclasses.replace(stored), affected

    def delete_subscription(self, id, owner, version):
        with self._txn_scope():
            old = self._visible_sub(id)
            if old is None:
                raise errors.not_found(id)
            if version != 0 and version != old.version:
                raise errors.version_mismatch("old version")
            if old.owner != owner:
                raise errors.permission_denied(f"ISA is owned by {old.owner}")
            if any(o.subscription_id == id for o in self._ops.values()):
                raise errors.bad_request(
                    "failed to delete implicit subscription with active operation"
                )
            del self._subs[id]
            self._sub_index.remove(id)
            rec = {"t": "scd_sub_del", "id": id}
            if self._capture_undo:
                rec["undo"] = [
                    {"t": "scd_sub_put", "doc": codec.scd_sub_to_doc(old)}
                ]
            self._journal(rec)
            return dataclasses.replace(old)

    def search_subscriptions(self, cells, owner):
        """Live subscriptions of `owner` intersecting cells.

        The reference's SQL uses a LEFT JOIN (subscriptions.go:500-521)
        which in effect ignores the cell filter; we implement the
        intended inner-join semantics (cells do filter).
        """
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("no location provided")
        cells = canonical_cells(cells)
        now = self._now_ns()
        oid = self._owners.intern(owner)
        ids = self._cached_ids(
            "scd_sub", self._sub_index, cells,
            qkey=(), now_ns=now, allow_stale=False,
            run=lambda: self._sub_index.query_ids(
                cells, now=now, owner_id=oid
            ),
            t_end_of=self._scd_sub_t_end,
            owner_id=oid,
        )
        out = []
        for i in sorted(ids):
            sub = self._subs.get(i)
            if sub is None:
                continue
            s = _copy_rec(sub)
            # dependent ops resolve fresh each time (and their inner
            # _search_ops calls ride the cache themselves)
            s.dependent_operations = self._dependent_ops(sub)
            out.append(s)
        return out

    # -- WAL replay ----------------------------------------------------------

    def apply_wal(self, rec: dict):
        t = rec["t"]
        if t == "scd_op_put":
            op = codec.doc_to_op(rec["doc"])
            self._ops[op.id] = op
            self._index_op(op)
        elif t == "scd_op_del":
            self._ops.pop(rec["id"], None)
            self._op_index.remove(rec["id"])
        elif t == "scd_sub_put":
            sub = codec.doc_to_scd_sub(rec["doc"])
            self._subs[sub.id] = sub
            self._index_scd_sub(sub)
        elif t == "scd_sub_del":
            self._subs.pop(rec["id"], None)
            self._sub_index.remove(rec["id"])
        elif t == "scd_sub_bump":
            for i in rec["ids"]:
                _bump_sub(self._subs, i)
        elif t == "scd_cst_put":
            cst = codec.doc_to_constraint(rec["doc"])
            self._csts[cst.id] = cst
            self._index_cst(cst)
        elif t == "scd_cst_del":
            self._csts.pop(rec["id"], None)
            self._cst_index.remove(rec["id"])


class DSSStore:
    """One DSS instance's storage: RID + SCD stores sharing a lock, a
    commit-timestamp oracle, an owner interner, and a durable log.

    Two durability modes, as in the reference:
      - standalone (default): a local WriteAheadLog is the source of
        truth; boot replays it, one `apply_wal` -> `index.put` per
        record.
      - region (`region_url` set): the shared region log
        (dss_tpu_torch.region) is the source of truth; every mutation
        runs as a region transaction (an optimistic disjoint-cell
        append, or a lease-fenced one), and a tail poller applies
        remote instances' writes.  Boot restores the log's latest
        snapshot (one index put per record, as the WAL replay) and
        applies the tail after it.  The local WAL is disabled (the
        region server owns durability), as the upstream DSS's instances
        keep no local state beside the shared CRDB cluster.

    `storage="cuda"` puts every entity class's DarTable on `device`
    (None means `cuda`, so without a card the default raises);
    `storage="memory"` uses the linear-scan MemorySpatialIndex."""

    def __init__(
        self,
        *,
        storage: str = "cuda",
        clock: Optional[Clock] = None,
        wal_path: Optional[str] = None,
        wal_fsync: bool = False,
        device=None,
        region_url: Optional[str] = None,
        region_token: Optional[str] = None,
        region_poll_interval_s: float = 0.05,
        region_snapshot_every: int = 512,
        region_optimistic: bool = True,  # False forces the lease path
        #                    (bench/diagnosis of lease-path round trips)
        instance_id: Optional[str] = None,
    ):
        if storage == "cuda":
            index_factory = functools.partial(CudaSpatialIndex, device=device)
        elif storage == "memory":
            index_factory = MemorySpatialIndex
        else:
            raise ValueError(f"unknown storage backend {storage!r}")
        if region_url and wal_path:
            raise ValueError(
                "wal_path is unused in region mode: the region log server "
                "owns durability (give the WAL path to the region server)"
            )
        self.storage = storage
        self.clock = clock or Clock()
        # the graceful-degradation ladder (chaos/ladder.py): ONE
        # explicit health state machine for this store — the planner
        # reads device_ok from it, the region client drives
        # REGION_LOG_DOWN into it, and recovery re-warms (the graph
        # grid) before re-admitting routes.  Surfaced in /status,
        # X-DSS-Freshness, and the dss_degraded_mode gauge.
        self.health = chaos.DegradationLadder()
        self.health.on_recover("device_lost", self._rewarm_after_device_loss)
        self.wal = WriteAheadLog(None if region_url else wal_path,
                                 fsync=wal_fsync)
        self._lock = threading.RLock()
        self.region = None
        txn = None
        epoch_fn = None
        if region_url:
            from dss_tpu_torch.region.client import RegionClient
            from dss_tpu_torch.region.coordinator import RegionCoordinator

            self._region_client = RegionClient(
                region_url, instance_id, auth_token=region_token,
                health=self.health,
            )
            txn = self._region_txn
            # region epoch joins the cache fence: a promotion or a
            # restored-backup rotation invalidates every cached answer
            epoch_fn = self._region_client.current_epoch
        # version-fenced read cache (dar/readcache.py): one shared
        # instance fronting all five entity classes' search paths;
        # DSS_CACHE_* env knobs, configure_serving(cache=) at runtime
        self.cache = rcache.ReadCache(**rcache.env_knobs())
        # per-key-range query-load EWMA (dar/tiers.py RangeLoad): one
        # shared map across all five classes — they cover one S2 key
        # space.  Coalescer-served traffic stamps it below.
        self.range_load = tiersmod.RangeLoad()
        ts = TimestampOracle(self.clock)
        owners = OwnerInterner()
        self.rid = RIDStoreImpl(
            clock=self.clock,
            ts_oracle=ts,
            owners=owners,
            lock=self._lock,
            journal=self._journal,
            index_factory=index_factory,
            txn=txn,
            capture_undo=bool(region_url),
            cache=self.cache,
            epoch_fn=epoch_fn,
        )
        self.scd = SCDStoreImpl(
            clock=self.clock,
            ts_oracle=ts,
            owners=owners,
            lock=self._lock,
            journal=self._journal,
            index_factory=index_factory,
            txn=txn,
            capture_undo=bool(region_url),
            cache=self.cache,
            epoch_fn=epoch_fn,
        )
        # per-class cache hit/miss counters ride the coalescer stats
        # path (dss_dar_<class>_co_cache_*), so hit rate renders next
        # to the route mix it removes load from
        for index, cls in self._class_indexes():
            co = getattr(index, "coalescer", None)
            if co is not None:
                co.set_cache_view(
                    lambda cls=cls: self.cache.class_stats(cls)
                )
                co.set_load_view(self.range_load)
                co.set_health(self.health)
        # multi-region federation (region/federation.py): None until
        # attach_federation wraps the sub-stores with the locality
        # router; stats() exports the stable dss_fed_* key set either
        # way so dashboards never miss a series
        self.federation = None
        # reverse-query push pipeline (push/pipeline.py): None until
        # attach_push wires the durable delivery queue onto the write
        # path; stats() exports the stable dss_push_* key set either way
        self.push = None
        # shared-memory serving front (parallel/shmring.py): None
        # until attach_shm_front makes this process the device owner
        self._shm_owner = None
        # self-tuning controller (tune/controller.py): None until
        # attach_tuner; stats() exports the stable dss_tune_* key set
        # either way (DSS_TUNE=0 builds nothing, installs no hook)
        self.tune = None
        self._replaying = False
        if region_url:
            self.region = RegionCoordinator(
                self._region_client,
                self.rid,
                self.scd,
                self._lock,
                poll_interval_s=region_poll_interval_s,
                snapshot_every=region_snapshot_every,
                optimistic=region_optimistic,
            )
            try:
                self.region.bootstrap()
            except BaseException:
                self._region_client.close()
                raise
        else:
            self._replay()

    def _region_txn(self):
        return self.region.txn()

    def _class_indexes(self):
        return (
            (self.rid._isa_index, "isa"),
            (self.rid._sub_index, "rid_sub"),
            (self.scd._op_index, "op"),
            (self.scd._sub_index, "scd_sub"),
            (self.scd._cst_index, "constraint"),
        )

    def _rewarm_after_device_loss(self) -> None:
        """Recovery hook (ladder.on_recover): a returning device must
        be warm BEFORE the planner re-admits the device class, or the
        first post-recovery batches pay graph captures inside their
        deadlines.  Best-effort — a failed warm only means lazy
        warm-on-traffic, exactly the cold-boot behavior."""
        try:
            self.warm_resident()
        except Exception:  # noqa: BLE001 — recovery must not wedge
            logging.getLogger("dss.chaos").exception(
                "post-device-loss re-warm failed; warming lazily"
            )

    def _journal(self, rec: dict):
        if self._replaying:
            return
        if self.region is not None:
            self.region.journal(rec)
        else:
            self.wal.append(rec)

    def apply_log_record(self, rec: dict) -> None:
        """Apply one WAL/region-log record to the right sub-store
        (caller holds the lock and has set _replaying)."""
        t = rec.get("t", "")
        if t.startswith("isa") or t.startswith("rid"):
            self.rid.apply_wal(rec)
        else:
            self.scd.apply_wal(rec)

    def _replay(self):
        self._replaying = True
        try:
            for rec in self.wal.replay():
                self.apply_log_record(rec)
        finally:
            self._replaying = False

    def configure_serving(self, **knobs) -> None:
        """Fan serving-pipeline knobs (QueryCoalescer.configure:
        min_batch / max_batch / target_batch_ms / queue_depth /
        admission_wait_s / inline / slo_ms / resident, the device
        feeder loop that replays captured graphs) out to every entity
        class's coalescer.  Boot-time defaults come from DSS_CO_* env
        vars (coalesce.env_knobs).  No-op on the memory backend —
        except `cache`, the version-fenced read cache toggle, which
        applies on both backends (disable flushes)."""
        cache = knobs.pop("cache", None)
        if cache is not None:
            self.cache.configure(enabled=bool(cache))
        if not knobs:
            return
        for index, _ in self._class_indexes():
            co = getattr(index, "coalescer", None)
            if co is not None:
                co.configure(**knobs)

    def warm_resident(self) -> int:
        """Capture the resident graph grid for every entity class's
        current tiers (ops/resident.py GraphCache), where the reference
        AOT-compiles.  Call AFTER configure_serving(resident=True)
        attached the loops.  Returns graph entries built."""
        n = 0
        for index, _ in self._class_indexes():
            co = getattr(index, "coalescer", None)
            table = getattr(index, "table", None)
            if co is None or table is None:
                continue
            loop = co.resident_loop()
            if loop is None:
                continue
            n += table.warm_resident(loop.kernel)
        return n

    # -- shared-memory serving front (parallel/shmring.py) -------------------

    def _class_index(self, cls: str):
        return {
            "isa": self.rid._isa_index,
            "rid_sub": self.rid._sub_index,
            "op": self.scd._op_index,
            "scd_sub": self.scd._sub_index,
            "constraint": self.scd._cst_index,
        }[cls]

    def shm_serve(self, req) -> Tuple[List[str], List[int], int, int]:
        """Serve one shared-memory ring request (shmring.ShmRequest)
        through the SAME search paths HTTP requests take — admission,
        deadline routing, the planner, and the owner's read cache all
        apply — returning (ids, t_end ns per id, class generation,
        response flags).  The flags carry RESP_F_MESH_SERVED when the
        answer came from the bounded-stale mesh replica: the leader
        refuses to populate its own cache from such answers
        (_cached_ids), and the requesting worker must refuse too.

        Visibility is pinned to the WORKER's `now`: the request's
        clock instant rides the txn-time thread-local, so the answer
        is bit-identical to what the worker's own fresh path would
        have computed at that instant (expiry included).  The
        backwards-clock guards in the read cache already handle
        out-of-order nows across workers — this is the same contract
        as a txn-pinned precheck behind live pollers."""
        from dss_tpu_torch.clock import from_nanos

        cls = req.cls
        cells = canonical_cells(req.cells)
        sub = self.rid if cls in ("isa", "rid_sub") else self.scd
        tl = sub._txn_time
        pinned = getattr(tl, "now", None) is None
        if pinned:
            tl.now = int(req.now_ns)
        try:
            if cls == "isa":
                recs = sub.search_isas(
                    cells, from_nanos(req.t0_ns),
                    None if req.t1_ns is None else from_nanos(req.t1_ns),
                    allow_stale=req.allow_stale,
                )
            elif cls == "rid_sub":
                recs = (
                    sub.search_subscriptions_by_owner(cells, req.owner)
                    if req.owner
                    else sub.search_subscriptions(cells)
                )
            elif cls == "op":
                recs = sub.search_operations(
                    cells, req.alt_lo, req.alt_hi,
                    None if req.t0_ns is None else from_nanos(req.t0_ns),
                    None if req.t1_ns is None else from_nanos(req.t1_ns),
                    allow_stale=req.allow_stale,
                )
            elif cls == "constraint":
                recs = sub.search_constraints(
                    cells, req.alt_lo, req.alt_hi,
                    None if req.t0_ns is None else from_nanos(req.t0_ns),
                    None if req.t1_ns is None else from_nanos(req.t1_ns),
                    allow_stale=req.allow_stale,
                )
            elif cls == "scd_sub":
                # id-level serve: the worker resolves each sub's
                # dependent operations itself (through its own cached
                # op path), so the slot never carries nested lists
                now = int(req.now_ns)
                oid = (
                    sub._owners.intern(req.owner)
                    if req.owner else None
                )
                ids = sub._cached_ids(
                    "scd_sub", sub._sub_index, cells,
                    qkey=(), now_ns=now, allow_stale=False,
                    run=lambda: sub._sub_index.query_ids(
                        cells, now=now, owner_id=oid
                    ),
                    t_end_of=sub._scd_sub_t_end,
                    owner_id=oid,
                )
                out_ids, t1s = [], []
                for i in sorted(ids):
                    t1 = sub._scd_sub_t_end(i)
                    if t1 is None:
                        continue
                    out_ids.append(i)
                    t1s.append(t1)
                gen = sub._sub_index.cell_clock.generation
                return out_ids, t1s, gen, self._shm_resp_flags()
            else:
                raise errors.bad_request(f"unknown shm class {cls!r}")
        finally:
            if pinned:
                tl.now = None
        gen = self._class_index(cls).cell_clock.generation
        _never = np.iinfo(np.int64).max
        return (
            [r.id for r in recs],
            # a record with no end time never expires: int64 max keeps
            # the worker cache's t_end-refilter a no-op for it
            [
                _never if r.end_time is None else to_nanos(r.end_time)
                for r in recs
            ],
            gen,
            self._shm_resp_flags(),
        )

    @staticmethod
    def _shm_resp_flags() -> int:
        from dss_tpu_torch.parallel import shmring

        return (
            shmring.RESP_F_MESH_SERVED
            if rcache.take_last_search_meshed() else 0
        )

    def attach_shm_front(self, region, *, threads: int = None,
                         worker_ttl_s: float = 5.0):
        """Make this store the device owner of a shared-memory serving
        front: every entity class's cell clock broadcasts its bumps
        into the region's fence segment, and a ShmOwner drain serves
        ring requests through shm_serve.  Returns the started owner
        (the caller — cmds/server.py — reclaims dead workers' slots
        via owner.reclaim_worker)."""
        from dss_tpu_torch.parallel import shmring

        if self._shm_owner is not None:
            raise RuntimeError("shm front already attached")
        for idx, cls in enumerate(shmring.SHM_CLASSES):
            self._class_index(cls).cell_clock.attach_mirror(
                shmring.FenceMirror(region, idx)
            )
        owner = shmring.ShmOwner(
            region, self.shm_serve, threads=threads,
            wal_seq_fn=lambda: self.wal.seq,
            worker_ttl_s=worker_ttl_s,
        )
        owner.start()
        self._shm_owner = owner
        return owner

    def attach_federation(self, router) -> None:
        """Put the multi-region FederationRouter in front of the
        store: binds the UNWRAPPED sub-stores for peer-facing serving
        (a remote's query must never recurse through the federation
        layer), wires the degradation ladder (remote-unreachable ->
        FEDERATION_DEGRADED, recovery re-syncs the follower tail
        before re-admission), swaps self.rid/self.scd for the
        federated wrappers (searches federate, cells-carrying writes
        are ownership-guarded), and starts the mirror sync loop.
        Call BEFORE building services — they must see the wrappers."""
        from dss_tpu_torch.region import federation as fedmod

        if self.federation is not None:
            raise RuntimeError("federation already attached")
        epoch_fn = None
        if self.region is not None:
            epoch_fn = self._region_client.current_epoch
        router.bind_local(
            self.rid, self.scd, epoch_fn=epoch_fn,
            wall_clock=self.clock,
        )
        router.set_health(self.health)
        self.federation = router
        self.rid = fedmod.FederatedRIDStore(self.rid, router)
        self.scd = fedmod.FederatedSCDStore(self.scd, router)
        router.start()

    def attach_push(self, pipeline) -> None:
        """Wire the reverse-query push pipeline (push/pipeline.py) onto
        the write path: subscription-match lookups route through the
        pipeline's MatchStages (planner rqmatch candidate -> B1 on the
        card, host oracle fallback — bit-identical either way), matched
        writes fan out through the WAL-backed delivery queue, and the
        delivery workers start.  Ladder edges (PUSH_DEGRADED) ride the
        pipeline's own health hook."""
        if self.push is not None:
            raise RuntimeError("push pipeline already attached")
        pipeline.bind_store(self)
        getattr(self.rid, "_local", self.rid).set_push(pipeline)
        getattr(self.scd, "_local", self.scd).set_push(pipeline)
        self.push = pipeline

    def attach_tuner(self, controller) -> None:
        """Arm the self-tuning controller (tune/controller.py): record
        boot knob values (the rollback floor), install the planner
        decision-recorder hook, and start the observe/propose/shadow/
        guard loop.  Exactly one tuner per store — the recorder hook is
        a process-global seam."""
        if self.tune is not None:
            raise RuntimeError("tuner already attached")
        controller.start()
        self.tune = controller

    def tune_knob_values(self) -> dict:
        """Live values of every hot-swappable knob (tune.HOT_KNOBS),
        read off one representative coalescer's cost model + resident
        geometry — the tuner's current_fn, and the 'active' side of
        the Grafana knob panel.  {} on the memory backend (no
        coalescers: the tuner observes but can never propose)."""
        co = getattr(self.rid._isa_index, "coalescer", None)
        if co is None:
            return {}
        cost = co._planner.cost
        return {
            "DSS_CO_EST_FLOOR_MS": float(cost.est_floor_ms),
            "DSS_CO_EST_ITEM_MS": float(cost.est_item_ms),
            "DSS_CO_EST_CHUNK_MS": float(cost.est_chunk_ms),
            "DSS_CO_EST_RES_FLOOR_MS": float(cost.est_res_floor_ms),
            "DSS_CO_EST_RES_LAT_MS": float(cost.est_res_lat_ms),
            "DSS_CO_RES_INFLIGHT": float(co._res_inflight),
            "DSS_CO_RES_RING": float(co._res_ring),
        }

    def attach_mesh_replica(self, replica, min_batch: int = 64) -> None:
        """Route oversized bounded-staleness search batches from each
        entity class's coalescer to the multi-device replica
        (parallel/replica.py) when it is fresh.  Only queries flagged
        allow_stale (the service SEARCH paths) are eligible; conflict
        prechecks and transactional reads always serve locally."""
        for index, cls in (
            (self.rid._isa_index, "isas"),
            (self.rid._sub_index, "rid_subs"),
            (self.scd._op_index, "ops"),
            (self.scd._sub_index, "scd_subs"),
            (self.scd._cst_index, "constraints"),
        ):
            co = getattr(index, "coalescer", None)
            if co is None:
                continue  # memory backend: no coalescer tier

            def make(cls):
                def fn(keys_list, alo, ahi, ts, te, now_arr):
                    return replica.query_batch(
                        keys_list, alo, ahi, ts, te, now=now_arr, cls=cls
                    )

                return fn

            def bgen_fn(_r=replica):
                # plans record the shard placement generation they
                # were decided against
                return getattr(_r, "boundary_gen", 0)

            co.set_mesh_delegate(
                make(cls), replica.fresh, min_batch=min_batch,
                bgen_fn=bgen_fn,
            )
        # one load map: coalescer-served AND replica-served traffic
        # accumulate into the store's RangeLoad, which the replica's
        # rebalancer plans from at fold boundaries
        use_load = getattr(replica, "use_load", None)
        if use_load is not None:
            use_load(self.range_load)

    def close(self):
        # tuner first: clears the planner decision hook and stops the
        # loop before the coalescers it actuates start tearing down;
        # then push, whose delivery workers are joined before the
        # indexes (and their torch state) go away
        if self.tune is not None:
            self.tune.close()
        if self.push is not None:
            self.push.close()
        if self._shm_owner is not None:
            self._shm_owner.close()
        if self.federation is not None:
            self.federation.close()
        if self.region is not None:
            self.region.close()
            self._region_client.close()
        for index, _ in self._class_indexes():
            closer = getattr(index, "close", None)
            if closer is not None:
                closer()
        self.wal.close()

    def stats(self) -> dict:
        """Per-index gauges for /metrics (dss_dar_* names)."""
        out = {}
        for name, stats in (
            ("isa", self.rid.index_stats),
            ("rid_sub", self.rid.sub_index_stats),
            ("op", self.scd.index_stats),
            ("scd_sub", self.scd.sub_index_stats),
            ("constraint", self.scd.cst_index_stats),
        ):
            for k, v in stats().items():
                out[f"dss_dar_{name}_{k}"] = v
        # store-wide read-cache gauges (stable key set whether the
        # cache is enabled or not — dashboards expect the series)
        for k, v in self.cache.stats().items():
            out[f"dss_cache_{k}"] = v
        # per-key-range load accounting
        for k, v in self.range_load.stats().items():
            out[f"dss_{k}"] = v
        # degradation ladder + fault-injection + breaker gauges: the
        # key set is stable on every deployment (dict-valued entries
        # render as labeled families)
        out.update(self.health.stats())
        out["dss_fault_injected_total"] = (
            chaos.registry().injected_by_site()
        )
        breakers = {}
        if self.region is not None:
            fn = getattr(self._region_client, "breaker_states", None)
            if fn is not None:
                breakers = fn()
        out["dss_breaker_state"] = breakers
        # federation gauges: the stable key set whether or not a
        # router is attached (dss_fed_peer_state/mirror_lag_s render
        # as labeled families keyed by region)
        from dss_tpu_torch.region import federation as _fedmod

        if self.federation is not None:
            out.update(self.federation.stats())
        else:
            out.update(_fedmod.empty_stats())
        # shared-memory front gauges: same stable-key-set discipline
        # (per-worker counters render as dss_shm_worker_*{process})
        from dss_tpu_torch.parallel import shmring as _shmmod

        if self._shm_owner is not None:
            out.update(self._shm_owner.stats())
        else:
            out.update(_shmmod.empty_stats())
        # push-pipeline gauges: stable key set whether or not the
        # pipeline is attached (dss_push_breaker_state renders as a
        # labeled family keyed by uss)
        from dss_tpu_torch import push as _pushmod

        if self.push is not None:
            out.update(self.push.stats())
        else:
            out.update(_pushmod.empty_stats())
        # self-tuning gauges: stable key set whether or not a tuner is
        # attached (dss_tune_knob_active/_proposed render as labeled
        # families keyed by knob)
        from dss_tpu_torch import tune as _tunemod

        if self.tune is not None:
            out.update(self.tune.stats())
        else:
            out.update(_tunemod.empty_stats())
        # trace recorder gauges (obs/trace.py)
        out.update(trace.stats())
        if self.region is not None:
            out.update(self.region.stats())
        return out

    def freshness_status(self) -> dict:
        """Operator view of the version-fence state (GET /status):
        region epoch, per-class write generation + cell-clock
        high-water mark, and the cache counters — enough to verify
        fence behaviour without reading code."""
        classes = {}
        for index, name in self._class_indexes():
            clock = getattr(index, "cell_clock", None)
            classes[name] = {
                "generation": 0 if clock is None else clock.generation,
                "cell_clock_high_water": (
                    0 if clock is None else clock.high_water
                ),
                "live_records": index.stats().get("live_records", 0),
            }
        epoch = ""
        if self.region is not None:
            epoch = self._region_client.current_epoch()
        return {
            "storage": self.storage,
            "epoch": epoch,
            "cache": self.cache.stats(),
            "classes": classes,
            # the degradation ladder's operator view: current mode +
            # every active condition with its age and reason
            "degraded_mode": self.health.mode_name(),
            "degraded": self.health.active(),
            "federation": (
                None if self.federation is None
                else self.federation.status()
            ),
            "push": None if self.push is None else self.push.status(),
        }

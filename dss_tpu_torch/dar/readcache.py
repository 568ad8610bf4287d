"""Version-fenced read-result cache: repeat polls in microseconds.

The north-star traffic model is millions of USS clients *polling* the
same metro-area coverings at ~100:1 read-to-write ratios; before this
module every poll ran the full pipeline (admission, coalescer, route
choice, kernel or host scan).  The cache sits in the store's search
paths, IN FRONT of the coalescer: a hit never enqueues, never takes a
deadline stamp, never counts against the Retry-After backlog, and
never touches a device.

Correct by construction, not by TTL.  Every entry is stamped with

    (region epoch, index incarnation, cell-clock max, generation)

read from the per-cell write clock (tiers.CellClock) BEFORE the fresh
query ran.  A hit is served only when the fence holds:

  - the region epoch is unchanged (promotion/restore rotates it), and
  - the index incarnation is unchanged (region resync / restore_state
    replaces the index wholesale), and
  - no cell in the entry's covering has a newer clock stamp — the
    clock counter is global per index, so any later write touching any
    of the covering's cells stamps strictly past the entry's max.

`allow_stale` lookups additionally tolerate a bounded generation lag
(DSS_CACHE_STALE_LAG writes): the same bounded-staleness contract the
mesh-replica path already grants those queries.  Strict lookups are
bit-identical to the fresh path by the fence argument above plus one
time rule: the only clock-dependence of a search is `t_end >= now`
(records only ever EXPIRE out of a fixed 4D window), so entries carry
each hit's t_end and a hit re-applies the filter at the query's `now`.

Invalidation is the existing write path: DarTable.upsert/remove and
MemorySpatialIndex.put/remove bump the cell clock — locally, on WAL
replay, on region-log tail application at mirrors, everywhere writes
already flow.  No invalidation bus, no TTL, no background sweeper.

Why no TTL: a TTL trades staleness for hit rate and still re-runs the
query on every expiry; the fence serves indefinitely while the area is
quiet (the common poll case) and invalidates exactly on the write that
changed the answer.

Structure: a sharded-lock LRU (DSS_CACHE_SHARDS shards, each an
OrderedDict under its own lock) bounded by DSS_CACHE_CAP entries
total, keyed by (entity class, owner scope, query window, canonical
covering bytes) — the covering is canonicalized once at query ingress
(geo.covering.canonical_cells), shared with the pack path, so two
syntactically different requests for the same area hit the same line.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class _Entry(NamedTuple):
    epoch: str
    inc: int  # CellClock incarnation
    stamp: int  # cell-clock max over the covering at stamp time
    gen: int  # index generation at stamp time (stale-lag basis)
    now0: int  # the `now` (ns) the fresh answer was computed at
    min_t1: int  # min t_end over hits (fast path: no filtering needed)
    ids: Tuple[str, ...]
    t1s: np.ndarray  # i64 per id: t_end ns (the one time-variant filter)
    nbytes: int


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an int")


def env_knobs() -> dict:
    """ReadCache constructor kwargs from DSS_CACHE_* env vars
    (docs/OPERATIONS.md): capacity (entries), lock shards, the
    allow_stale generation-lag tolerance, and the enable switch."""
    # same boolean semantics (and typo rejection) as every other
    # DSS_* boolean knob
    from dss_tpu_torch.dar.coalesce import _env_bool

    raw = os.environ.get("DSS_CACHE_ENABLE")
    try:
        enabled = True if raw is None else _env_bool(raw)
    except ValueError:
        raise ValueError(
            f"DSS_CACHE_ENABLE={raw!r} is not a valid boolean"
        )
    return {
        "capacity": _env_int("DSS_CACHE_CAP", 8192),
        "shards": _env_int("DSS_CACHE_SHARDS", 8),
        "stale_lag": _env_int("DSS_CACHE_STALE_LAG", 0),
        "enabled": enabled,
    }


class ReadCache:
    """Sharded-lock LRU of version-fenced search results.  One
    instance per DSSStore, shared by all four entity classes (the
    class is part of the key; per-class hit/miss counters feed the
    coalescer stats path so dashboards see hits next to route mix)."""

    def __init__(self, *, capacity: int = 8192, shards: int = 8,
                 stale_lag: int = 0, enabled: bool = True):
        shards = max(1, int(shards))
        self._locks = [threading.Lock() for _ in range(shards)]
        self._maps: List[OrderedDict] = [
            OrderedDict() for _ in range(shards)
        ]
        self._bytes = [0] * shards
        self.capacity = max(1, int(capacity))
        self.stale_lag = max(0, int(stale_lag))
        self.enabled = bool(enabled)
        # counters: per-shard (guarded by the shard lock, summed by
        # stats()) so the hit path never contends on a global lock —
        # including the per-class [hits, misses, invalidations] rows
        # the coalescer stats view reads
        self._hits = [0] * shards
        self._misses = [0] * shards
        self._evictions = [0] * shards
        self._invalidations = [0] * shards
        self._stale_hits = [0] * shards
        self._cls: List[Dict[str, List[int]]] = [
            {} for _ in range(shards)
        ]

    # -- internals -----------------------------------------------------------

    def _shard(self, key) -> int:
        return hash(key) % len(self._maps)

    @staticmethod
    def _cls_count(cls_map: Dict[str, List[int]], cls: str,
                   slot: int) -> None:
        """Bump one per-class counter row (caller holds the shard
        lock that owns cls_map)."""
        row = cls_map.get(cls)
        if row is None:
            row = cls_map[cls] = [0, 0, 0]
        row[slot] += 1

    def _per_shard_cap(self) -> int:
        return max(1, self.capacity // len(self._maps))

    # -- the read path -------------------------------------------------------

    def lookup(
        self,
        cls: str,
        key,
        fence: Tuple[int, int, int, int],  # (inc, max stamp, gen, floor)
        epoch: str,
        now_ns: int,
        allow_stale: bool = False,
    ) -> Optional[List[str]]:
        """-> the cached id list (time-refiltered at now_ns) when the
        fence holds, else None.  Every outcome is counted."""
        if not self.enabled:
            return None
        s = self._shard(key)
        inc, stamp, gen, floor = fence
        with self._locks[s]:
            od = self._maps[s]
            cls_map = self._cls[s]
            e = od.get(key)
            if e is None:
                self._misses[s] += 1
                self._cls_count(cls_map, cls, 1)
                return None
            ok = e.epoch == epoch and e.inc == inc
            stale_served = False
            if ok and stamp > e.stamp:
                # a covering cell advanced: exact fence fails.  A
                # bounded-staleness query may still ride the entry when
                # the write lag stays inside the contract — but NEVER
                # across a wholesale invalidation (e.stamp < floor
                # means the entry predates a bump_all, whose "one
                # generation" stands for unbounded change).
                if (
                    allow_stale
                    and self.stale_lag > 0
                    and gen - e.gen <= self.stale_lag
                    and e.stamp >= floor
                ):
                    stale_served = True
                else:
                    ok = False
            if not ok:
                del od[key]
                self._bytes[s] -= e.nbytes
                self._invalidations[s] += 1
                self._misses[s] += 1
                self._cls_count(cls_map, cls, 1)
                self._cls_count(cls_map, cls, 2)
                return None
            if now_ns < e.now0:
                # the query's clock is BEHIND the entry's: records the
                # entry already dropped as expired cannot be
                # resurrected — fall through to the fresh path (keep
                # the entry for forward-clock pollers)
                self._misses[s] += 1
                self._cls_count(cls_map, cls, 1)
                return None
            od.move_to_end(key)
            self._hits[s] += 1
            if stale_served:
                self._stale_hits[s] += 1
            self._cls_count(cls_map, cls, 0)
            ids, t1s, min_t1 = e.ids, e.t1s, e.min_t1
        if now_ns <= min_t1:
            return list(ids)
        # re-apply the ONE time-variant filter (t_end >= now): as now
        # advances, hits can only expire out — exactly what the fresh
        # path would drop
        keep = t1s >= now_ns
        return [i for i, k in zip(ids, keep.tolist()) if k]

    def insert(
        self,
        cls: str,
        key,
        fence: Tuple[int, int, int, int],
        epoch: str,
        now_ns: int,
        ids: Sequence[str],
        t1s: Sequence[int],
    ) -> None:
        """Populate after a miss.  `fence` MUST have been read before
        the fresh query ran: a write landing between the stamp read
        and the query can then only make the entry look too old (next
        fence check discards it), never fresher than its data."""
        if not self.enabled:
            return
        t1arr = np.asarray(t1s, np.int64)
        nbytes = (
            int(t1arr.nbytes)
            + sum(len(i) for i in ids)
            + 64 * max(1, len(ids))
            + 256
        )
        inc, stamp, gen, _floor = fence
        e = _Entry(
            epoch=epoch, inc=inc, stamp=stamp, gen=gen,
            now0=int(now_ns),
            min_t1=int(t1arr.min()) if len(t1arr) else np.iinfo(np.int64).max,
            ids=tuple(ids), t1s=t1arr, nbytes=nbytes,
        )
        s = self._shard(key)
        cap = self._per_shard_cap()
        with self._locks[s]:
            od = self._maps[s]
            old = od.get(key)
            if (
                old is not None
                and old.now0 > e.now0
                and old.stamp >= e.stamp
                and old.inc == e.inc
                and old.epoch == e.epoch
            ):
                # a backwards-clock miss (e.g. a txn-pinned precheck
                # behind live pollers) must not displace the entry the
                # lookup path deliberately kept for forward pollers
                return
            if old is not None:
                del od[key]
                self._bytes[s] -= old.nbytes
            od[key] = e
            self._bytes[s] += nbytes
            while len(od) > cap:
                _, ev = od.popitem(last=False)
                self._bytes[s] -= ev.nbytes
                self._evictions[s] += 1

    # -- control -------------------------------------------------------------

    def invalidate_all(self) -> int:
        """Flush every entry (region resync, cache-disable runbook).
        -> entries dropped (counted as invalidations)."""
        dropped = 0
        for s, lock in enumerate(self._locks):
            with lock:
                n = len(self._maps[s])
                self._maps[s].clear()
                self._bytes[s] = 0
                self._invalidations[s] += n
                dropped += n
        return dropped

    def configure(self, *, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  stale_lag: Optional[int] = None) -> None:
        """Runtime knob surface (DSSStore.configure_serving(cache=)).
        Disabling flushes: a re-enable must start from an empty cache,
        not from entries whose fences were stamped before the gap."""
        if capacity is not None:
            self.capacity = max(1, int(capacity))
        if stale_lag is not None:
            self.stale_lag = max(0, int(stale_lag))
        if enabled is not None:
            enabled = bool(enabled)
            if self.enabled and not enabled:
                self.invalidate_all()
            self.enabled = enabled

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        return {
            "hits": sum(self._hits),
            "misses": sum(self._misses),
            "evictions": sum(self._evictions),
            "invalidations": sum(self._invalidations),
            "stale_hits": sum(self._stale_hits),
            "entries": sum(len(m) for m in self._maps),
            "bytes": sum(self._bytes),
            "capacity": self.capacity,
            "enabled": int(self.enabled),
        }

    def class_stats(self, cls: str) -> dict:
        """co_cache_* gauges for one entity class — wired into that
        class's QueryCoalescer stats (coalesce.set_cache_view) so hit
        rate renders next to the route mix in /metrics."""
        h = m = i = 0
        for s, lock in enumerate(self._locks):
            with lock:
                row = self._cls[s].get(cls)
                if row is not None:
                    h += row[0]
                    m += row[1]
                    i += row[2]
        return {
            "co_cache_hits": h,
            "co_cache_misses": m,
            "co_cache_invalidations": i,
        }


# -- per-request freshness plumbing (thread-local) ---------------------------
#
# The store's search path runs synchronously on one thread (an executor
# worker or, with inline reads, the event loop).  It records here what
# the response-layer needs for the X-DSS-Freshness header; api/app.py
# takes the note after the service call returns on the SAME thread.

_tls = threading.local()


def note_search(cls: str, epoch: str, generation: int, hit: bool) -> None:
    """First search of the request wins: an SCD subscription query
    runs dependent-operation sub-searches after the outer one, and the
    header should describe the OUTER answer."""
    if getattr(_tls, "note", None) is None:
        _tls.note = {
            "cls": cls, "epoch": epoch, "gen": int(generation),
            "hit": bool(hit),
        }


def take_note() -> Optional[dict]:
    n = getattr(_tls, "note", None)
    _tls.note = None
    return n


def note_mesh_served() -> None:
    """Set by the coalescer when a query was answered by the sharded
    mesh replica (bounded-stale).  The store must NOT populate the
    cache from it: the fence would stamp a possibly-lagging answer as
    fresh, and a later strict hit would violate the exactness
    contract."""
    _tls.mesh = True


def take_mesh_served() -> bool:
    m = getattr(_tls, "mesh", False)
    _tls.mesh = False
    return bool(m)


def note_last_search_meshed(meshed: bool) -> None:
    """Sticky per-thread record of whether the MOST RECENT search on
    this thread was mesh-served (bounded-stale).  take_mesh_served is
    consumed inside _cached_ids to gate the leader's own cache
    population; this flag survives one level up so the shm owner can
    tell the REQUESTING WORKER not to populate its cache either —
    otherwise a lagging mesh answer would be stamped fresh behind a
    fence that cannot detect it."""
    _tls.last_mesh = bool(meshed)


def take_last_search_meshed() -> bool:
    m = getattr(_tls, "last_mesh", False)
    _tls.last_mesh = False
    return bool(m)

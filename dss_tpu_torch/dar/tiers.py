"""Tiered snapshots: the LSM-style tier stack behind DarTable.

The port of the reference's `dss_tpu/dar/tiers.py`:

  L0 (base)   — one large, rarely-rewritten snapshot.  Holds every
                record as of the last MAJOR compaction.
  L1 (delta)  — one small snapshot absorbing minor folds: all records
                written/updated since L0 was built.  Rebuilt from the
                writer-tracked delta set on every fold — O(overlay+L1),
                never O(table).
  overlay     — records since the last fold, spliced O(Δ) per write
                (dar/snapshot.py).

Shadowing (newest tier wins) is enforced at WRITE time: updating or
removing an entity marks its slot dead in every tier that still holds
it live, so the query path merges per-tier hits after per-tier dead
filtering.  Tombstones are garbage-collected by the next major
compaction, which triggers when |delta records| + |shadowed rows|
exceeds DSS_TIER_RATIO x |L0|.

Knobs (env, read at DarTable construction):

  DSS_TIER_RATIO   — churn ratio triggering a major compaction
                     (default 0.25; 0 disables tiering: every fold is
                     a full rebuild).
  DSS_TIER_MIN_L0  — below this many L0 records every fold is major
                     (default 0).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.pack import pack_records
from dss_tpu_torch.ops.fastpath import FastTable

# CellClock incarnations are process-unique: a replaced index gets a
# fresh clock whose stamps start over, and a read cache must never
# compare stamps across clocks
_INCARNATIONS = itertools.count(1)


class CellClock:
    """Per-cell monotonic write clock — the exact-invalidation currency
    of a version-fenced read cache.

    One global counter per clock; every write bumps it once (the
    `generation`) and stamps that value onto each affected DAR key's
    slot, so `max over a covering's cells` is a sufficient fence.
    Stamps live in a fixed hashed-slot int64 array (default 2^20
    slots, 8 MB, allocated at the first bump); two cells sharing a slot
    can only over-invalidate.  Wholesale replacements (bulk_load) bump
    the `floor` instead of walking every record.

    Writers bump under their own write lock; `fence` is lock-free."""

    __slots__ = ("_clock", "_mask", "_gen", "_high", "_floor",
                 "incarnation", "_lock")

    SLOTS = 1 << 20  # per-class stamp array (8 MB); power of two

    def __init__(self, slots: Optional[int] = None):
        n = self.SLOTS if slots is None else int(slots)
        if n <= 0 or n & (n - 1):
            raise ValueError(f"slot count must be a power of two, got {n}")
        self._clock: Optional[np.ndarray] = None
        self._mask = np.int64(n - 1)
        self._gen = 0
        self._high = 0  # highest stamp handed out to a cell slot
        self._floor = 0  # generation of the last wholesale bump_all
        self._lock = threading.Lock()
        self.incarnation = next(_INCARNATIONS)

    def _slots_of(self, keys) -> np.ndarray:
        return np.asarray(keys, np.int64).ravel() & self._mask

    def bump(self, *key_arrays) -> None:
        """One write: stamp every DAR key in the given arrays with a
        fresh generation.  An UPDATE passes both the old and the new
        covering."""
        with self._lock:
            self._gen += 1
            g = self._gen
            self._high = g
            if self._clock is None:
                self._clock = np.zeros(int(self._mask) + 1, np.int64)
            for keys in key_arrays:
                if keys is None:
                    continue
                self._clock[self._slots_of(keys)] = g

    def bump_all(self) -> None:
        """Wholesale invalidation (bulk_load): raise the floor so every
        fence computed afterwards exceeds any stamp handed out before."""
        with self._lock:
            self._gen += 1
            self._floor = self._gen

    @property
    def floor(self) -> int:
        """Generation of the last wholesale invalidation."""
        return self._floor

    def fence(self, keys) -> "tuple[int, int, int, int]":
        """-> (incarnation, max stamp over keys, generation, floor)."""
        arr = self._clock  # one read: bump may swap it in concurrently
        m = self._floor
        if arr is not None:
            slots = self._slots_of(keys)
            if len(slots):
                m = max(m, int(arr[slots].max()))
        return (self.incarnation, m, self._gen, self._floor)

    @property
    def generation(self) -> int:
        """Total write operations (cell-stamping AND wholesale)."""
        return self._gen

    @property
    def high_water(self) -> int:
        """Highest stamp handed out to a cell slot."""
        return self._high


class RangeLoad:
    """Per-key-range query-load EWMA — the measurement half of
    skew-aware shard placement (the reference's parallel/sharded.py
    weighted split; the port's mesh slice reads it).

    DAR keys bucket by prefix (`key >> shift`, default 12: ~4096
    adjacent level-13 cells per bucket, roughly a metro-scale S2
    region).  Every coalescer-served query stamps its covering's
    buckets with its measured candidate work (result count; read-cache
    hits never reach a shard and therefore never stamp).  The
    accumulated load decays exponentially (`decay_factor`) at the
    rebalance-planning cadence — once per DSS_SHARD_MOVE_INTERVAL_S,
    applied by `plan_rebalance` — so the map tracks RECENT traffic: a
    hot spot that moved cities stops pinning shards to the old metro
    within a few planning intervals.

    Bucket count is bounded (`max_buckets`): when the dict overflows,
    the coldest half is dropped — losing cold-bucket precision only
    degrades the split toward equal-count, never correctness (placement
    is a performance mapping; answers never depend on it).

    Thread-safe: writers stamp under the lock from serving threads;
    `weights_for` / `bucket_loads` take a consistent snapshot."""

    __slots__ = ("shift", "decay_factor", "max_buckets", "_load",
                 "_queries", "_lock")

    def __init__(
        self,
        shift: Optional[int] = None,
        decay_factor: Optional[float] = None,
        max_buckets: int = 1 << 16,
    ):
        if shift is None:
            shift = int(os.environ.get("DSS_SHARD_LOAD_SHIFT", 12))
        if decay_factor is None:
            decay_factor = float(
                os.environ.get("DSS_SHARD_LOAD_DECAY", 0.5)
            )
        self.shift = int(shift)
        self.decay_factor = float(decay_factor)
        self.max_buckets = int(max_buckets)
        self._load: Dict[int, float] = {}
        self._queries = 0
        self._lock = threading.Lock()

    def record(self, keys, work: float = 1.0) -> None:
        """One served query: spread its measured work over the buckets
        its covering touches.  `work` is the candidate/result count
        (floored at 1 so pure-miss traffic still registers — an empty
        hot area still costs per-shard gather work)."""
        b = np.unique(np.asarray(keys, np.int64).ravel() >> self.shift)
        if not len(b):
            return
        w = max(float(work), 1.0) / len(b)
        with self._lock:
            self._queries += 1
            load = self._load
            for k in b.tolist():
                load[k] = load.get(k, 0.0) + w
            if len(load) > self.max_buckets:
                # drop the coldest half: bounded bookkeeping, and the
                # split degrades toward equal-count for cold ranges
                keep = sorted(
                    load.items(), key=lambda kv: kv[1], reverse=True
                )[: self.max_buckets // 2]
                self._load = dict(keep)

    def decay(self) -> None:
        """One fold boundary: age the EWMA.  Buckets decayed below
        noise are dropped so a vacated hot spot releases its shards."""
        with self._lock:
            f = self.decay_factor
            self._load = {
                k: v * f for k, v in self._load.items() if v * f > 1e-3
            }

    def total(self) -> float:
        with self._lock:
            return sum(self._load.values())

    @property
    def queries(self) -> int:
        return self._queries

    def bucket_loads(self) -> "Tuple[np.ndarray, np.ndarray]":
        """-> (sorted bucket ids i64, loads f64) — a consistent
        snapshot for split planning."""
        with self._lock:
            if not self._load:
                return _EMPTY_I64, np.zeros(0, np.float64)
            ks = np.asarray(sorted(self._load), np.int64)
            vs = np.asarray([self._load[int(k)] for k in ks], np.float64)
        return ks, vs

    def weights_for(self, post_key: np.ndarray) -> np.ndarray:
        """Per-posting load weight: w[i] = EWMA load of posting i's
        bucket, 0 for never-stamped buckets.  The splitter adds its
        own count baseline, so zero-load (cold start) degrades to the
        equal-count split exactly."""
        ks, vs = self.bucket_loads()
        pk = np.asarray(post_key, np.int64) >> self.shift
        if not len(ks):
            return np.zeros(len(pk), np.float64)
        pos = np.searchsorted(ks, pk)
        pos[pos == len(ks)] = 0
        w = vs[pos].copy()
        w[ks[pos] != pk] = 0.0
        return w

    def stats(self) -> dict:
        with self._lock:
            return {
                "shard_load_buckets": len(self._load),
                "shard_load_total": round(sum(self._load.values()), 2),
                "shard_load_queries": self._queries,
            }


class TierSnapshot(NamedTuple):
    """One immutable device snapshot (L0 and L1 are both instances)."""

    fast: Optional[FastTable]
    owner: Optional[np.ndarray]  # i32 per slot
    ids: List[str]  # slot -> entity_id
    slot_of: Dict[str, int]  # entity_id -> slot
    recs: Dict[str, Record]  # id -> Record at build time (immutable)


EMPTY_SNAPSHOT = TierSnapshot(None, None, [], {}, {})


# shadowed-slot bookkeeping: dead slots live in TWO sorted int64
# arrays per tier — a small `dead_recent` (grown by O(recent) insert
# per write) and a large, stable `dead_base`; recent folds into base
# past this threshold, bounding per-write and per-query cost
DEAD_FOLD_THRESHOLD = 4096

_EMPTY_I64 = np.zeros(0, np.int64)


class Tier(NamedTuple):
    """One published tier: an immutable snapshot plus the slots
    superseded/removed since it was built (never mutated — writers
    publish a replacement Tier with grown dead arrays)."""

    snap: TierSnapshot
    dead_recent: np.ndarray  # i64 sorted, small
    dead_base: np.ndarray  # i64 sorted, stable between threshold folds

    @property
    def dead(self) -> frozenset:
        """All shadowed slots (diagnostic/test view)."""
        return frozenset(
            int(s) for s in np.concatenate([self.dead_recent, self.dead_base])
        )

    @property
    def dead_count(self) -> int:
        return len(self.dead_recent) + len(self.dead_base)


def make_tier(snap: TierSnapshot, dead_slots=()) -> Tier:
    """A fresh Tier whose dead set starts as `dead_slots`."""
    arr = np.asarray(sorted(dead_slots), np.int64)
    return Tier(snap, arr, _EMPTY_I64)


def _sorted_contains(arr: np.ndarray, v: int) -> bool:
    i = int(np.searchsorted(arr, v))
    return i < len(arr) and int(arr[i]) == v


def slot_dead(tier: Tier, slot: int) -> bool:
    return _sorted_contains(tier.dead_recent, slot) or _sorted_contains(
        tier.dead_base, slot
    )


def filter_dead(tier: Tier, qidx: np.ndarray, slots: np.ndarray):
    """Drop (qidx, slot) hits whose slot is shadowed in this tier."""
    keep = None
    for arr in (tier.dead_recent, tier.dead_base):
        if not len(arr):
            continue
        pos = np.searchsorted(arr, slots)
        pos[pos == len(arr)] = 0  # any in-range index; compare below
        hit = arr[pos] == slots
        keep = ~hit if keep is None else keep & ~hit
    if keep is None:
        return qidx, slots
    return qidx[keep], slots[keep]


class TierPolicy(NamedTuple):
    ratio: float  # major compaction when churn > ratio * |L0|
    min_l0: int  # L0 sizes below this always compact major


def env_policy() -> TierPolicy:
    """Tier policy from DSS_TIER_* env vars; unset keeps the defaults."""
    try:
        ratio = float(os.environ.get("DSS_TIER_RATIO", 0.25))
    except ValueError:
        raise ValueError(
            f"DSS_TIER_RATIO={os.environ['DSS_TIER_RATIO']!r} is not a float"
        )
    try:
        min_l0 = int(os.environ.get("DSS_TIER_MIN_L0", 0))
    except ValueError:
        raise ValueError(
            f"DSS_TIER_MIN_L0={os.environ['DSS_TIER_MIN_L0']!r} is not an int"
        )
    return TierPolicy(ratio=ratio, min_l0=min_l0)


def build_snapshot(live: List[Record], device=None) -> TierSnapshot:
    """Pack records into one device-resident snapshot (exact block
    columns on `device` + host decode state)."""
    if not live:
        return EMPTY_SNAPSHOT
    packed = pack_records(live, pad_postings=False)
    pe = packed.post_ent
    ft = FastTable(
        packed.post_key,
        pe,
        packed.alt_lo[pe],
        packed.alt_hi[pe],
        packed.t_start[pe],
        packed.t_end[pe],
        packed.active[pe],
        slot_exact={
            "alt_lo": packed.alt_lo,
            "alt_hi": packed.alt_hi,
            "t0": packed.t_start,
            "t1": packed.t_end,
            "live": packed.active.copy(),
        },
        device=device,
    )
    ids = [r.entity_id for r in live]
    return TierSnapshot(
        fast=ft,
        owner=packed.owner,
        ids=ids,
        slot_of={eid: i for i, eid in enumerate(ids)},
        recs={r.entity_id: r for r in live},
    )


def mark_dead(tiers: Tuple[Tier, ...], entity_id: str) -> Tuple[Tier, ...]:
    """Shadow an entity everywhere: mark its slot dead in every tier
    that still holds it live.  Returns the input tuple unchanged when
    nothing needed marking."""
    out = None
    for i, t in enumerate(tiers):
        s = t.snap.slot_of.get(entity_id)
        if s is None or slot_dead(t, s):
            continue
        recent = np.insert(
            t.dead_recent, int(np.searchsorted(t.dead_recent, s)), s
        )
        base = t.dead_base
        if len(recent) > DEAD_FOLD_THRESHOLD:
            # amortized: one O(base) merge per threshold shadowings
            base = np.union1d(base, recent)
            recent = _EMPTY_I64
        if out is None:
            out = list(tiers)
        out[i] = Tier(t.snap, recent, base)
    return tiers if out is None else tuple(out)


def resolve_record(
    tiers: Tuple[Tier, ...], entity_id: str
) -> Optional[Record]:
    """The entity's visible record across the tier stack, newest tier
    first."""
    for t in reversed(tiers):
        s = t.snap.slot_of.get(entity_id)
        if s is not None and not slot_dead(t, s):
            return t.snap.recs.get(entity_id)
    return None


def stats(tiers: Tuple[Tier, ...]) -> dict:
    """Gauge-ready tier metrics."""
    l0 = len(tiers[0].snap.ids) if tiers else 0
    l1 = sum(len(t.snap.ids) for t in tiers[1:])
    shadowed = sum(t.dead_count for t in tiers)
    return {
        "tier_count": len(tiers),
        "tier_l0_records": l0,
        "tier_l1_records": l1,
        "tier_l0_dead": tiers[0].dead_count if tiers else 0,
        "tier_shadowed_rows": shadowed,
    }

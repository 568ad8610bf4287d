"""Shared-memory serving front: the host ring across process boundaries.

A copy of the reference's `dss_tpu/parallel/shmring.py`: the same
magic, version, offsets and slot codec, so a region file holds the
same bytes whichever package wrote it (tests/test_torch_shmring.py).
One Python host process saturates long before the card does (the
HTTP loop costs a few ms of one core per request while the device
idles), and SO_REUSEPORT read workers over a plain WAL-tail replica
re-scan the whole index per poll.  This module is the placement fix:
N request workers share ONE device-owner process over an mmap'd
region, and the hot search path crosses the process boundary as
fixed-layout binary slots — no JSON, no pickle, no sockets, no
syscalls beyond the page faults.

One region file, four segments:

  header        geometry + epoch token + owner heartbeat/pid
  worker stats  one 256-byte counter block per worker (single-writer;
                the leader aggregates them into /metrics so ONE scrape
                sees the whole front)
  fence         per entity class: (incarnation, generation, floor,
                high-water) + a hashed-slot int64 stamp array — the
                OWNER mirrors every CellClock bump into it, and each
                worker's local read cache fences on it with the exact
                NO-TTL rules of dar/readcache.py.  Hash collisions can
                only over-invalidate (a fence sees a too-new stamp and
                the worker re-asks the owner) — a hit-rate tax, never
                a staleness bug, the same argument as CellClock itself.
  rings         per worker: `depth` fixed-size slots.  Each slot is a
                little seqlock-style state machine

                    FREE -> REQ (worker publishes a request)
                         -> BUSY (owner claimed it)
                         -> RESP (owner published the answer)
                         -> FREE (worker consumed it)

                Workers only perform FREE->REQ and RESP->FREE; the
                owner only performs REQ->BUSY and BUSY->RESP, so each
                slot is single-producer/single-consumer in both
                directions.  Payload is written before the state word
                and the state word is one aligned 8-byte store —
                x86-64 total-store-order makes the publish safe
                without locks (the only ISA this repo's build hosts
                run; an acquire/release port is a TODO for ARM).

Request payload: canonical covering cells as a raw uint64 run +
time/altitude window + class/owner scope + deadline.  Response: the
(id, t_end) hit pairs, the WAL sequence at answer time (the worker's
replica-catchup bound for record assembly), the class write generation
(freshness header), and an admission verdict — 429 + Retry-After ride
the slot exactly like the in-process admission path, so the shm route
keeps the coalescer's admission/deadline semantics end to end.

Fault sites (chaos/faults.py): `shm.ring.enqueue` (worker side — an
injected fault falls back to the loopback proxy, never a 5xx) and
`shm.fence.broadcast` (owner side — an injected fault POISONS the
class fence by raising its floor, so worker caches over-invalidate
rather than ever serving across a missed bump).
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dss_tpu_torch import chaos
from dss_tpu_torch.dar.readcache import _env_int
from dss_tpu_torch.obs.metrics import (
    ROUTE_CLASSES,
    STAGE_BUCKETS,
    STAGE_NAMES,
    route_class,
    stage_name,
)

__all__ = [
    "SHM_CLASSES",
    "RingFull",
    "RingTimeout",
    "RingOversize",
    "ShmRegion",
    "ShmRequest",
    "ShmResponse",
    "FenceMirror",
    "WorkerFenceView",
    "ShmOwner",
    "ShmWorkerClient",
    "StageHistWriter",
    "shm_stage_hist",
    "env_knobs",
    "front_stats",
]

# the five entity classes, in wire order (the slot's cls field is an
# index into this tuple; both sides import the same constant)
SHM_CLASSES = ("isa", "rid_sub", "op", "scd_sub", "constraint")

MAGIC = 0x4453_5353_484D_5231  # "DSSSHMR1"
VERSION = 2  # v2: trace words in the slot header + the per-process
#              stage-histogram segment (distributed tracing PR)

HEADER_BYTES = 4096
WSTAT_BYTES = 256  # 32 i64 counters per worker
FENCE_HDR_BYTES = 64

# slot states
FREE, REQ, BUSY, RESP = 0, 1, 2, 3

# response statuses (HTTP-ish so the worker's mapping is obvious)
ST_OK = 0
ST_OVERLOADED = 429
ST_DEADLINE = 504
ST_ERROR = 500
ST_OVERFLOW = 507  # answer larger than the slot: re-ask over loopback

# response flag bits
RESP_F_MESH_SERVED = 1  # bounded-stale mesh answer: worker must NOT
#                         populate its cache from it (the leader's
#                         _cached_ids refuses for the same reason)

# request flags
F_ALLOW_STALE = 1
F_HAS_ALT_LO = 2
F_HAS_T0 = 4
F_HAS_T1 = 8
F_HAS_OWNER = 16
F_HAS_ALT_HI = 32

# worker stat block indices (single-writer per block; the leader's
# /metrics aggregation reads them as dss_shm_worker_* families)
WS_HEARTBEAT_NS = 0
WS_ENQUEUED = 1
WS_SERVED = 2
WS_CACHE_HITS = 3
WS_CACHE_MISSES = 4
WS_RING_FULL = 5
WS_TIMEOUTS = 6
WS_OVERSIZE = 7
WS_PROXY_FALLBACKS = 8
WS_ASSEMBLY_MISSES = 9
WS_WAIT_NS = 10
WS_ERRORS = 11
WS_PLAN_SHM = 12
WS_PLAN_PROXY = 13
WSTAT_NAMES = {
    WS_ENQUEUED: "enqueued",
    WS_SERVED: "served",
    WS_CACHE_HITS: "cache_hits",
    WS_CACHE_MISSES: "cache_misses",
    WS_RING_FULL: "ring_full",
    WS_TIMEOUTS: "timeouts",
    WS_OVERSIZE: "oversize",
    WS_PROXY_FALLBACKS: "proxy_fallbacks",
    WS_ASSEMBLY_MISSES: "assembly_misses",
    WS_ERRORS: "errors",
    WS_PLAN_SHM: "plan_shm",
    WS_PLAN_PROXY: "plan_proxy",
}

_OWNER_MAX = 120  # bytes of utf-8 owner scope a slot can carry

# owner counter block: 16 i64s at header offset 64, single-writer
# (the owner process).  Published so ANY process mapping the region —
# every request worker included — can render the whole front's
# dss_shm_* families from its own /metrics endpoint: with the owner
# off the public port, scrapes only ever land on workers.
_OHDR_OFF = 64
OH_SERVED = 0
OH_ERRORS = 1
OH_DEADLINE_DROPS = 2
OH_OVERLOADED = 3
OH_RECLAIMED = 4
OH_SERVE_NS = 5
OH_DEAD_WORKERS = 6

# struct layouts (little-endian, 8-aligned).  state + req_id live at
# offsets 0/8; the TRACE block at 16 carries the W3C trace id +
# sampled bit INTO the owner (words 0-2) and the owner's span-slot
# durations (obs/trace.OWNER_SLOTS, ns each, words 3-10) back OUT —
# how one request becomes ONE stitched trace across the process
# boundary without a byte of JSON on the hot path.  Request and
# response payloads share the area past the trace block (a slot is
# request OR response, never both).
_TRACE_OFF = 16
_TRACE_REQ = struct.Struct("<QQQ")  # tid_hi, tid_lo, flags
_TRACE_RESP_WORDS = 8  # one i64 duration (ns) per OWNER_SLOTS entry
_TRACE_RESP = struct.Struct("<" + "q" * _TRACE_RESP_WORDS)
_TRACE_RESP_OFF = _TRACE_OFF + _TRACE_REQ.size
_TRACE_BYTES = 96  # 3 + 8 words, padded to 8-word alignment
TRACE_F_SAMPLED = 1
TRACE_F_PRESENT = 2

_REQ_HDR = struct.Struct("<iiddqqqqii")  # cls, flags, alt_lo, alt_hi,
#                                          t0, t1, now, deadline_ns,
#                                          owner_len, n_cells
_RESP_HDR = struct.Struct("<iiqqdi")  # status, n_hits, wal_seq, gen,
#                                       retry_after_s, flags
_PAYLOAD_OFF = _TRACE_OFF + _TRACE_BYTES
_REQ_FIXED = _PAYLOAD_OFF + _REQ_HDR.size
_RESP_FIXED = _PAYLOAD_OFF + _RESP_HDR.size


def tid_split(trace_id: str) -> Tuple[int, int]:
    """32-hex W3C trace id -> (hi, lo) uint64 pair for the slot."""
    v = int(trace_id, 16)
    return (v >> 64) & ((1 << 64) - 1), v & ((1 << 64) - 1)


def tid_join(hi: int, lo: int) -> str:
    return format((int(hi) << 64) | int(lo), "032x")


# -- per-process stage-histogram blocks --------------------------------------
#
# dss_stage_duration_seconds{stage,route} aggregated across the front:
# each process (worker i -> block i, the leader/owner -> block
# nworkers) scatters its stage observations into its own fixed-layout
# block — (route class x stage x [bucket counts..., sum_ns, count])
# int64s, single-writer like the worker stats blocks — and ANY
# process's /metrics renders the merged family (shm_stage_hist), so
# one scrape shows the whole front's per-stage tails no matter which
# worker SO_REUSEPORT hands the connection to.

_SHIST_ROW = len(STAGE_BUCKETS) + 2  # buckets + sum_ns + count
_SHIST_WORDS = len(ROUTE_CLASSES) * len(STAGE_NAMES) * _SHIST_ROW
SHIST_BLOCK_BYTES = ((_SHIST_WORDS * 8 + 4095) // 4096) * 4096
_ROUTE_IDX = {r: i for i, r in enumerate(ROUTE_CLASSES)}
_STAGE_IDX = {s: i for i, s in enumerate(STAGE_NAMES)}


class RingFull(RuntimeError):
    """No free slot in this worker's ring: the caller falls back to
    the loopback proxy (never blocks, never 5xxs)."""


class RingTimeout(RuntimeError):
    """The owner did not answer within the wait bound."""


class RingOversize(RuntimeError):
    """Request (covering) or response (hits) exceeds the slot."""


def env_knobs() -> dict:
    """ShmRegion geometry from DSS_SHM_* env vars (README lists them)."""
    return {
        "depth": _env_int("DSS_SHM_DEPTH", 64),
        "slot_bytes": _env_int("DSS_SHM_SLOT_BYTES", 32768),
        "fence_slots": _env_int("DSS_SHM_FENCE_SLOTS", 1 << 16),
    }


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def empty_stats() -> dict:
    """The stable dss_shm_* gauge key set for deployments with no
    shared-memory front attached — dashboards and the observability
    tier never miss a series (same pattern as federation.empty_stats)."""
    out = {
        "dss_shm_ring_depth": 0,
        "dss_shm_workers": 0,
        "dss_shm_dead_workers": 0,
        "dss_shm_slots_in_flight": 0,
        "dss_shm_served_total": 0,
        "dss_shm_errors_total": 0,
        "dss_shm_deadline_drops_total": 0,
        "dss_shm_overloaded_total": 0,
        "dss_shm_reclaimed_total": 0,
        "dss_shm_serve_ms_total": 0.0,
        "dss_shm_saturation": 0.0,
        "dss_shm_ring_full_total": 0,
    }
    for name in WSTAT_NAMES.values():
        out[f"dss_shm_worker_{name}"] = {}
    return out


def front_stats(region: "ShmRegion") -> dict:
    """The whole front's dss_shm_* families, assembled from the shared
    region alone: slot states, the per-worker stats blocks, and the
    owner counter block it publishes into the header.  Owner and
    workers call the SAME function, so a scrape landing on ANY process
    of the front reports one coherent view (the fix for multi-process
    /metrics incoherence under SO_REUSEPORT)."""
    r = region
    oh = r._ohdr
    in_flight = int(np.count_nonzero(r._states != FREE))
    out = {
        "dss_shm_ring_depth": r.depth,
        "dss_shm_workers": r.nworkers,
        "dss_shm_dead_workers": int(oh[OH_DEAD_WORKERS]),
        "dss_shm_slots_in_flight": in_flight,
        "dss_shm_served_total": int(oh[OH_SERVED]),
        "dss_shm_errors_total": int(oh[OH_ERRORS]),
        "dss_shm_deadline_drops_total": int(oh[OH_DEADLINE_DROPS]),
        "dss_shm_overloaded_total": int(oh[OH_OVERLOADED]),
        "dss_shm_reclaimed_total": int(oh[OH_RECLAIMED]),
        "dss_shm_serve_ms_total": round(int(oh[OH_SERVE_NS]) / 1e6, 3),
        # fraction of the whole front's slots in flight — the
        # DssShmRingSaturated alert input
        "dss_shm_saturation": round(
            in_flight / max(1, r.depth * r.nworkers), 4
        ),
    }
    fams: Dict[str, Dict[str, float]] = {
        f"dss_shm_worker_{name}": {} for name in WSTAT_NAMES.values()
    }
    ring_full_total = 0
    for w in range(r.nworkers):
        ws = r.worker_stats(w)
        label = f"worker-{w}"
        for name in WSTAT_NAMES.values():
            fams[f"dss_shm_worker_{name}"][label] = ws[name]
        ring_full_total += ws["ring_full"]
    out.update(fams)
    out["dss_shm_ring_full_total"] = ring_full_total
    return out


class ShmRequest:
    """A decoded request slot (owner side)."""

    __slots__ = ("cls", "cells", "alt_lo", "alt_hi", "t0_ns", "t1_ns",
                 "now_ns", "deadline_ns", "owner", "allow_stale",
                 "worker", "slot", "req_id", "trace_id",
                 "trace_sampled")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class ShmResponse:
    """A decoded response slot (worker side)."""

    __slots__ = ("status", "ids", "t1s", "wal_seq", "gen",
                 "retry_after_s", "flags", "trace_ns")

    def __init__(self, status, ids, t1s, wal_seq, gen, retry_after_s,
                 flags=0, trace_ns=None):
        self.status = status
        self.ids = ids
        self.t1s = t1s
        self.wal_seq = wal_seq
        self.gen = gen
        self.retry_after_s = retry_after_s
        self.flags = flags
        # the owner's span-slot durations (ns per obs/trace.OWNER_SLOTS
        # entry) — only meaningful when the request carried a sampled
        # trace; the worker stitches them into its own trace as child
        # spans of the ring round trip
        self.trace_ns = trace_ns

    @property
    def mesh_served(self) -> bool:
        return bool(self.flags & RESP_F_MESH_SERVED)


class ShmRegion:
    """The mmap'd region: geometry, views, and slot codecs shared by
    the owner and worker endpoints.  One process calls `create`
    (truncates + initializes), everyone else `open_existing`."""

    def __init__(self, path: str, mm: mmap.mmap, *, nworkers: int,
                 depth: int, slot_bytes: int, fence_slots: int,
                 nclasses: int):
        self.path = path
        self._mm = mm
        self.nworkers = nworkers
        self.depth = depth
        self.slot_bytes = slot_bytes
        self.fence_slots = fence_slots
        self.nclasses = nclasses
        self._buf = memoryview(mm)
        self.wstats_off = HEADER_BYTES
        # stage-histogram blocks: one per worker + one for the owner
        self.shist_off = self.wstats_off + nworkers * WSTAT_BYTES
        shist_bytes = (nworkers + 1) * SHIST_BLOCK_BYTES
        self.fence_off = self.shist_off + shist_bytes
        fence_bytes = nclasses * (FENCE_HDR_BYTES + fence_slots * 8)
        self.rings_off = _pad8(self.fence_off + fence_bytes)
        # numpy views over the region (shared pages, not copies)
        self._wstats = np.ndarray(
            (nworkers, WSTAT_BYTES // 8), dtype=np.int64, buffer=mm,
            offset=self.wstats_off,
        )
        self._shist = np.ndarray(
            (nworkers + 1, _SHIST_WORDS), dtype=np.int64, buffer=mm,
            offset=self.shist_off,
            strides=(SHIST_BLOCK_BYTES, 8),
        )
        self._fence_hdrs = []
        self._fence_stamps = []
        for c in range(nclasses):
            off = self.fence_off + c * (FENCE_HDR_BYTES + fence_slots * 8)
            self._fence_hdrs.append(np.ndarray(
                (FENCE_HDR_BYTES // 8,), dtype=np.int64, buffer=mm,
                offset=off,
            ))
            self._fence_stamps.append(np.ndarray(
                (fence_slots,), dtype=np.int64, buffer=mm,
                offset=off + FENCE_HDR_BYTES,
            ))
        # strided state view: one i64 per slot, across all rings
        self._states = np.ndarray(
            (nworkers * depth,), dtype=np.int64, buffer=mm,
            offset=self.rings_off, strides=(slot_bytes,),
        )
        self._fence_mask = np.int64(fence_slots - 1)
        # owner counter block (header): single-writer, any reader
        self._ohdr = np.ndarray(
            (16,), dtype=np.int64, buffer=mm, offset=_OHDR_OFF,
        )

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str, *, nworkers: int, depth: int = 64,
               slot_bytes: int = 32768, fence_slots: int = 1 << 16,
               nclasses: int = len(SHM_CLASSES)) -> "ShmRegion":
        if fence_slots & (fence_slots - 1):
            raise ValueError("fence_slots must be a power of two")
        if slot_bytes < 4096 or slot_bytes % 8:
            raise ValueError("slot_bytes must be >= 4096 and 8-aligned")
        fence_bytes = nclasses * (FENCE_HDR_BYTES + fence_slots * 8)
        total = (
            _pad8(
                HEADER_BYTES + nworkers * WSTAT_BYTES
                + (nworkers + 1) * SHIST_BLOCK_BYTES + fence_bytes
            )
            + nworkers * depth * slot_bytes
        )
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        struct.pack_into(
            "<QIIIIII", mm, 0, MAGIC, VERSION, nworkers, depth,
            slot_bytes, fence_slots, nclasses,
        )
        region = cls(
            path, mm, nworkers=nworkers, depth=depth,
            slot_bytes=slot_bytes, fence_slots=fence_slots,
            nclasses=nclasses,
        )
        region.set_owner_heartbeat()
        struct.pack_into("<q", mm, 48, os.getpid())
        return region

    @classmethod
    def open_existing(cls, path: str) -> "ShmRegion":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, ver, nworkers, depth, slot_bytes, fence_slots, ncls = (
            struct.unpack_from("<QIIIIII", mm, 0)
        )
        if magic != MAGIC:
            raise ValueError(f"{path}: not a DSS shm region")
        if ver != VERSION:
            raise ValueError(
                f"{path}: region format {ver} != binary {VERSION}"
            )
        return cls(
            path, mm, nworkers=nworkers, depth=depth,
            slot_bytes=slot_bytes, fence_slots=fence_slots,
            nclasses=ncls,
        )

    def close(self) -> None:
        # drop numpy views before closing the map (BufferError otherwise)
        self._wstats = None
        self._shist = None
        self._fence_hdrs = []
        self._fence_stamps = []
        self._states = None
        self._ohdr = None
        self._buf.release()
        self._mm.close()

    # -- header --------------------------------------------------------------

    @property
    def epoch_token(self) -> int:
        return struct.unpack_from("<q", self._mm, 32)[0]

    def bump_epoch_token(self) -> None:
        struct.pack_into(
            "<q", self._mm, 32, self.epoch_token + 1
        )

    def set_owner_heartbeat(self) -> None:
        struct.pack_into("<q", self._mm, 40, time.time_ns())

    def owner_heartbeat_age_s(self) -> float:
        hb = struct.unpack_from("<q", self._mm, 40)[0]
        return max(0.0, (time.time_ns() - hb) / 1e9)

    # -- worker stats --------------------------------------------------------

    def stat_add(self, worker: int, idx: int, n: int = 1) -> None:
        # single-writer per block: the worker process owns its row
        self._wstats[worker, idx] += n

    def stat_set(self, worker: int, idx: int, v: int) -> None:
        self._wstats[worker, idx] = v

    def worker_stats(self, worker: int) -> Dict[str, int]:
        row = self._wstats[worker]
        out = {name: int(row[i]) for i, name in WSTAT_NAMES.items()}
        out["heartbeat_age_s"] = round(
            max(0.0, (time.time_ns() - int(row[WS_HEARTBEAT_NS])) / 1e9), 3
        ) if row[WS_HEARTBEAT_NS] else -1
        return out

    # -- fence segment -------------------------------------------------------

    def fence_write_meta(self, cls_idx: int, *, inc: int = None,
                         gen: int = None, floor: int = None,
                         high: int = None) -> None:
        hdr = self._fence_hdrs[cls_idx]
        if inc is not None:
            hdr[0] = inc
        if gen is not None:
            hdr[1] = gen
        if floor is not None:
            hdr[2] = floor
        if high is not None:
            hdr[3] = high

    def fence_stamp(self, cls_idx: int, dar_keys, gen: int) -> None:
        """Owner side: mirror one write's bump — scatter `gen` onto
        the hashed slots of the affected DAR keys, then publish the
        generation (stamps first, so a racing worker fence can only
        see too-new, never too-old)."""
        stamps = self._fence_stamps[cls_idx]
        slots = np.asarray(dar_keys, np.int64).ravel() & self._fence_mask
        if len(slots):
            stamps[slots] = gen
        self._fence_hdrs[cls_idx][1] = gen
        self._fence_hdrs[cls_idx][3] = gen

    def fence_poison(self, cls_idx: int) -> None:
        """Raise the class floor to its generation: every worker cache
        entry stamped so far fails its next fence check.  The fail-safe
        arm of a dropped/faulted broadcast."""
        hdr = self._fence_hdrs[cls_idx]
        g = int(hdr[1]) + 1
        hdr[1] = g
        hdr[2] = g

    def fence_read(self, cls_idx: int,
                   dar_keys) -> Tuple[int, int, int, int]:
        """Worker side: (incarnation, max stamp over the covering,
        generation, floor) — the same shape CellClock.fence returns,
        so the worker's ReadCache applies the identical rules."""
        hdr = self._fence_hdrs[cls_idx]
        floor = int(hdr[2])
        m = floor
        slots = np.asarray(dar_keys, np.int64).ravel() & self._fence_mask
        if len(slots):
            m = max(m, int(self._fence_stamps[cls_idx][slots].max()))
        return (int(hdr[0]), m, int(hdr[1]), floor)

    # -- slots ---------------------------------------------------------------

    def _slot_off(self, worker: int, slot: int) -> int:
        return self.rings_off + (worker * self.depth + slot) * self.slot_bytes

    def slot_state(self, worker: int, slot: int) -> int:
        return int(self._states[worker * self.depth + slot])

    def set_slot_state(self, worker: int, slot: int, state: int) -> None:
        self._states[worker * self.depth + slot] = state

    def req_capacity_cells(self, owner_len: int) -> int:
        return (
            self.slot_bytes - _REQ_FIXED - _pad8(owner_len)
        ) // 8

    def write_request(self, worker: int, slot: int, req_id: int, *,
                      cls_idx: int, cells: np.ndarray,
                      alt_lo, alt_hi, t0_ns, t1_ns, now_ns: int,
                      deadline_ns: int, owner: str,
                      allow_stale: bool,
                      trace_id: Optional[str] = None,
                      trace_sampled: bool = False) -> None:
        """Encode the request payload, then publish state=REQ.  Raises
        RingOversize when the covering (or owner scope) cannot fit."""
        off = self._slot_off(worker, slot)
        owner_b = owner.encode("utf-8") if owner else b""
        if len(owner_b) > _OWNER_MAX:
            raise RingOversize("owner scope too long for slot")
        cells = np.ascontiguousarray(cells, dtype=np.uint64)
        n = len(cells)
        if n > self.req_capacity_cells(len(owner_b)):
            raise RingOversize(f"covering of {n} cells exceeds slot")
        flags = 0
        if allow_stale:
            flags |= F_ALLOW_STALE
        if alt_lo is not None:
            flags |= F_HAS_ALT_LO
        if alt_hi is not None:
            flags |= F_HAS_ALT_HI
        if t0_ns is not None:
            flags |= F_HAS_T0
        if t1_ns is not None:
            flags |= F_HAS_T1
        if owner_b:
            flags |= F_HAS_OWNER
        mm = self._mm
        # trace words: id + sampled bit in, owner span slots zeroed
        # (the response fills them) — fixed words, never serialized
        if trace_id:
            hi, lo = tid_split(trace_id)
            tflags = TRACE_F_PRESENT | (
                TRACE_F_SAMPLED if trace_sampled else 0
            )
        else:
            hi = lo = tflags = 0
        _TRACE_REQ.pack_into(mm, off + _TRACE_OFF, hi, lo, tflags)
        _TRACE_RESP.pack_into(
            mm, off + _TRACE_RESP_OFF, *([0] * _TRACE_RESP_WORDS)
        )
        _REQ_HDR.pack_into(
            mm, off + _PAYLOAD_OFF, cls_idx, flags,
            0.0 if alt_lo is None else float(alt_lo),
            0.0 if alt_hi is None else float(alt_hi),
            0 if t0_ns is None else int(t0_ns),
            0 if t1_ns is None else int(t1_ns),
            int(now_ns), int(deadline_ns), len(owner_b), n,
        )
        p = off + _REQ_FIXED
        if owner_b:
            mm[p:p + len(owner_b)] = owner_b
        p += _pad8(len(owner_b))
        if n:
            mm[p:p + 8 * n] = cells.tobytes()
        struct.pack_into("<q", mm, off + 8, req_id)
        # publish LAST: one aligned 8-byte store
        self._states[worker * self.depth + slot] = REQ

    def read_request(self, worker: int, slot: int) -> ShmRequest:
        off = self._slot_off(worker, slot)
        mm = self._mm
        req_id = struct.unpack_from("<q", mm, off + 8)[0]
        thi, tlo, tflags = _TRACE_REQ.unpack_from(mm, off + _TRACE_OFF)
        (cls_idx, flags, alt_lo, alt_hi, t0, t1, now_ns, deadline_ns,
         owner_len, n) = _REQ_HDR.unpack_from(mm, off + _PAYLOAD_OFF)
        p = off + _REQ_FIXED
        owner = (
            bytes(mm[p:p + owner_len]).decode("utf-8")
            if flags & F_HAS_OWNER else None
        )
        p += _pad8(owner_len)
        # copy out: the serve path outlives the slot (it gets reused
        # for the response)
        cells = np.frombuffer(
            bytes(mm[p:p + 8 * n]), dtype=np.uint64
        ) if n else np.zeros(0, np.uint64)
        return ShmRequest(
            cls=SHM_CLASSES[cls_idx],
            cells=cells,
            alt_lo=alt_lo if flags & F_HAS_ALT_LO else None,
            alt_hi=alt_hi if flags & F_HAS_ALT_HI else None,
            t0_ns=t0 if flags & F_HAS_T0 else None,
            t1_ns=t1 if flags & F_HAS_T1 else None,
            now_ns=now_ns,
            deadline_ns=deadline_ns,
            owner=owner,
            allow_stale=bool(flags & F_ALLOW_STALE),
            worker=worker, slot=slot, req_id=req_id,
            trace_id=(
                tid_join(thi, tlo)
                if tflags & TRACE_F_PRESENT else None
            ),
            trace_sampled=bool(tflags & TRACE_F_SAMPLED),
        )

    def write_response(self, worker: int, slot: int, *, status: int,
                       ids: Sequence[str] = (), t1s: Sequence[int] = (),
                       wal_seq: int = 0, gen: int = 0,
                       retry_after_s: float = 0.0,
                       flags: int = 0,
                       trace_ns: Optional[Sequence[int]] = None) -> None:
        """Encode the response over the request payload, then publish
        state=RESP.  An answer that cannot fit publishes ST_OVERFLOW
        instead (the worker re-asks over the loopback proxy).
        `trace_ns` carries the owner's span-slot durations (one int64
        ns per obs/trace.OWNER_SLOTS entry) for sampled requests."""
        off = self._slot_off(worker, slot)
        mm = self._mm
        if trace_ns is not None:
            vec = list(trace_ns)[:_TRACE_RESP_WORDS]
            vec += [0] * (_TRACE_RESP_WORDS - len(vec))
            _TRACE_RESP.pack_into(mm, off + _TRACE_RESP_OFF, *vec)
        n = len(ids)
        id_blob = b""
        if n:
            parts = []
            for i in ids:
                b = i.encode("utf-8")
                parts.append(struct.pack("<H", len(b)))
                parts.append(b)
            id_blob = b"".join(parts)
        need = _RESP_FIXED + 8 * n + len(id_blob)
        if need > self.slot_bytes:
            status, n, t1s, id_blob = ST_OVERFLOW, 0, (), b""
        _RESP_HDR.pack_into(
            mm, off + _PAYLOAD_OFF, status, n, int(wal_seq), int(gen),
            float(retry_after_s), int(flags),
        )
        p = off + _RESP_FIXED
        if n:
            t1arr = np.ascontiguousarray(t1s, dtype=np.int64)
            mm[p:p + 8 * n] = t1arr.tobytes()
            p += 8 * n
            mm[p:p + len(id_blob)] = id_blob
        self._states[worker * self.depth + slot] = RESP

    def read_response(self, worker: int, slot: int) -> ShmResponse:
        off = self._slot_off(worker, slot)
        mm = self._mm
        status, n, wal_seq, gen, retry_after_s, flags = (
            _RESP_HDR.unpack_from(mm, off + _PAYLOAD_OFF)
        )
        p = off + _RESP_FIXED
        t1s = np.frombuffer(
            bytes(mm[p:p + 8 * n]), dtype=np.int64
        ) if n else np.zeros(0, np.int64)
        p += 8 * n
        ids: List[str] = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<H", mm, p)
            p += 2
            ids.append(bytes(mm[p:p + ln]).decode("utf-8"))
            p += ln
        return ShmResponse(
            status, ids, t1s, wal_seq, gen, retry_after_s, flags,
            trace_ns=_TRACE_RESP.unpack_from(mm, off + _TRACE_RESP_OFF),
        )


class FenceMirror:
    """Owner-side per-class broadcast hook, attached to that class's
    CellClock (tiers.CellClock.attach_mirror).  Every bump scatters
    into the shm fence segment; a faulted broadcast poisons the class
    floor instead of silently dropping the bump — worker caches then
    over-invalidate, which is the safe direction."""

    __slots__ = ("_region", "_cls_idx", "_cls")

    def __init__(self, region: ShmRegion, cls_idx: int):
        self._region = region
        self._cls_idx = cls_idx
        self._cls = SHM_CLASSES[cls_idx]

    def sync(self, clock) -> None:
        """Initial publish of the clock's fence metadata (attach time,
        before any worker serves)."""
        self._region.fence_write_meta(
            self._cls_idx, inc=clock.incarnation, gen=clock.generation,
            floor=clock.floor, high=clock.high_water,
        )

    def on_bump(self, key_arrays, gen: int) -> None:
        try:
            chaos.fault_point("shm.fence.broadcast", detail=self._cls)
        except chaos.FaultError:
            self._region.fence_poison(self._cls_idx)
            return
        keys = [
            np.asarray(k, np.int64).ravel()
            for k in key_arrays if k is not None
        ]
        merged = (
            np.concatenate(keys) if len(keys) > 1
            else (keys[0] if keys else np.zeros(0, np.int64))
        )
        self._region.fence_stamp(self._cls_idx, merged, gen)

    def on_bump_all(self, gen: int) -> None:
        # wholesale invalidation: floor jumps with the generation
        self._region.fence_write_meta(
            self._cls_idx, gen=gen, floor=gen
        )


class WorkerFenceView:
    """Worker-side read view of the fence segment: returns fences in
    CellClock.fence's exact shape so dar/readcache.ReadCache applies
    identical NO-TTL rules to worker-local entries."""

    __slots__ = ("_region",)

    def __init__(self, region: ShmRegion):
        self._region = region

    def fence(self, cls: str, dar_keys) -> Tuple[int, int, int, int]:
        return self._region.fence_read(SHM_CLASSES.index(cls), dar_keys)

    def epoch(self) -> str:
        # standalone --workers mode has no region epoch; the token
        # still rotates on owner-side wholesale events so workers can
        # fence on it exactly like an epoch string
        return str(self._region.epoch_token)


class StageHistWriter:
    """One process's handle on its shared stage-histogram block
    (worker i -> block i, the leader/owner -> block nworkers).
    Single-writer per block; attached to the process's MetricsRegistry
    (obs/metrics.attach_stage_writer) so every access-log stage
    observation also lands in the shared segment."""

    __slots__ = ("_row",)

    def __init__(self, region: ShmRegion, proc_index: int):
        if not 0 <= proc_index <= region.nworkers:
            raise ValueError(
                f"proc index {proc_index} outside region "
                f"({region.nworkers} workers + owner)"
            )
        self._row = region._shist[proc_index]

    def observe(self, route: str, stage: str, duration_s: float) -> None:
        base = (
            _ROUTE_IDX[route_class(route)] * len(STAGE_NAMES)
            + _STAGE_IDX[stage_name(stage)]
        ) * _SHIST_ROW
        row = self._row
        for i, b in enumerate(STAGE_BUCKETS):
            if duration_s <= b:
                row[base + i] += 1
        row[base + _SHIST_ROW - 2] += int(duration_s * 1e9)
        row[base + _SHIST_ROW - 1] += 1


def shm_stage_hist(region: ShmRegion) -> dict:
    """The whole front's dss_stage_duration_seconds data, merged
    across every process block: {(route_class, stage): (bucket counts,
    sum_s, count)}.  Zero-count rows are omitted so the exposition
    stays compact."""
    merged = np.asarray(region._shist).sum(axis=0)
    out = {}
    for r, rc in enumerate(ROUTE_CLASSES):
        for s, st in enumerate(STAGE_NAMES):
            base = (r * len(STAGE_NAMES) + s) * _SHIST_ROW
            cnt = int(merged[base + _SHIST_ROW - 1])
            if cnt == 0:
                continue
            out[(rc, st)] = (
                tuple(
                    int(x)
                    for x in merged[base:base + len(STAGE_BUCKETS)]
                ),
                merged[base + _SHIST_ROW - 2] / 1e9,
                cnt,
            )
    return out


class ShmOwner:
    """The device-owner endpoint: one scanner thread claims REQ slots
    across every worker ring and a small pool serves them through the
    store's normal search path (admission, deadline routing, planner,
    read cache — the whole pipeline), then publishes responses back
    into the same slots.  Also reclaims rings of dead workers."""

    def __init__(self, region: ShmRegion, serve_fn: Callable,
                 *, threads: int = None, wal_seq_fn: Callable = None,
                 worker_ttl_s: float = 5.0):
        """serve_fn(ShmRequest) -> (ids, t1s, gen); raises
        errors.StatusError subclasses for admission/deadline verdicts.
        wal_seq_fn() -> the WAL sequence already durable when the
        answer was computed (the worker's catchup bound)."""
        self._region = region
        self._serve_fn = serve_fn
        self._wal_seq_fn = wal_seq_fn or (lambda: 0)
        self._threads = threads or min(
            4, max(2, (os.cpu_count() or 2))
        )
        self._worker_ttl_s = worker_ttl_s
        self._stop = threading.Event()
        self._queue: "list" = []
        self._qlock = threading.Lock()
        self._qcond = threading.Condition(self._qlock)
        self._pool: List[threading.Thread] = []
        self._scanner: Optional[threading.Thread] = None
        self._dead_workers: set = set()
        # wall-clock ns when each dead worker was declared dead: only
        # a heartbeat written AFTER this (a respawned process, or a
        # stalled one that resumed) proves the worker is back
        self._dead_since: Dict[int, int] = {}
        # counters live in the region header (single-writer: this
        # process; the lock serializes the owner's own threads) so
        # every worker can render whole-front stats — see front_stats
        self._lock = threading.Lock()

    def _count(self, idx: int, n: int = 1) -> None:
        with self._lock:
            self._region._ohdr[idx] += n

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for i in range(self._threads):
            t = threading.Thread(
                target=self._serve_loop, name=f"shm-serve-{i}",
                daemon=True,
            )
            t.start()
            self._pool.append(t)
        self._scanner = threading.Thread(
            target=self._scan_loop, name="shm-scan", daemon=True
        )
        self._scanner.start()

    def close(self) -> None:
        self._stop.set()
        with self._qcond:
            self._qcond.notify_all()
        if self._scanner is not None:
            self._scanner.join(timeout=5)
        for t in self._pool:
            t.join(timeout=5)

    # -- reclaim -------------------------------------------------------------

    def reclaim_worker(self, worker: int) -> int:
        """Free a dead worker's in-flight slots: REQ slots are dropped
        unserved (the requester is gone), RESP slots are consumed on
        its behalf.  BUSY slots flip to RESP when their serve thread
        finishes and are swept on the next scan.  -> slots freed."""
        r = self._region
        freed = 0
        self._dead_workers.add(worker)
        self._dead_since[worker] = time.time_ns()
        for s in range(r.depth):
            st = r.slot_state(worker, s)
            if st in (REQ, RESP):
                r.set_slot_state(worker, s, FREE)
                freed += 1
        self._count(OH_RECLAIMED, freed)
        with self._lock:
            r._ohdr[OH_DEAD_WORKERS] = len(self._dead_workers)
        return freed

    def revive_worker(self, worker: int) -> None:
        self._dead_workers.discard(worker)
        self._dead_since.pop(worker, None)
        with self._lock:
            self._region._ohdr[OH_DEAD_WORKERS] = len(self._dead_workers)

    # -- serving -------------------------------------------------------------

    def _scan_loop(self) -> None:
        r = self._region
        idle_sleep = 0.0002
        last_ttl_check = 0.0
        while not self._stop.is_set():
            r.set_owner_heartbeat()
            states = r._states
            req_idx = np.nonzero(states == REQ)[0]
            if len(req_idx):
                claimed = []
                t_claim = time.perf_counter_ns()
                for flat in req_idx.tolist():
                    w, s = divmod(flat, r.depth)
                    if w in self._dead_workers:
                        r.set_slot_state(w, s, FREE)
                        self._count(OH_RECLAIMED)
                        continue
                    r.set_slot_state(w, s, BUSY)
                    claimed.append((w, s, t_claim))
                if claimed:
                    with self._qcond:
                        self._queue.extend(claimed)
                        self._qcond.notify_all()
                idle_sleep = 0.0002
            else:
                time.sleep(idle_sleep)
                idle_sleep = min(idle_sleep * 2, 0.002)
            # sweep RESP slots of dead workers + heartbeat-based TTL
            now = time.monotonic()
            if now - last_ttl_check > 1.0:
                last_ttl_check = now
                for w in list(self._dead_workers):
                    # a heartbeat stamped AFTER the worker was declared
                    # dead means a respawned (or resumed) process owns
                    # the row again — revive it so its requests serve
                    hb = int(r._wstats[w][WS_HEARTBEAT_NS])
                    if hb > self._dead_since.get(w, 0):
                        self.revive_worker(w)
                        continue
                    for s in range(r.depth):
                        if r.slot_state(w, s) == RESP:
                            r.set_slot_state(w, s, FREE)
                            self._count(OH_RECLAIMED)
                if self._worker_ttl_s > 0:
                    for w in range(r.nworkers):
                        if w in self._dead_workers:
                            continue
                        row = r._wstats[w]
                        hb = int(row[WS_HEARTBEAT_NS])
                        if hb and (time.time_ns() - hb) / 1e9 > self._worker_ttl_s:
                            self.reclaim_worker(w)

    def _serve_loop(self) -> None:
        r = self._region
        while True:
            with self._qcond:
                while not self._queue and not self._stop.is_set():
                    self._qcond.wait(0.1)
                if self._stop.is_set() and not self._queue:
                    return
                w, s, t_claim = self._queue.pop(0)
            t0 = time.perf_counter_ns()
            status = ST_ERROR
            try:
                req = r.read_request(w, s)
                status = self._serve_one(req, queue_wait_ns=t0 - t_claim)
            except Exception:  # noqa: BLE001 — a bad slot must not kill the pool
                self._count(OH_ERRORS)
                try:
                    r.write_response(w, s, status=ST_ERROR)
                except Exception:  # noqa: BLE001
                    r.set_slot_state(w, s, FREE)
            finally:
                with self._lock:
                    # served counts SUCCESSFUL serves only — an
                    # operator reading the drain rate during overload
                    # must not see sheds/errors inflating it (they
                    # have their own counters); serve_ns keeps total
                    # owner busy time across all outcomes
                    if status == ST_OK:
                        r._ohdr[OH_SERVED] += 1
                    r._ohdr[OH_SERVE_NS] += time.perf_counter_ns() - t0

    def _serve_one(self, req: ShmRequest, queue_wait_ns: int = 0) -> int:
        from dss_tpu_torch import errors as _errors
        from dss_tpu_torch.dar import deadline as _deadline
        from dss_tpu_torch.obs import trace as _trace

        r = self._region
        if req.deadline_ns and time.monotonic_ns() >= req.deadline_ns:
            self._count(OH_DEADLINE_DROPS)
            r.write_response(
                req.worker, req.slot, status=ST_DEADLINE,
            )
            return ST_DEADLINE
        route_dl = (
            req.deadline_ns / 1e9 if req.deadline_ns else None
        )
        if route_dl is not None:
            _deadline.set_route_deadline(route_dl)
        # sampled request: collect the serve path's spans (cache
        # lookup, admission, plan, dispatch, collect — emitted by the
        # store/coalescer seams on THIS thread) and ship them back as
        # the fixed OWNER_SLOTS duration words, so the worker stitches
        # one trace spanning both processes
        tok = None
        trace_vec = None
        t_serve0 = time.perf_counter_ns()
        if req.trace_id and req.trace_sampled:
            tok = _trace.begin_collect(req.trace_id)
        try:
            out = self._serve_fn(req)
            # (ids, t1s, gen) or (ids, t1s, gen, flags): the store
            # adds flags (RESP_F_MESH_SERVED); simple serve fns don't
            ids, t1s, gen = out[0], out[1], out[2]
            flags = out[3] if len(out) > 3 else 0
        except _errors.OverloadedError as e:
            self._count(OH_OVERLOADED)
            r.write_response(
                req.worker, req.slot, status=ST_OVERLOADED,
                retry_after_s=e.retry_after_s,
            )
            return ST_OVERLOADED
        except _errors.StatusError as e:
            status = (
                ST_DEADLINE
                if e.code == _errors.Code.DEADLINE_EXCEEDED
                else ST_ERROR
            )
            r.write_response(req.worker, req.slot, status=status)
            return status
        finally:
            if route_dl is not None:
                _deadline.set_route_deadline(None)
            if tok is not None:
                trace_vec = _trace.owner_slot_vector(
                    _trace.end_collect(tok),
                    extra={
                        "owner.queue_wait": queue_wait_ns / 1e6,
                        "owner.serve": (
                            (time.perf_counter_ns() - t_serve0) / 1e6
                        ),
                    },
                )
        r.write_response(
            req.worker, req.slot, status=ST_OK, ids=ids, t1s=t1s,
            wal_seq=self._wal_seq_fn(), gen=gen, flags=flags,
            trace_ns=trace_vec,
        )
        return ST_OK

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        return front_stats(self._region)


class ShmWorkerClient:
    """One worker process's endpoint: slot allocation (in-process lock
    — multiple request threads share the ring), request/response round
    trips, heartbeats, and the worker-owned stats block."""

    def __init__(self, region: ShmRegion, worker_index: int, *,
                 wait_s: float = None, heartbeat_s: float = 0.5):
        if not 0 <= worker_index < region.nworkers:
            raise ValueError(
                f"worker index {worker_index} outside region "
                f"({region.nworkers} workers)"
            )
        self._region = region
        self.worker = worker_index
        self._wait_s = (
            wait_s if wait_s is not None
            else float(os.environ.get("DSS_SHM_WAIT_S", 2.0))
        )
        self._alloc_lock = threading.Lock()
        self._free = list(range(region.depth))
        # slots abandoned by a timed-out waiter: reclaimed once the
        # owner has published RESP (the allocator sweeps them)
        self._abandoned: set = set()
        self._req_seq = 0
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, args=(heartbeat_s,),
            name="shm-heartbeat", daemon=True,
        )
        self._region.stat_set(
            self.worker, WS_HEARTBEAT_NS, time.time_ns()
        )
        self._hb_thread.start()

    def close(self) -> None:
        self._stop.set()

    def _hb_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            self._region.stat_set(
                self.worker, WS_HEARTBEAT_NS, time.time_ns()
            )

    def stat_add(self, idx: int, n: int = 1) -> None:
        with self._alloc_lock:
            self._region.stat_add(self.worker, idx, n)

    def in_flight(self) -> int:
        with self._alloc_lock:
            return self._region.depth - len(self._free)

    def _alloc(self) -> int:
        with self._alloc_lock:
            # sweep abandoned slots the owner has finished with: RESP
            # (the answer landed after we gave up — consume it) or
            # FREE (the owner reclaimed the slot, e.g. after TTL-
            # declaring this worker dead during a stall; REQ/BUSY
            # slots stay the owner's until it publishes one of those)
            for s in list(self._abandoned):
                st = self._region.slot_state(self.worker, s)
                if st == RESP:
                    self._region.set_slot_state(self.worker, s, FREE)
                elif st != FREE:
                    continue
                self._abandoned.discard(s)
                self._free.append(s)
            # only hand out a slot the SHARED state agrees is FREE: a
            # respawned incarnation starts with a full local free list,
            # but the previous incarnation's in-flight slots may still
            # be BUSY in the owner — writing a new request over one
            # would let the old serve's response answer the new query
            # (bit-identity violation).  Non-FREE slots park in
            # _abandoned until the owner returns them.
            while self._free:
                s = self._free.pop()
                if self._region.slot_state(self.worker, s) == FREE:
                    return s
                self._abandoned.add(s)
            self._region.stat_add(self.worker, WS_RING_FULL)
            raise RingFull("no free slot")

    def _release(self, slot: int) -> None:
        with self._alloc_lock:
            self._free.append(slot)

    def call(self, *, cls: str, cells, alt_lo=None, alt_hi=None,
             t0_ns=None, t1_ns=None, now_ns: int, owner: str = None,
             allow_stale: bool = False,
             deadline_s: float = None,
             trace_id: str = None,
             trace_sampled: bool = False) -> ShmResponse:
        """One round trip.  Raises RingFull / RingOversize /
        RingTimeout — all of which the caller maps to the loopback
        proxy fallback.  The chaos seam `shm.ring.enqueue` fires
        before the slot is touched, so an injected fault costs
        nothing but the fallback.  `trace_id`/`trace_sampled` ride the
        slot's reserved trace words; a sampled request's response
        carries the owner's span-slot durations back (trace_ns)."""
        chaos.fault_point("shm.ring.enqueue", detail=cls)
        r = self._region
        slot = self._alloc()
        wrote = False
        try:
            self._req_seq += 1
            req_id = self._req_seq
            wait_s = self._wait_s
            if deadline_s is not None:
                wait_s = min(wait_s, max(0.001, deadline_s))
            deadline_ns = time.monotonic_ns() + int(wait_s * 1e9)
            r.write_request(
                self.worker, slot, req_id,
                cls_idx=SHM_CLASSES.index(cls), cells=cells,
                alt_lo=alt_lo, alt_hi=alt_hi, t0_ns=t0_ns, t1_ns=t1_ns,
                now_ns=now_ns, deadline_ns=deadline_ns,
                owner=owner or "", allow_stale=allow_stale,
                trace_id=trace_id, trace_sampled=trace_sampled,
            )
            wrote = True
            self._region.stat_add(self.worker, WS_ENQUEUED)
            # spin-then-sleep wait: first ~200us busy (the common
            # owner turnaround), then short sleeps up to the bound
            t_end = time.monotonic_ns() + int(wait_s * 1e9)
            spin_until = time.monotonic_ns() + 200_000
            sleep_s = 0.0
            while True:
                st = r.slot_state(self.worker, slot)
                if st == RESP:
                    break
                if st == FREE:
                    # the owner reclaimed this slot unserved (it
                    # declared this worker dead — a stall or a prior
                    # incarnation's death): no response is coming, so
                    # take the slot back and fall back NOW instead of
                    # burning the whole wait bound
                    self._release(slot)
                    slot = None
                    self._region.stat_add(self.worker, WS_TIMEOUTS)
                    raise RingTimeout(
                        "owner reclaimed the slot (worker marked dead)"
                    )
                now = time.monotonic_ns()
                if now >= t_end:
                    with self._alloc_lock:
                        self._abandoned.add(slot)
                    self._region.stat_add(self.worker, WS_TIMEOUTS)
                    raise RingTimeout(
                        f"owner did not answer within {wait_s:g}s"
                    )
                if now < spin_until:
                    continue
                sleep_s = min(sleep_s + 0.00005, 0.001)
                time.sleep(sleep_s)
            resp = r.read_response(self.worker, slot)
            r.set_slot_state(self.worker, slot, FREE)
            self._release(slot)
            slot = None
            return resp
        except RingOversize:
            self._region.stat_add(self.worker, WS_OVERSIZE)
            raise
        finally:
            if slot is not None and not wrote:
                self._release(slot)
            # wrote-but-failed slots stay abandoned (owner owns them)

    def stats(self) -> Dict[str, int]:
        return self._region.worker_stats(self.worker)

"""Multi-region federation: locality routing + bounded-stale remotes.

The port of the reference's `dss_tpu/region/federation.py`.  Each
region is a port store (standalone or in region mode); its searches
reach B1 through the store's own coalescer, and the federation adds
no device code.  The peer transport rides `http.client` (see
HttpPeerTransport); everything else is the reference's.

Everything below dss_tpu_torch.region so far is ONE DSS Region scaled up
— N instances sharing one airspace representation through one region
log. Production at millions of users is N such regions *federated*: each
region owns a contiguous slice of the S2 key space (its airspace), and
the partition-by-locality argument of the many-core geospatial work
(arXiv:1403.0802) applies at region granularity — route the query to the
region that owns its cells, and never let a remote outage take down
local serving.

Pieces:

  FederationMap     format-versioned S2-key-range -> region ownership.
                    Split points come from the SAME weighted_boundaries
                    splitter the elastic shard placement uses, with
                    region-level `capacity_weight`s from autotune
                    profiles (plan/autotune.py) — a region of slow
                    hosts owns a proportionally lighter key run.
  FederationPeer    one remote region's transport: every call runs
                    through the shared CircuitBreaker
                    (chaos/retry.py); the `region.federation.request`
                    fault site injects partitions deterministically.
  FollowerMirror    a local, declared-lag follower of a remote
                    region's state, refreshed by a sync loop (the
                    `region.federation.sync` fault site).  The DEGRADED
                    read path: when the remote's breaker is open,
                    bounded-stale queries serve from the mirror as
                    long as its lag is inside the declared bound.
  FederationRouter  the routing core: split a canonical covering by
                    ownership, serve the local slice from the local
                    store, fan out remote slices to peers, merge
                    order-normalized (sorted by entity id) — a global
                    query over disjoint regions is bit-identical to a
                    single merged region.  Remote failures walk the
                    ladder: breaker opens -> FEDERATION_DEGRADED,
                    bounded-stale reads fall back to the mirror or
                    503 with the breaker cooldown as honest
                    Retry-After; writes to remote-owned cells 503
                    honestly; local-airspace serving never sees a 5xx.
  Federated*Store   RIDStore/SCDStore wrappers "in front of the
                    store": searches federate, cells-carrying writes
                    are ownership-guarded, everything else delegates.

Staleness contract: a remote answer is bounded-stale by construction
(transport + the remote instance's own tail-poll lag); a MIRROR answer
additionally carries the mirror's measured lag and is only served when
that lag is inside the effective bound

    min(DSS_FED_STALE_LAG_S, the request's X-DSS-Max-Lag header)

— a request whose declared bound the mirror exceeds is rejected 503
with Retry-After (the breaker cooldown), never silently served staler.
Every federated answer notes the serving region(s), mode
(local/remote/stale) and lag for the X-DSS-Freshness header.

Recovery: the sync loop keeps probing an open peer (its calls are the
half-open probes); the first successful sync re-syncs the follower
tail and only THEN exits FEDERATION_DEGRADED (the ladder's on_recover
hook re-syncs again defensively), so remote routes are re-admitted
with a warm mirror behind them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.clock import from_nanos, to_nanos
from dss_tpu_torch.dar import codec
from dss_tpu_torch.dar.store import RIDStore, SCDStore
from dss_tpu_torch.geo.covering import canonical_cells
from dss_tpu_torch.geo.s2cell import cell_to_dar_key

MAP_FORMAT = 1

# entity class -> (doc_to_record, record_to_doc, field spec) where the
# field spec maps the per-model attribute names the mirror's linear
# filter needs (rid models say altitude_lo/hi + start/end_time, scd
# operations/constraints say altitude_lower/upper)
_CLS_CODEC = {
    "isa": (codec.doc_to_isa, codec.isa_to_doc,
            ("altitude_lo", "altitude_hi", "start_time", "end_time")),
    "rid_sub": (codec.doc_to_rid_sub, codec.rid_sub_to_doc,
                ("altitude_lo", "altitude_hi", "start_time", "end_time")),
    "op": (codec.doc_to_op, codec.op_to_doc,
           ("altitude_lower", "altitude_upper", "start_time", "end_time")),
    "scd_sub": (codec.doc_to_scd_sub, codec.scd_sub_to_doc,
                ("altitude_lo", "altitude_hi", "start_time", "end_time")),
    "constraint": (codec.doc_to_constraint, codec.constraint_to_doc,
                   ("altitude_lower", "altitude_upper",
                    "start_time", "end_time")),
}

# serving-mode severity for the freshness note (worst mode wins when a
# fan-out mixes them)
_MODE_RANK = {"local": 0, "remote": 1, "stale": 2}


def env_knobs() -> dict:
    """FederationRouter kwargs from DSS_FED_* env vars
    (docs/OPERATIONS.md knob table)."""
    return {
        "stale_lag_s": float(os.environ.get("DSS_FED_STALE_LAG_S", 15.0)),
        "sync_interval_s": float(
            os.environ.get("DSS_FED_SYNC_INTERVAL_S", 0.5)
        ),
        "peer_timeout_s": float(
            os.environ.get("DSS_FED_PEER_TIMEOUT_S", 3.0)
        ),
        "breaker_fails": int(os.environ.get("DSS_FED_BREAKER_FAILS", 3)),
        "breaker_reset_s": float(
            os.environ.get("DSS_FED_BREAKER_RESET_S", 2.0)
        ),
    }


class PeerError(RuntimeError):
    """A federation peer call failed.  `transport=True` (the default)
    means a link/availability failure (connection error, 5xx,
    injected partition) — these count toward the peer's circuit
    breaker and can page a partition.  `transport=False` means the
    peer ANSWERED and refused (4xx — typically a DSS_FED_TOKEN
    misconfiguration): the link is fine, so the breaker must not
    open and DssFederationPartitioned must not fire for a config
    error."""

    def __init__(self, message: str, *, transport: bool = True):
        super().__init__(message)
        self.transport = transport


class FederationUnavailable(errors.StatusError):
    """A cross-region read/write could not be served inside the
    staleness contract: 503 with the breaker cooldown as an honest
    Retry-After (the same shape OverloadedError gives 429s)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(errors.Code.UNAVAILABLE, message)
        self.retry_after_s = float(retry_after_s)


# -- the ownership map --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionEntry:
    """One federated region: its id, peer base URLs (the DSS
    instances' HTTP endpoints), and its measured serving capacity
    scalar (autotune profile `capacity_weight`; drives the splitter)."""

    id: str
    urls: Tuple[str, ...] = ()
    capacity_weight: float = 1.0


class FederationMap:
    """S2-key-range -> region ownership, format-versioned.

    `regions` is ordered by key range: region i owns DAR keys in
    [boundaries[i-1], boundaries[i]) (half-open, int32 key space ends
    implicit).  The same representation the sharded replica uses for
    its boundary map — ownership at region granularity instead of
    shard granularity."""

    def __init__(
        self,
        regions: List[RegionEntry],
        boundaries: np.ndarray,
        local: str,
    ):
        if len(regions) < 1:
            raise ValueError("federation map needs at least one region")
        b = np.asarray(boundaries, np.int32).ravel()
        if len(b) != len(regions) - 1:
            raise ValueError(
                f"{len(regions)} regions need {len(regions) - 1} "
                f"boundaries, got {len(b)}"
            )
        if len(b) > 1 and not np.all(np.diff(b) >= 0):
            raise ValueError("federation boundaries must be sorted")
        ids = [r.id for r in regions]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate region ids in {ids}")
        if local not in ids:
            raise ValueError(
                f"local region {local!r} not in map ({ids})"
            )
        self.regions = list(regions)
        self.boundaries = b
        self.local = local
        self._by_id = {r.id: r for r in regions}

    def entry(self, region_id: str) -> RegionEntry:
        return self._by_id[region_id]

    @property
    def region_ids(self) -> List[str]:
        return [r.id for r in self.regions]

    def remote_ids(self) -> List[str]:
        return [r.id for r in self.regions if r.id != self.local]

    def owner_of_cells(self, cells_u64) -> np.ndarray:
        """Per-cell owning-region index (into self.regions)."""
        keys = cell_to_dar_key(np.asarray(cells_u64, np.uint64))
        return np.searchsorted(self.boundaries, keys, side="right")

    def split_cells(self, cells_u64) -> Dict[str, np.ndarray]:
        """Canonical covering -> {region_id: cell subset} (subsets
        keep the canonical order, so per-region coverings stay
        canonical and cache/pack-friendly on the serving side)."""
        cells = np.asarray(cells_u64, np.uint64).ravel()
        if cells.size == 0:
            return {}
        idx = self.owner_of_cells(cells)
        out: Dict[str, np.ndarray] = {}
        for i, r in enumerate(self.regions):
            sub = cells[idx == i]
            if sub.size:
                out[r.id] = sub
        return out

    @classmethod
    def plan(
        cls,
        entries: List[RegionEntry],
        post_key: np.ndarray,
        weights: Optional[np.ndarray] = None,
        *,
        local: Optional[str] = None,
    ) -> "FederationMap":
        """Plan ownership from observed postings + measured load with
        the SAME splitter the elastic shard placement uses
        (parallel/sharded.weighted_boundaries), with each region's
        autotune `capacity_weight` as its target-work scalar: a
        federation of heterogeneous regions splits the airspace by
        measured capacity, not equal key count."""
        from dss_tpu_torch.parallel.sharded import weighted_boundaries

        cap = np.asarray(
            [max(1e-6, float(e.capacity_weight)) for e in entries],
            np.float64,
        )
        b = weighted_boundaries(
            np.asarray(post_key, np.int32),
            weights,
            len(entries),
            member_capacity=cap,
        )
        if b is None:
            b = np.zeros(0, np.int32) if len(entries) == 1 else None
        if b is None:
            raise ValueError("nothing to split the key space over")
        return cls(entries, b, local or entries[0].id)

    # -- persistence (format-versioned, the deploy artifact) ---------------

    def to_doc(self) -> dict:
        return {
            "format": MAP_FORMAT,
            "local": self.local,
            "regions": [
                {
                    "id": r.id,
                    "urls": list(r.urls),
                    "capacity_weight": r.capacity_weight,
                }
                for r in self.regions
            ],
            "boundaries": [int(b) for b in self.boundaries],
        }

    @classmethod
    def from_doc(cls, d: dict, *, local: Optional[str] = None):
        fmt = int(d.get("format", 0))
        if fmt > MAP_FORMAT:
            raise ValueError(
                f"federation map format {fmt} is newer than this "
                f"binary ({MAP_FORMAT})"
            )
        regions = [
            RegionEntry(
                id=str(r["id"]),
                urls=tuple(r.get("urls", ())),
                capacity_weight=float(r.get("capacity_weight", 1.0)),
            )
            for r in d.get("regions", [])
        ]
        return cls(
            regions,
            np.asarray(d.get("boundaries", []), np.int32),
            local or str(d.get("local", "")),
        )

    @classmethod
    def load(cls, path: str, *, local: Optional[str] = None):
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_doc(json.load(fh), local=local)

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_doc(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path


# -- peer transport -----------------------------------------------------------


class HttpPeerTransport:
    """HTTP transport to one remote region's DSS instances.  One
    attempt per configured URL, failing over in order — deliberately
    NO backoff ladder here: fail fast and let the router's breaker +
    the mirror fallback own the slow-path policy (the read-cache
    lesson from the region client: a fence consult must never stall
    behind a retry ladder).

    It rides the standard library's `http.client` through the region
    client's keep-alive transport (one connection per thread and
    endpoint), where the reference rides `requests.Session`: a
    connection error, a timeout or a malformed exchange raises
    `TransportError`, which takes the reference's
    `requests.RequestException` path."""

    def __init__(self, region_id: str, urls, *, timeout_s: float = 3.0,
                 token: Optional[str] = None):
        from dss_tpu_torch.region.client import _Transport

        self.region_id = region_id
        self.urls = [u.rstrip("/") for u in urls if u]
        if not self.urls:
            raise ValueError(f"region {region_id!r} has no peer URLs")
        self._timeout = float(timeout_s)
        headers = {}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        self._session = _Transport(headers)

    def __call__(self, method: str, path: str,
                 payload: Optional[dict] = None) -> dict:
        from dss_tpu_torch.obs import trace as _trace
        from dss_tpu_torch.region.client import TransportError

        last = "unreachable"
        # one trace id across the federation hop: the peer's trace
        # middleware joins this traceparent instead of minting fresh,
        # and echoes the id on error responses
        tp = _trace.propagation_headers()
        for url in self.urls:
            try:
                # chaos seam: an injected partition here reads exactly
                # like a dead cross-region link (breaker-counted,
                # mirror fallback)
                chaos.fault_point(
                    "region.federation.request",
                    detail=f"{self.region_id}:{url}{path}",
                )
                with _trace.span(
                    "federation.request", region=self.region_id
                ):
                    r = self._session.request(
                        method, url + path, json=payload,
                        timeout=self._timeout,
                        headers=tp or None,
                    )
            except (TransportError, chaos.FaultError) as e:
                last = f"{url}: {e}"
                continue
            if r.status_code >= 500:
                last = f"{url}: {r.status_code}"
                continue
            if r.status_code != 200:
                # the peer answered and refused: a config error
                # (auth, bad payload), not a partition
                raise PeerError(
                    f"{self.region_id}{path}: {r.status_code} "
                    f"{r.text[:200]}",
                    transport=False,
                )
            try:
                body = r.json()
            except ValueError as e:
                # a 200 with garbage IS peer sickness: breaker-counted
                raise PeerError(
                    f"{self.region_id}{path}: malformed body ({e})"
                )
            return body if isinstance(body, dict) else {}
        raise PeerError(f"region {self.region_id} unreachable: {last}")


class FederationPeer:
    """One remote region behind its circuit breaker.  `transport` is
    any callable(method, path, payload) -> dict raising PeerError —
    HTTP in production, an in-process call in tests."""

    def __init__(self, region_id: str, transport: Callable, *,
                 fail_threshold: int = 3, reset_s: float = 2.0,
                 clock=time.monotonic):
        self.region_id = region_id
        self.transport = transport
        self.breaker = chaos.CircuitBreaker(
            fail_threshold=fail_threshold, reset_s=reset_s, clock=clock
        )
        self.requests = 0
        self.failures = 0

    def call(self, method: str, path: str,
             payload: Optional[dict] = None) -> dict:
        self.requests += 1
        try:
            body = self.transport(method, path, payload)
        except (PeerError, chaos.FaultError) as e:
            # an injected FaultError surfacing from an in-process
            # transport is the same partition the HTTP transport
            # already converts — breaker-counted either way.  A
            # non-transport refusal (4xx) is counted as a failure but
            # never opens the breaker: the link is healthy, the
            # CONFIG is broken, and paging a partition would send the
            # operator chasing the network.
            self.failures += 1
            if isinstance(e, PeerError):
                if e.transport:
                    self.breaker.record_failure()
                raise
            self.breaker.record_failure()
            raise PeerError(f"{self.region_id}: {e}") from e
        self.breaker.record_success()
        return body

    def query(self, cls: str, cells_u64, alt_lo, alt_hi, t0_ns, t1_ns,
              now_ns, owner: Optional[str]) -> Tuple[list, dict]:
        """-> (records, freshness dict from the serving region)."""
        body = self.call(
            "POST", "/aux/v1/federation/query",
            {
                "cls": cls,
                "cells": [int(c) for c in np.asarray(cells_u64, np.uint64)],
                "alt_lo": alt_lo,
                "alt_hi": alt_hi,
                "t0_ns": t0_ns,
                "t1_ns": t1_ns,
                "now_ns": int(now_ns),
                "owner": owner,
            },
        )
        to_rec = _CLS_CODEC[cls][0]
        try:
            recs = [to_rec(d) for d in body.get("docs", [])]
        except (KeyError, TypeError, ValueError) as e:
            # a 200 carrying undecodable docs is peer sickness (codec
            # mismatch, a rewriting proxy): call() already recorded a
            # success, so count the failure here or the breaker never
            # opens and the outage stays invisible
            self.failures += 1
            self.breaker.record_failure()
            raise PeerError(
                f"{self.region_id}: malformed federation docs ({e!r})"
            )
        return recs, body.get("freshness", {})

    def sync(self) -> dict:
        return self.call("GET", "/aux/v1/federation/sync")


# -- the local follower mirror ------------------------------------------------


class FollowerMirror:
    """Declared-lag local follower of one remote region's state.

    Refreshed wholesale by the sync loop (full-state re-sync — the
    bounded degraded path, not the serving hot path; sized for a
    region's *airspace representation*, which the reference keeps
    snapshot-shippable by design).  Queries run through the SAME
    `dar.oracle.search` every backend is differential-tested against
    (records are converted to oracle Records once per refresh), so a
    mirror answer differs from the remote's fresh answer only by the
    mirror's measured lag — which is what the contract declares — and
    a future oracle semantics fix propagates here structurally."""

    def __init__(self, region_id: str, clock=time.monotonic):
        self.region_id = region_id
        self._clock = clock
        self._lock = threading.Lock()
        # per class: parallel lists of model records + oracle Records
        self._recs: Dict[str, list] = {c: [] for c in _CLS_CODEC}
        self._oracle: Dict[str, dict] = {c: {} for c in _CLS_CODEC}
        self._owner_ids: Dict[str, int] = {}
        self.epoch = ""
        self.gens: Dict[str, int] = {}
        self._synced_at: Optional[float] = None
        self.syncs = 0

    def apply_sync(self, body: dict) -> None:
        from dss_tpu_torch.dar.oracle import Record as ORecord

        state = body.get("state", {})
        rid_state = state.get("rid", {})
        scd_state = state.get("scd", {})
        fresh_recs: Dict[str, list] = {c: [] for c in _CLS_CODEC}
        fresh_oracle: Dict[str, dict] = {c: {} for c in _CLS_CODEC}
        owner_ids: Dict[str, int] = {}
        for cls, docs in (
            ("isa", rid_state.get("isas", [])),
            ("rid_sub", rid_state.get("subs", [])),
            ("op", scd_state.get("ops", [])),
            ("scd_sub", scd_state.get("subs", [])),
            ("constraint", scd_state.get("constraints", [])),
        ):
            to_rec = _CLS_CODEC[cls][0]
            alo_f, ahi_f, t0_f, t1_f = _CLS_CODEC[cls][2]
            for d in docs:
                rec = to_rec(d)
                # convert ONCE per refresh: queries become pure
                # oracle.search calls over prebuilt Records (the
                # degraded path during a partition pays dict probes,
                # not per-read numpy conversions)
                alo = getattr(rec, alo_f)
                ahi = getattr(rec, ahi_f)
                slot = len(fresh_recs[cls])
                fresh_recs[cls].append(rec)
                fresh_oracle[cls][slot] = ORecord(
                    entity_id=rec.id,
                    keys=np.unique(cell_to_dar_key(
                        np.asarray(rec.cells, np.uint64)
                    )),
                    alt_lo=-np.inf if alo is None else float(alo),
                    alt_hi=np.inf if ahi is None else float(ahi),
                    t_start=to_nanos(getattr(rec, t0_f)),
                    t_end=to_nanos(getattr(rec, t1_f)),
                    owner_id=owner_ids.setdefault(
                        rec.owner, len(owner_ids)
                    ),
                )
        with self._lock:
            self._recs = fresh_recs
            self._oracle = fresh_oracle
            self._owner_ids = owner_ids
            self.epoch = str(body.get("epoch", ""))
            self.gens = {
                k: int(v) for k, v in body.get("gens", {}).items()
            }
            self._synced_at = self._clock()
            self.syncs += 1

    def lag_s(self) -> float:
        with self._lock:
            if self._synced_at is None:
                return float("inf")
            return max(0.0, self._clock() - self._synced_at)

    @property
    def synced(self) -> bool:
        return self._synced_at is not None

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {c: len(m) for c, m in self._recs.items()}

    def search(self, cls: str, cells_u64, alt_lo, alt_hi, t0_ns, t1_ns,
               now_ns: int, owner: Optional[str] = None) -> list:
        """dar.oracle.search over the mirrored Records (owner scoping
        via the mirror's own interner; an owner the mirror has never
        seen matches nothing, exactly like a fresh index would)."""
        from dss_tpu_torch.dar import oracle as _oracle

        keys = cell_to_dar_key(np.asarray(cells_u64, np.uint64))
        with self._lock:
            recs = self._recs[cls]
            orecs = self._oracle[cls]
            owner_id = (
                None if owner is None
                else self._owner_ids.get(owner, -1)
            )
        slots = _oracle.search(
            orecs, keys, alt_lo, alt_hi, t0_ns, t1_ns, now_ns,
            owner_id,
        )
        return [dataclasses.replace(recs[s]) for s in slots]


# -- per-request thread-local plumbing ---------------------------------------
#
# Same discipline as dar/readcache's freshness note: the store's
# search path runs synchronously on one thread; the HTTP layer sets
# the request's declared lag bound before the service call and takes
# the federation serving note after it, on the SAME thread.

_tls = threading.local()


def set_lag_bound(bound_s: Optional[float]) -> None:
    _tls.lag_bound = bound_s


def get_lag_bound() -> Optional[float]:
    return getattr(_tls, "lag_bound", None)


def note_serving(region: str, mode: str, *, lag_s: float = 0.0,
                 epoch: str = "", gen: int = 0, cls: str = "") -> None:
    """Accumulate serving provenance for X-DSS-Freshness: regions
    joined, WORST mode wins (stale > remote > local), max lag; the
    first remote epoch/gen is kept for queries with no local slice."""
    n = getattr(_tls, "fed", None)
    if n is None:
        n = {
            "regions": [], "mode": "local", "lag_s": 0.0,
            "epoch": "", "gen": 0, "cls": cls,
        }
        _tls.fed = n
    if region and region not in n["regions"]:
        n["regions"].append(region)
    if _MODE_RANK.get(mode, 0) > _MODE_RANK.get(n["mode"], 0):
        n["mode"] = mode
    n["lag_s"] = max(n["lag_s"], float(lag_s))
    if epoch and not n["epoch"]:
        n["epoch"] = epoch
        n["gen"] = int(gen)
    if cls and not n["cls"]:
        n["cls"] = cls


def take_fed_note() -> Optional[dict]:
    n = getattr(_tls, "fed", None)
    _tls.fed = None
    return n


# -- the router ---------------------------------------------------------------


class FederationRouter:
    """Locality routing + bounded-stale remote reads + the
    FEDERATION_DEGRADED rung.  Bind to a DSSStore with
    DSSStore.attach_federation(router)."""

    def __init__(
        self,
        fmap: FederationMap,
        peers: Dict[str, FederationPeer],
        *,
        stale_lag_s: float = 15.0,
        sync_interval_s: float = 0.5,
        clock=time.monotonic,
    ):
        missing = set(fmap.remote_ids()) - set(peers)
        if missing:
            raise ValueError(
                f"no peer transport for remote regions {sorted(missing)}"
            )
        self.fmap = fmap
        self.peers = dict(peers)
        self.stale_lag_s = float(stale_lag_s)
        self.sync_interval_s = float(sync_interval_s)
        self._clock = clock
        self.mirrors = {
            r: FollowerMirror(r, clock=clock) for r in self.peers
        }
        self.health = None  # chaos.DegradationLadder (set_health)
        self._local_rid = None
        self._local_scd = None
        self._epoch_fn: Callable[[], str] = lambda: ""
        self._wall_clock = None  # dss clock (sync stamps)
        # peers currently considered down (breaker opened); recovery
        # requires a successful SYNC, not just any request — the
        # ladder only walks back once the follower tail is fresh
        self._down: set = set()
        self._down_lock = threading.Lock()
        self._stop = threading.Event()
        self._sync_thread: Optional[threading.Thread] = None
        # counters (dss_fed_* gauges)
        self.local_queries = 0
        self.remote_queries = 0
        self.stale_served = 0
        self.shed = 0
        self.writes_rejected = 0
        self.syncs = 0
        self.sync_failures = 0

    # -- construction helpers ----------------------------------------------

    @classmethod
    def from_map(
        cls,
        fmap: FederationMap,
        *,
        stale_lag_s: float = 15.0,
        sync_interval_s: float = 0.5,
        peer_timeout_s: float = 3.0,
        breaker_fails: int = 3,
        breaker_reset_s: float = 2.0,
        token: Optional[str] = None,
    ) -> "FederationRouter":
        """Build the router with HTTP transports from the map's peer
        URLs (the cmds/server.py boot path)."""
        peers = {}
        for rid in fmap.remote_ids():
            entry = fmap.entry(rid)
            peers[rid] = FederationPeer(
                rid,
                HttpPeerTransport(
                    rid, entry.urls, timeout_s=peer_timeout_s,
                    token=token,
                ),
                fail_threshold=breaker_fails,
                reset_s=breaker_reset_s,
            )
        return cls(
            fmap, peers,
            stale_lag_s=stale_lag_s, sync_interval_s=sync_interval_s,
        )

    def bind_local(self, rid_store, scd_store, *, epoch_fn=None,
                   wall_clock=None) -> None:
        """Attach the UNWRAPPED local stores (serve_query/serve_sync
        answer from these — a remote's query must never recurse back
        through the federation layer)."""
        self._local_rid = rid_store
        self._local_scd = scd_store
        if epoch_fn is not None:
            self._epoch_fn = epoch_fn
        self._wall_clock = wall_clock

    def set_health(self, ladder) -> None:
        self.health = ladder
        if ladder is not None:
            # recovery re-syncs the follower tail BEFORE the condition
            # clears: remote routes re-admit with a warm mirror
            ladder.on_recover("federation_degraded", self.resync_mirrors)

    # -- sync loop ----------------------------------------------------------

    def start(self) -> None:
        if self._sync_thread is not None or not self.peers:
            return
        self._stop.clear()
        self._sync_thread = threading.Thread(
            target=self._sync_loop, name="federation-sync", daemon=True
        )
        self._sync_thread.start()

    def close(self) -> None:
        self._stop.set()
        t, self._sync_thread = self._sync_thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _sync_loop(self) -> None:
        while not self._stop.is_set():
            for rid in list(self.peers):
                if self._stop.is_set():
                    break
                self.sync_peer(rid)
            self._stop.wait(self.sync_interval_s)

    def sync_peer(self, region_id: str) -> bool:
        """One follower-tail refresh from a peer.  Success applies the
        state to the mirror and (on a recovery edge) walks the ladder
        back; failure counts into the breaker and may walk it up."""
        peer = self.peers[region_id]
        try:
            # chaos seam: the follower-tail refresh link, separate
            # from the request path (a partition can hit either)
            chaos.fault_point("region.federation.sync", detail=region_id)
            body = peer.sync()
        except Exception as e:  # noqa: BLE001 — the sync loop must
            # survive ANY peer failure shape (transport, injected
            # fault, a peer that answers 503 while it boots)
            if not isinstance(e, PeerError):
                peer.failures += 1
                peer.breaker.record_failure()
            self.sync_failures += 1
            self._note_peer_failed(region_id, str(e))
            return False
        try:
            self.mirrors[region_id].apply_sync(body)
        except Exception as e:  # noqa: BLE001 — malformed state is a
            # peer fault: count it, keep the previous mirror snapshot
            peer.failures += 1
            peer.breaker.record_failure()
            self.sync_failures += 1
            self._note_peer_failed(region_id, f"malformed sync: {e!r}")
            return False
        self.syncs += 1
        self._note_peer_ok(region_id)
        return True

    def resync_mirrors(self) -> None:
        """Ladder on_recover hook: best-effort tail re-sync of every
        down peer before FEDERATION_DEGRADED clears."""
        with self._down_lock:
            down = set(self._down)
        for rid in down:
            peer = self.peers[rid]
            try:
                self.mirrors[rid].apply_sync(peer.sync())
            except (PeerError, chaos.FaultError):
                pass

    def _note_peer_failed(self, region_id: str, reason: str) -> None:
        if not self.peers[region_id].breaker.allow():
            with self._down_lock:
                fresh = region_id not in self._down
                self._down.add(region_id)
            if fresh and self.health is not None:
                self.health.enter(
                    "federation_degraded",
                    f"region {region_id} unreachable: {reason[:200]}",
                )

    def _note_peer_ok(self, region_id: str) -> None:
        with self._down_lock:
            was_down = region_id in self._down
            self._down.discard(region_id)
            any_down = bool(self._down)
        if was_down and not any_down and self.health is not None:
            self.health.exit("federation_degraded")

    # -- routing core -------------------------------------------------------

    def split(self, cells_u64) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Canonical covering -> (local slice, {remote: slice})."""
        parts = self.fmap.split_cells(cells_u64)
        local = parts.pop(
            self.fmap.local, np.zeros(0, np.uint64)
        )
        return local, parts

    def effective_lag_bound(self) -> float:
        """The staleness contract for THIS request: the server's
        configured bound tightened by the request's declared
        X-DSS-Max-Lag (a client may demand fresher, never staler)."""
        bound = self.stale_lag_s
        req = get_lag_bound()
        if req is not None:
            bound = min(bound, max(0.0, float(req)))
        return bound

    def remote_search(
        self, cls: str, region_id: str, cells_u64, alt_lo, alt_hi,
        t0_ns, t1_ns, now_ns: int, *, allow_stale: bool,
        owner: Optional[str] = None,
    ) -> list:
        """One remote region's slice of a federated query: live peer
        read when the breaker allows, declared-lag mirror read when it
        doesn't (bounded-stale only), honest 503 otherwise."""
        from dss_tpu_torch.plan.planner import decide_federation_read

        peer = self.peers[region_id]
        mirror = self.mirrors[region_id]
        bound = self.effective_lag_bound()

        def plan(peer_allowed: bool):
            return decide_federation_read(
                peer_allowed=peer_allowed,
                cooldown_s=peer.breaker.cooldown_remaining_s(),
                mirror_synced=mirror.synced,
                mirror_lag_s=mirror.lag_s(),
                lag_bound_s=bound,
                allow_stale=allow_stale,
            )

        p = plan(peer.breaker.allow())
        if p.route == "remote":
            try:
                recs, fresh = peer.query(
                    cls, cells_u64, alt_lo, alt_hi, t0_ns, t1_ns,
                    now_ns, owner,
                )
            except PeerError as e:
                self._note_peer_failed(region_id, str(e))
                p = plan(False)
            else:
                self.remote_queries += 1
                note_serving(
                    region_id, "remote",
                    lag_s=float(fresh.get("lag_s", 0.0)),
                    epoch=str(fresh.get("epoch", "")),
                    gen=int(fresh.get("gen", 0)),
                    cls=cls,
                )
                return recs
        if p.route == "stale":
            self.stale_served += 1
            note_serving(
                region_id, "stale", lag_s=mirror.lag_s(),
                epoch=mirror.epoch, gen=mirror.gens.get(cls, 0),
                cls=cls,
            )
            return mirror.search(
                cls, cells_u64, alt_lo, alt_hi, t0_ns, t1_ns, now_ns,
                owner=owner,
            )
        self.shed += 1
        lag = mirror.lag_s()
        raise FederationUnavailable(
            f"region {region_id} unreachable and its follower mirror "
            f"{'is not synced' if not mirror.synced else f'lags {lag:.1f}s'}"
            f" (declared bound {bound:.1f}s)",
            retry_after_s=p.retry_after_s,
        )

    def check_write(self, cells_u64) -> None:
        """Ownership guard for cells-carrying mutations: a write whose
        covering includes remote-owned cells never mutates local
        state.  Reachable owner -> 400 with the owning region's URLs
        (a locality-routing client error); unreachable owner -> 503
        with the breaker cooldown (honest: the right region exists,
        the link doesn't)."""
        _local, remote = self.split(canonical_cells(cells_u64))
        if not remote:
            return
        self.writes_rejected += 1
        owners = sorted(remote)
        unreachable = [
            r for r in owners if not self.peers[r].breaker.allow()
        ]
        if unreachable:
            raise FederationUnavailable(
                f"cells owned by region(s) {owners} and "
                f"{unreachable} unreachable across the federation link",
                retry_after_s=max(
                    0.5,
                    max(
                        self.peers[r].breaker.cooldown_remaining_s()
                        for r in unreachable
                    ),
                ),
            )
        hints = {
            r: list(self.fmap.entry(r).urls) for r in owners
        }
        raise errors.StatusError(
            errors.Code.FAILED_PRECONDITION,
            f"write covers airspace owned by region(s) {owners}; "
            f"send it to the owning region: {hints}",
        )

    # -- introspection ------------------------------------------------------

    def partitioned(self) -> bool:
        with self._down_lock:
            return bool(self._down)

    def stats(self) -> dict:
        return {
            "dss_fed_partitioned": 1.0 if self.partitioned() else 0.0,
            "dss_fed_peer_state": {
                r: float(p.breaker.state) for r, p in self.peers.items()
            },
            "dss_fed_mirror_lag_s": {
                r: round(min(m.lag_s(), 1e9), 3)
                for r, m in self.mirrors.items()
            },
            "dss_fed_local_queries": float(self.local_queries),
            "dss_fed_remote_queries": float(self.remote_queries),
            "dss_fed_stale_served": float(self.stale_served),
            "dss_fed_shed": float(self.shed),
            "dss_fed_writes_rejected": float(self.writes_rejected),
            "dss_fed_syncs": float(self.syncs),
            "dss_fed_sync_failures": float(self.sync_failures),
        }

    def status(self) -> dict:
        """Operator view for GET /status (federation section)."""
        return {
            "region": self.fmap.local,
            "regions": self.fmap.region_ids,
            "stale_lag_s": self.stale_lag_s,
            "partitioned": self.partitioned(),
            "peers": {
                r: {
                    "breaker": int(p.breaker.state),
                    "mirror_lag_s": round(
                        min(self.mirrors[r].lag_s(), 1e9), 3
                    ),
                    "mirror_synced": self.mirrors[r].synced,
                    "mirror_counts": self.mirrors[r].counts(),
                    "requests": p.requests,
                    "failures": p.failures,
                }
                for r, p in self.peers.items()
            },
        }


def empty_stats() -> dict:
    """The stable gauge key set for deployments with no federation
    attached (dashboards and alerts expect every series to exist)."""
    return {
        "dss_fed_partitioned": 0.0,
        "dss_fed_peer_state": {},
        "dss_fed_mirror_lag_s": {},
        "dss_fed_local_queries": 0.0,
        "dss_fed_remote_queries": 0.0,
        "dss_fed_stale_served": 0.0,
        "dss_fed_shed": 0.0,
        "dss_fed_writes_rejected": 0.0,
        "dss_fed_syncs": 0.0,
        "dss_fed_sync_failures": 0.0,
    }


# -- peer-facing serving (shared by the HTTP endpoints + in-process tests) ----


def _gen_of(store_index) -> int:
    clock = getattr(store_index, "cell_clock", None)
    return 0 if clock is None else clock.generation


def serve_query(router: FederationRouter, payload: dict) -> dict:
    """Answer a peer's federated query from the LOCAL stores (never
    recursing through the federation layer).  The answer is a
    bounded-stale follower read by construction: this instance serves
    its own region's state at its own tail-poll lag, and the response
    carries the freshness stamp (region id, epoch, per-class
    generation) the caller surfaces in X-DSS-Freshness."""
    rid, scd = router._local_rid, router._local_scd
    if rid is None or scd is None:
        raise errors.unavailable("federation serving not bound yet")
    cls = payload.get("cls")
    if cls not in _CLS_CODEC:
        raise errors.bad_request(f"unknown federation class {cls!r}")
    try:
        cells = np.asarray(payload["cells"], np.uint64)
        t0_ns = payload.get("t0_ns")
        t1_ns = payload.get("t1_ns")
        alt_lo = payload.get("alt_lo")
        alt_hi = payload.get("alt_hi")
        owner = payload.get("owner")
    except (KeyError, TypeError, ValueError, OverflowError) as e:
        # OverflowError: negative/oversized cell ids out of uint64
        # range — a caller bug that must answer 400, not a 5xx the
        # caller's transport would breaker-count as OUR sickness
        raise errors.bad_request(f"malformed federation query: {e}")
    # Liveness clock semantics: a live remote answer filters expiry by
    # the SERVING region's clock (its store's _now_ns — exactly what a
    # client of that region would see), while a mirror answer uses the
    # caller's now_ns; under cross-region wall-clock skew the two may
    # disagree about records expiring inside the skew window, which is
    # within the bounded-staleness contract (skew is part of the lag).
    # The payload's now_ns is therefore advisory here; ISA searches
    # pin liveness to t0_ns on both sides already.
    if cells.size == 0:
        raise errors.bad_request("missing cells")
    t0 = None if t0_ns is None else from_nanos(int(t0_ns))
    t1 = None if t1_ns is None else from_nanos(int(t1_ns))
    if cls == "isa":
        recs = rid.search_isas(cells, t0, t1, allow_stale=True)
        gen = _gen_of(rid._isa_index)
    elif cls == "rid_sub":
        if owner:
            recs = rid.search_subscriptions_by_owner(cells, owner)
        else:
            recs = rid.search_subscriptions(cells)
        gen = _gen_of(rid._sub_index)
    elif cls == "op":
        recs = scd.search_operations(
            cells, alt_lo, alt_hi, t0, t1, allow_stale=True
        )
        gen = _gen_of(scd._op_index)
    elif cls == "scd_sub":
        recs = scd.search_subscriptions(cells, owner or "")
        gen = _gen_of(scd._sub_index)
    else:  # constraint
        recs = scd.search_constraints(
            cells, alt_lo, alt_hi, t0, t1, allow_stale=True
        )
        gen = _gen_of(scd._cst_index)
    to_doc = _CLS_CODEC[cls][1]
    return {
        "docs": [to_doc(r) for r in recs],
        "freshness": {
            "region": router.fmap.local,
            "epoch": router._epoch_fn(),
            "gen": gen,
            # this instance reads its own region's state: its lag is
            # its own tail-poll interval, already inside any bound a
            # cross-region caller can declare
            "lag_s": 0.0,
        },
    }


def serve_sync(router: FederationRouter) -> dict:
    """Full-state follower-tail refresh for a peer's mirror.

    The cut is taken under the store lock (snapshot_refs' contract —
    the same discipline the region snapshot uploader follows): record
    references for BOTH sub-stores plus the generation stamps are
    grabbed in one critical section, so the mirror never adopts a
    torn cross-class state or a generation the shipped state does not
    actually contain.  Serialization (the expensive part) runs outside
    the lock — records are immutable, replaced never mutated."""
    rid, scd = router._local_rid, router._local_scd
    if rid is None or scd is None:
        raise errors.unavailable("federation serving not bound yet")
    with rid._lock:  # the ONE store lock both sub-stores share
        rid_refs = rid.snapshot_refs()
        scd_refs = scd.snapshot_refs()
        gens = {
            "isa": _gen_of(rid._isa_index),
            "rid_sub": _gen_of(rid._sub_index),
            "op": _gen_of(scd._op_index),
            "scd_sub": _gen_of(scd._sub_index),
            "constraint": _gen_of(scd._cst_index),
        }
        epoch = router._epoch_fn()
    wall_ns = 0
    if router._wall_clock is not None:
        wall_ns = to_nanos(router._wall_clock.now())
    return {
        "region": router.fmap.local,
        "epoch": epoch,
        "gens": gens,
        "time_ns": wall_ns,
        "state": {
            "rid": rid.serialize_refs(rid_refs),
            "scd": scd.serialize_refs(scd_refs),
        },
    }


# -- the store-facing wrappers ------------------------------------------------


def _federated_search(router: FederationRouter, cls: str, cells,
                      run_local, *, alt_lo=None, alt_hi=None,
                      t0_ns=None, t1_ns=None, now_ns=0,
                      allow_stale=False, owner=None) -> list:
    """THE routing core shared by both store wrappers: split the
    canonical covering by ownership, serve the local slice through
    the untouched local pipeline, fan remote slices out to peers,
    merge order-normalized.  A single-region covering short-circuits
    to the local store verbatim."""
    local_cells, remote = router.split(cells)
    if not remote:
        router.local_queries += 1
        note_serving(router.fmap.local, "local", cls=cls)
        return run_local(cells)
    # cross-region fan-out does blocking peer HTTP (seconds under a
    # partition): NEVER on the event loop.  Under the inline-read
    # host-only budget, escalate to the executor re-run — purely
    # local coverings (the common case) stay inline.
    from dss_tpu_torch.dar import budget as _budget

    if _budget.is_host_only():
        raise _budget.NeedsDevice(
            "federated covering needs remote peer I/O"
        )
    parts = []
    if local_cells.size:
        # the local slice is real local serving work — it counts in
        # the query-mix panel alongside the remote fan-out
        router.local_queries += 1
        note_serving(router.fmap.local, "local", cls=cls)
        parts.append(run_local(local_cells))
    for region_id, rcells in remote.items():
        parts.append(
            router.remote_search(
                cls, region_id, rcells, alt_lo, alt_hi,
                t0_ns, t1_ns, now_ns, allow_stale=allow_stale,
                owner=owner,
            )
        )
    return _merge_sorted(parts)


def _merge_sorted(parts: List[list]) -> list:
    """Order-normalized merge: records from every serving region,
    deduped by id (ownership is disjoint so collisions only happen on
    a map change mid-flight — newest map wins is arbitrary; keep the
    first), sorted by entity id.  Sorting makes the merged answer a
    deterministic function of the record SET, which is what makes a
    federated query comparable bit-for-bit against a single merged
    region regardless of which side served which slice."""
    seen = {}
    for part in parts:
        for r in part:
            if r.id not in seen:
                seen[r.id] = r
    return [seen[i] for i in sorted(seen)]


class FederatedRIDStore(RIDStore):
    """RIDStore in front of the local store: searches federate across
    the ownership map, cells-carrying writes are ownership-guarded,
    everything else (point reads, fan-out bumps, WAL replay, state
    management) delegates to the local implementation."""

    def __init__(self, local, router: FederationRouter):
        self._local = local
        self._router = router

    def __getattr__(self, name):
        # non-interface surface (indexes, snapshot/restore, apply_wal,
        # stats) — the DSSStore internals keep working on the wrapper
        if name in ("_local", "_router"):
            raise AttributeError(name)
        return getattr(self._local, name)

    def transaction(self):
        return self._local.transaction()

    # -- point reads / write-path internals: local -------------------------

    def get_isa(self, id):
        return self._local.get_isa(id)

    def get_subscription(self, id):
        return self._local.get_subscription(id)

    def max_subscription_count_in_cells_by_owner(self, cells, owner):
        return self._local.max_subscription_count_in_cells_by_owner(
            cells, owner
        )

    def update_notification_idxs_in_cells(self, cells, *, entity=None,
                                          removed=False):
        return self._local.update_notification_idxs_in_cells(
            cells, entity=entity, removed=removed
        )

    # -- guarded writes ----------------------------------------------------

    def insert_isa(self, isa):
        self._router.check_write(isa.cells)
        return self._local.insert_isa(isa)

    def delete_isa(self, isa):
        return self._local.delete_isa(isa)

    def insert_subscription(self, sub):
        self._router.check_write(sub.cells)
        return self._local.insert_subscription(sub)

    def delete_subscription(self, sub):
        return self._local.delete_subscription(sub)

    # -- federated searches ------------------------------------------------

    def _federate(self, *args, **kw):
        return _federated_search(self._router, *args, **kw)

    def search_isas(self, cells, earliest, latest, *, allow_stale=False):
        cells = canonical_cells(cells)
        e_ns = None if earliest is None else to_nanos(earliest)
        l_ns = None if latest is None else to_nanos(latest)
        return self._federate(
            "isa", cells,
            lambda c: self._local.search_isas(
                c, earliest, latest, allow_stale=allow_stale
            ),
            t0_ns=e_ns, t1_ns=l_ns, now_ns=e_ns or 0,
            allow_stale=allow_stale,
        )

    def search_subscriptions(self, cells):
        cells = canonical_cells(cells)
        now_ns = to_nanos(self._local._clock.now())
        return self._federate(
            "rid_sub", cells,
            lambda c: self._local.search_subscriptions(c),
            now_ns=now_ns,
        )

    def search_subscriptions_by_owner(self, cells, owner):
        cells = canonical_cells(cells)
        now_ns = to_nanos(self._local._clock.now())
        return self._federate(
            "rid_sub", cells,
            lambda c: self._local.search_subscriptions_by_owner(
                c, owner
            ),
            now_ns=now_ns, owner=owner,
        )


class FederatedSCDStore(SCDStore):
    """SCDStore counterpart of FederatedRIDStore."""

    def __init__(self, local, router: FederationRouter):
        self._local = local
        self._router = router

    def __getattr__(self, name):
        if name in ("_local", "_router"):
            raise AttributeError(name)
        return getattr(self._local, name)

    def transaction(self):
        return self._local.transaction()

    # -- point reads: local ------------------------------------------------

    def get_operation(self, id):
        return self._local.get_operation(id)

    def get_constraint(self, id):
        return self._local.get_constraint(id)

    def get_subscription(self, id, owner):
        return self._local.get_subscription(id, owner)

    # -- guarded writes ----------------------------------------------------

    def validate_operation_upsert(self, op, key):
        # the guard runs BEFORE the (journal-free) precheck so a
        # misrouted write aborts with nothing to roll back
        self._router.check_write(op.cells)
        return self._local.validate_operation_upsert(op, key)

    def upsert_operation(self, op, key, *, key_checked=False):
        self._router.check_write(op.cells)
        return self._local.upsert_operation(
            op, key, key_checked=key_checked
        )

    def delete_operation(self, id, owner):
        return self._local.delete_operation(id, owner)

    def upsert_constraint(self, cst):
        self._router.check_write(cst.cells)
        return self._local.upsert_constraint(cst)

    def delete_constraint(self, id, owner):
        return self._local.delete_constraint(id, owner)

    def upsert_subscription(self, sub):
        self._router.check_write(sub.cells)
        return self._local.upsert_subscription(sub)

    def delete_subscription(self, id, owner, version):
        return self._local.delete_subscription(id, owner, version)

    # -- federated searches ------------------------------------------------

    def _federate(self, *args, **kw):
        return _federated_search(self._router, *args, **kw)

    def search_operations(self, cells, alt_lo, alt_hi, earliest, latest,
                          *, allow_stale=False):
        cells = canonical_cells(cells)
        t0_ns = None if earliest is None else to_nanos(earliest)
        t1_ns = None if latest is None else to_nanos(latest)
        now_ns = to_nanos(self._local._clock.now())
        return self._federate(
            "op", cells,
            lambda c: self._local.search_operations(
                c, alt_lo, alt_hi, earliest, latest,
                allow_stale=allow_stale,
            ),
            alt_lo=alt_lo, alt_hi=alt_hi, t0_ns=t0_ns, t1_ns=t1_ns,
            now_ns=now_ns, allow_stale=allow_stale,
        )

    def search_constraints(self, cells, alt_lo, alt_hi, earliest, latest,
                           *, allow_stale=False):
        cells = canonical_cells(cells)
        t0_ns = None if earliest is None else to_nanos(earliest)
        t1_ns = None if latest is None else to_nanos(latest)
        now_ns = to_nanos(self._local._clock.now())
        return self._federate(
            "constraint", cells,
            lambda c: self._local.search_constraints(
                c, alt_lo, alt_hi, earliest, latest,
                allow_stale=allow_stale,
            ),
            alt_lo=alt_lo, alt_hi=alt_hi, t0_ns=t0_ns, t1_ns=t1_ns,
            now_ns=now_ns, allow_stale=allow_stale,
        )

    def search_subscriptions(self, cells, owner):
        cells = canonical_cells(cells)
        now_ns = to_nanos(self._local._clock.now())
        return self._federate(
            "scd_sub", cells,
            lambda c: self._local.search_subscriptions(c, owner),
            now_ns=now_ns, owner=owner,
        )

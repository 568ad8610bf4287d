"""Worker-side stores of the shared-memory serving front.

A read worker over a plain WAL-tail replica answers searches by
re-scanning that replica: bounded-stale, uncached, and paying the full
index scan per poll.  These wrappers (a copy of the reference's
`dss_tpu/dar/shmfront.py`) replace that hot path with the read-cache
discipline replicated per worker:

  1. worker-local version-fenced ReadCache (dar/readcache.py — the
     EXACT same class), fenced on the owner's broadcast segment
     (shmring.WorkerFenceView) instead of an in-process CellClock.
     Fence-read-before-populate: the fence is read BEFORE the request
     is enqueued, so a write landing during the ring round trip can
     only make the entry look too old — never fresher than its data.
     Repeat polls are answered locally in microseconds with NO TTL and
     never across a stale fence.
  2. miss -> one shared-memory ring round trip to the device owner
     (zero marshal: raw covering run in, (id, t_end) pairs out).  The
     response's WAL sequence bounds a replica-catchup wait before
     record assembly, so the records the worker serializes are exactly
     the docs the leader would have served (read-your-writes across
     the front included).
  3. ring full / owner dead / injected `shm.ring.enqueue` fault ->
     ShmFallback, which the worker's proxy middleware (api/app.py)
     turns into the pre-existing loopback-HTTP proxy to the leader —
     never a block, never a 5xx.

Record assembly happens HERE, from the worker's replica dicts, in the
exact per-class order the leader-side store methods use — so a
worker-served response is bit-identical to a leader-served one at the
same state (tests/test_torch_shmring.py pins this across folds,
compactions and tombstones, against the reference's front too).

Subscription classes (rid_sub / scd_sub) deliberately skip the
worker-local cache: their records carry notification indexes that
writes bump WITHOUT touching the cell clock (by design — see
readcache.py), so only the ring path's wal-seq catchup keeps a
worker-served sub response as fresh as the leader's.  SCD dependent
operations resolve through the worker's own cached op path, one id
list per sub, exactly as the leader's nested `_search_ops` does.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional

import numpy as np

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.clock import to_nanos
from dss_tpu_torch.dar import budget as _budget
from dss_tpu_torch.dar import readcache as rcache
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.geo.covering import canonical_cells
from dss_tpu_torch.obs import stages as _stages
from dss_tpu_torch.obs import trace as _trace
from dss_tpu_torch.parallel import shmring
from dss_tpu_torch.plan import shmroute

__all__ = [
    "ShmFallback",
    "ShmSearchFront",
    "ShmRIDStore",
    "ShmSCDStore",
]


class ShmFallback(Exception):
    """Serve this search over the loopback proxy instead (ring full,
    owner unreachable, oversized payload, or an injected enqueue
    fault).  The worker proxy middleware catches it; it must never
    surface as a 5xx."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class ShmSearchFront:
    """Shared machinery of the worker-side wrappers: worker-local
    fenced cache, the ring client, the route decision, and the
    replica-catchup wait."""

    def __init__(self, region: shmring.ShmRegion,
                 client: shmring.ShmWorkerClient, follower, clock, *,
                 cache: Optional[rcache.ReadCache] = None,
                 costs: Optional[shmroute.WorkerCostModel] = None,
                 catchup_s: float = 1.0, owner_ttl_s: float = 5.0,
                 owner_threads: int = 2):
        self.region = region
        self.client = client
        self.follower = follower
        self.clock = clock
        self.fence_view = shmring.WorkerFenceView(region)
        self.cache = cache if cache is not None else rcache.ReadCache(
            **rcache.env_knobs()
        )
        self.costs = costs if costs is not None else (
            shmroute.WorkerCostModel()
        )
        self.catchup_s = float(catchup_s)
        self.owner_ttl_s = float(owner_ttl_s)
        self.owner_threads = int(owner_threads)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        out = {f"shm_cache_{k}": v for k, v in self.cache.stats().items()}
        out.update(self.costs.stats())
        for k, v in self.client.stats().items():
            out[f"shm_{k}"] = v
        # whole-front dss_shm_* families straight from the shared
        # region: the owner serves no public port, so any worker's
        # scrape must present one coherent view of the entire front
        out.update(shmring.front_stats(self.region))
        return out

    def now_ns(self) -> int:
        return to_nanos(self.clock.now())

    # -- the serve path ------------------------------------------------------

    def _headroom_ms(self) -> Optional[float]:
        from dss_tpu_torch.dar import deadline as _deadline

        dl = _deadline.get_route_deadline()
        if dl is None:
            return None
        return max(0.0, (dl - time.monotonic()) * 1000.0)

    def serve(self, cls: str, cells: np.ndarray, *, qkey: tuple,
              now_ns: int, alt_lo=None, alt_hi=None, t0_ns=None,
              t1_ns=None, owner: str = None, allow_stale: bool = False,
              cacheable: bool = True) -> List[str]:
        """-> the authoritative id list for this search (cache hit or
        ring round trip).  Raises ShmFallback for the proxy path and
        StatusError for admission/deadline verdicts — the same errors
        the leader-side path raises."""
        client = self.client
        dar_keys = s2cell.cell_to_dar_key(cells)
        fence = epoch = key = None
        th = _trace.current()
        use_cache = cacheable and self.cache.enabled
        if use_cache:
            if th is not None:
                t_cl_w, t_cl0 = time.time_ns(), time.perf_counter()
            # fence-read-BEFORE-enqueue: a write landing between this
            # read and the owner's query can only age the entry
            fence = self.fence_view.fence(cls, dar_keys)
            epoch = self.fence_view.epoch()
            key = (cls, owner, qkey, cells.tobytes())
            ids = self.cache.lookup(
                cls, key, fence, epoch, int(now_ns), allow_stale
            )
            if th is not None:
                _trace.add_span(
                    th, "cache.lookup", t_cl_w,
                    (time.perf_counter() - t_cl0) * 1000,
                    attrs={"cls": cls, "hit": ids is not None,
                           "proc": "worker"},
                )
            if ids is not None:
                client.stat_add(shmring.WS_CACHE_HITS)
                rcache.note_search(cls, epoch, fence[2], True)
                return ids

        # Optimistic inline reads (api/app._call_read): a worker cache
        # hit is host-bounded microseconds and safe on the event loop,
        # but everything past this point blocks — the ring round trip
        # and the replica-catchup wait.  Escalate to the executor the
        # same way a leader-side read escalates off a device dispatch.
        if _budget.is_host_only():
            raise _budget.NeedsDevice("shm ring round trip")
        if use_cache:
            client.stat_add(shmring.WS_CACHE_MISSES)

        headroom = self._headroom_ms()
        state = self.costs.state(
            ring_in_flight=client.in_flight(),
            ring_depth=self.region.depth,
            owner_threads=self.owner_threads,
            owner_alive=(
                self.region.owner_heartbeat_age_s() < self.owner_ttl_s
            ),
        )
        plan = shmroute.decide_worker(state, headroom)
        if plan.route != "shm":
            client.stat_add(shmring.WS_PLAN_PROXY)
            client.stat_add(shmring.WS_PROXY_FALLBACKS)
            raise ShmFallback(plan.reason)
        client.stat_add(shmring.WS_PLAN_SHM)

        t0 = time.perf_counter()
        t0_w = time.time_ns() if th is not None else 0
        try:
            resp = client.call(
                cls=cls, cells=cells, alt_lo=alt_lo, alt_hi=alt_hi,
                t0_ns=t0_ns, t1_ns=t1_ns, now_ns=now_ns, owner=owner,
                allow_stale=allow_stale,
                deadline_s=None if headroom is None
                else headroom / 1000.0,
                # the trace id + record bit ride the slot's reserved
                # words; the owner then returns its span slots
                # (stitched below).  The bit is set whenever THIS
                # request is recording — head-sampled OR armed for
                # DSS_TRACE_SLOW_MS tail capture, where the keep
                # decision is retroactive and the owner cannot know in
                # advance whether its timings will be needed
                trace_id=None if th is None else th.ctx.trace_id,
                trace_sampled=th is not None,
            )
        except (shmring.RingFull, shmring.RingOversize,
                shmring.RingTimeout, chaos.FaultError) as e:
            client.stat_add(shmring.WS_PROXY_FALLBACKS)
            raise ShmFallback(type(e).__name__)
        if resp.status == shmring.ST_OVERLOADED:
            # the owner's admission verdict rides the slot: same 429 +
            # Retry-After the leader would have returned in-process
            raise errors.OverloadedError(
                "serving queue at capacity (shm front)",
                retry_after_s=resp.retry_after_s or 1.0,
            )
        if resp.status == shmring.ST_DEADLINE:
            raise errors.deadline_exceeded(
                "request deadline expired in the shm ring"
            )
        if resp.status != shmring.ST_OK:
            client.stat_add(shmring.WS_PROXY_FALLBACKS)
            raise ShmFallback(f"status-{resp.status}")
        rtt_ms = (time.perf_counter() - t0) * 1000.0
        self.costs.observe_shm(rtt_ms)
        _stages.mark("shm_ring_ms", rtt_ms, span=False)
        if th is not None:
            # ONE stitched trace across the process boundary: the ring
            # round trip is a span, and the owner's span-slot
            # durations (obs/trace.OWNER_SLOTS, carried back in the
            # response's reserved words) become its children
            ring_sid = _trace.add_span(
                th, "shm.ring", t0_w, rtt_ms,
                attrs={"cls": cls, "worker": client.worker},
            )
            if resp.trace_ns and ring_sid is not None:
                off_ns = t0_w
                for idx, ns in enumerate(resp.trace_ns):
                    if ns <= 0:
                        continue
                    _trace.add_span(
                        th, _trace.OWNER_SLOTS[idx], off_ns,
                        ns / 1e6, parent=ring_sid,
                        attrs={"proc": "owner"},
                    )
        client.stat_add(shmring.WS_SERVED)
        if resp.wal_seq:
            # replica catchup: assemble records at least as new as the
            # answer (bounded — a timeout proceeds with the replica's
            # bounded staleness, same contract as the write proxy)
            t_cu_w, t_cu0 = time.time_ns(), time.perf_counter()
            self.follower.wait_for(int(resp.wal_seq), self.catchup_s)
            cu_ms = (time.perf_counter() - t_cu0) * 1000.0
            _stages.mark("catchup_ms", cu_ms, span=False)
            if th is not None:
                _trace.add_span(th, "replica.catchup", t_cu_w, cu_ms)
        if use_cache and not resp.mesh_served:
            # a bounded-stale mesh answer must not be stamped fresh
            # behind the fence (the fence cannot see the replica's
            # lag) — the leader's _cached_ids refuses it for its own
            # cache, and the flag carries that refusal across the ring
            try:
                chaos.fault_point("cache.populate", detail=f"shm:{cls}")
                self.cache.insert(
                    cls, key, fence, epoch, int(now_ns),
                    resp.ids, resp.t1s,
                )
            except chaos.FaultError:
                pass
        rcache.note_search(cls, epoch or self.fence_view.epoch(),
                           resp.gen, False)
        return resp.ids

    def assemble(self, ids: List[str], recs: dict) -> list:
        """Order-preserving record assembly from the worker replica's
        dict — the same shallow-copy discipline as the leader's
        search assembly.  A missing record (replica catchup timed out
        mid-burst) is skipped and counted, exactly like the leader's
        vanished-mid-assembly case."""
        out = []
        for i in ids:
            rec = recs.get(i)
            if rec is None:
                self.client.stat_add(shmring.WS_ASSEMBLY_MISSES)
                continue
            out.append(copy.copy(rec))
        return out


class _Wrapper:
    """Delegating base: everything not overridden reaches the inner
    replica store (stats, index introspection, freshness plumbing)."""

    def __init__(self, inner, front: ShmSearchFront):
        self._inner = inner
        self._front = front

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ShmRIDStore(_Wrapper):
    """RID search surface over the ring; every other method delegates
    to the WAL-tail replica store."""

    def search_isas(self, cells, earliest, latest, *, allow_stale=False):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        if earliest is None:
            raise errors.internal("must call with an earliest start time.")
        cells = canonical_cells(cells)
        e_ns = to_nanos(earliest)
        l_ns = None if latest is None else to_nanos(latest)
        # qkey mirrors the leader's _cached_ids discipline: `earliest`
        # is the query's `now` (clamped by the service) and only
        # drives the t_end >= now filter the cache re-applies at
        # lookup — keying it would make every repeat poll a unique,
        # never-hit line
        ids = self._front.serve(
            "isa", cells, qkey=(l_ns,), now_ns=e_ns,
            t0_ns=e_ns, t1_ns=l_ns, allow_stale=allow_stale,
            cacheable=True,
        )
        return self._front.assemble(ids, self._inner._isas)

    def search_subscriptions_by_owner(self, cells, owner):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("no location provided")
        cells = canonical_cells(cells)
        now = self._front.now_ns()
        ids = self._front.serve(
            "rid_sub", cells, qkey=(), now_ns=now, owner=owner,
            cacheable=False,  # notification indexes: see module doc
        )
        return self._front.assemble(ids, self._inner._subs)


class ShmSCDStore(_Wrapper):
    """SCD search surface over the ring; every other method delegates
    to the WAL-tail replica store."""

    @staticmethod
    def _op_qkey(alt_lo, alt_hi, t0_ns, t1_ns) -> tuple:
        # the leader-side _search_ops qkey, bit for bit, so worker
        # cache keys partition the same way the owner's do
        return (
            None if alt_lo is None else float(alt_lo),
            None if alt_hi is None else float(alt_hi),
            t0_ns, t1_ns,
        )

    def search_operations(self, cells, alt_lo, alt_hi, earliest,
                          latest, *, allow_stale=False):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        return self._search_ops_ids_to_recs(
            canonical_cells(cells), alt_lo, alt_hi,
            None if earliest is None else to_nanos(earliest),
            None if latest is None else to_nanos(latest),
            self._front.now_ns(), allow_stale,
        )

    def _search_ops_ids_to_recs(self, cells, alt_lo, alt_hi, t0_ns,
                                t1_ns, now_ns, allow_stale):
        ids = self._front.serve(
            "op", cells,
            qkey=self._op_qkey(alt_lo, alt_hi, t0_ns, t1_ns),
            now_ns=now_ns, alt_lo=alt_lo, alt_hi=alt_hi,
            t0_ns=t0_ns, t1_ns=t1_ns, allow_stale=allow_stale,
            cacheable=True,
        )
        return self._front.assemble(ids, self._inner._ops)

    def search_constraints(self, cells, alt_lo, alt_hi, earliest,
                           latest, *, allow_stale=False):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("missing cell IDs for query")
        cells = canonical_cells(cells)
        t0_ns = None if earliest is None else to_nanos(earliest)
        t1_ns = None if latest is None else to_nanos(latest)
        ids = self._front.serve(
            "constraint", cells,
            qkey=self._op_qkey(alt_lo, alt_hi, t0_ns, t1_ns),
            now_ns=self._front.now_ns(), alt_lo=alt_lo, alt_hi=alt_hi,
            t0_ns=t0_ns, t1_ns=t1_ns, allow_stale=allow_stale,
            cacheable=True,
        )
        return self._front.assemble(ids, self._inner._csts)

    def search_subscriptions(self, cells, owner):
        if len(np.asarray(cells).ravel()) == 0:
            raise errors.bad_request("no location provided")
        cells = canonical_cells(cells)
        now = self._front.now_ns()
        ids = self._front.serve(
            "scd_sub", cells, qkey=(), now_ns=now, owner=owner,
            cacheable=False,  # notification indexes: see module doc
        )
        subs = self._front.assemble(ids, self._inner._subs)
        for s in subs:
            s.dependent_operations = self._dependent_op_ids(s, now)
        return subs

    def _dependent_op_ids(self, sub, now_ns: int) -> List[str]:
        """The leader's `_dependent_ops`, routed through the worker's
        own cached op path: one id list per sub, each inner search a
        cache hit after the first resolution."""
        if len(np.asarray(sub.cells).ravel()) == 0:
            return []
        cells = canonical_cells(sub.cells)
        t0_ns = to_nanos(sub.start_time)
        t1_ns = to_nanos(sub.end_time)
        return self._front.serve(
            "op", cells,
            qkey=self._op_qkey(sub.altitude_lo, sub.altitude_hi,
                               t0_ns, t1_ns),
            now_ns=now_ns, alt_lo=sub.altitude_lo,
            alt_hi=sub.altitude_hi, t0_ns=t0_ns, t1_ns=t1_ns,
            cacheable=True,
        )

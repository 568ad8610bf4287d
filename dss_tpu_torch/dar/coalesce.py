"""Pipelined micro-batching query coalescer for DarTable.

The port of the reference's `dss_tpu/dar/coalesce.py`, equal to it in
answers, routes and counters (tests/test_torch_coalesce.py).  The
serving-stack glue between request-per-thread handlers and the batched
fused kernel: concurrent callers enqueue single queries; the coalescer
drains whatever is queued and runs it as ONE DarTable.query_many
batch.  Continuous batching — no timing window:

  - a lone caller runs immediately as a batch of 1 (no added latency),
  - while a batch is in flight, new arrivals queue up and form the
    next batch, so concurrency N collapses to ~1 kernel per round trip
    instead of N round trips.

  PIPELINE — the worker is split into a *pack* stage (host: key sort,
  searchsorted, window packing, async device submit via
  DarTable.query_many_submit) and a *collect* stage (device wait + D2H
  decode + overlay merge via DarTable.query_many_collect), each on its
  own thread with a bounded double-buffer queue between them, so a
  batch executes on the device while the next one is being packed.

  ADAPTIVE BATCHING — the drain size is a controller output, not a
  constant: observed per-batch latency above `target_batch_ms` halves
  the next drain, a saturated fast batch doubles it (AIMD-shaped,
  bounded [min_batch, max_batch]).

  BACKPRESSURE — the queue is bounded (queue_depth x max_batch).  A
  full queue blocks admission briefly (admission_wait_s) and then
  sheds the request with a typed errors.OverloadedError carrying a
  queue-drain Retry-After estimate from the live drain-rate EWMA (HTTP
  429).  Overload therefore degrades to bounded latency for admitted
  requests + explicit rejections, not an unbounded backlog.

  DEADLINE-AWARE ROUTING — every item carries an absolute deadline
  (admission time + the DSS_CO_SLO_MS serving SLO, capped by the route
  deadline dar/deadline.py propagates).  The planner's online EWMA
  cost models (device dispatch floor, per-item device batch cost,
  per-chunk host-scan cost — seeded at boot, updated from every
  completed batch, exported as co_est_* gauges) route each drained
  batch by PREDICTED cost against the tightest queued headroom: when
  the fused device path would blow that headroom, the batch is served
  as chunked exact host scans (FastTable.query_host_chunked).  The
  drain size itself is deadline-capped, and items whose deadline
  already expired in queue are fast-shed with a typed
  DEADLINE_EXCEEDED error (HTTP 504) instead of occupying a kernel
  slot.

  RESIDENT ROUTE — when the resident loop (ops/resident.py) is
  attached, the device class splits in two: the cold fused dispatch
  (one eager B1 launch per pack-stage submit) and the resident loop's
  stream (captured CUDA graphs per shape bucket, static buffers, a
  feeder that keeps several batches in flight).  The router treats
  resident as a third candidate with ITS OWN cost-model key
  (est_res_floor_ms, seeded by DSS_CO_EST_RES_FLOOR_MS) fed only by
  resident observations.  A full resident ring falls back to the cold
  path; the pack stage never blocks on the device stream.

  PLANNED ROUTING — every route decision here is a Plan produced by
  one Planner (dss_tpu_torch/plan) that owns ALL cost models: the pack
  stage, the inline lone-caller path, the drain cap, and the
  Retry-After estimate consume plans, so the drain sizing and the
  route choice can never disagree, and a decision is a pure function
  of (batch shape, model state, clock).

  DEVICE LOSS — only an injected chaos.DeviceLostError counts as a
  device loss (chaos.is_device_loss): that batch is re-served on the
  host route.  A real CUDA error from a kernel wrapper is delivered to
  the batch's callers, never absorbed.

The mesh delegate (set_mesh_delegate) and the read-cache view
(set_cache_view) are hooks with nothing attached until the mesh and
read-cache slices land.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import List, Optional

import numpy as np

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.dar import budget
from dss_tpu_torch.dar import deadline as _deadline
from dss_tpu_torch.obs import stages as _stages
from dss_tpu_torch.obs import trace as _trace
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu_torch.ops.fastpath import FastTable
from dss_tpu_torch.plan import (
    HEADROOM_SAFETY as _PLAN_HEADROOM_SAFETY,
)
from dss_tpu_torch.plan import (
    BatchShape,
    CostModel,
    Planner,
    plan_drain_cap,
)
from dss_tpu_torch.plan.planner import state_of as _plan_state_of


class _Item:
    __slots__ = ("keys", "alt_lo", "alt_hi", "t_start", "t_end", "now",
                 "owner_id", "allow_stale", "deadline", "event", "result",
                 "error", "via_mesh", "tctx", "tspans", "enq_ns")

    def __init__(self, keys, alt_lo, alt_hi, t_start, t_end, now, owner_id,
                 allow_stale=False, deadline=None):
        self.keys = keys
        self.alt_lo = -np.inf if alt_lo is None else float(alt_lo)
        self.alt_hi = np.inf if alt_hi is None else float(alt_hi)
        self.t_start = NO_TIME_LO if t_start is None else int(t_start)
        self.t_end = NO_TIME_HI if t_end is None else int(t_end)
        self.now = int(now)
        self.owner_id = -1 if owner_id is None else int(owner_id)
        self.allow_stale = bool(allow_stale)
        # absolute monotonic instant by which this query must complete
        # (None = no deadline); set at admission from the SLO + the
        # propagated route deadline, consumed by the batch router
        self.deadline: Optional[float] = deadline
        self.event = threading.Event()
        self.result: Optional[List[str]] = None
        self.error: Optional[BaseException] = None
        # answered by the sharded mesh replica (bounded-stale): the
        # read cache must not stamp this result as fresh
        self.via_mesh = False
        # cross-thread span handoff (obs/trace.py): the caller's trace
        # handle captured at admission; the pipeline threads STAMP
        # measured (name, start_ns, dur_ms, attrs) tuples here and the
        # caller's own thread records them after the event resolves —
        # queue-wait, plan, dispatch, collect become parented spans
        # without the pipeline ever touching the recorder.  All None/0
        # when tracing is off: one branch per item.
        self.tctx = None
        self.tspans = None
        self.enq_ns = 0

    def expired(self, now_monotonic: float) -> bool:
        return self.deadline is not None and self.deadline <= now_monotonic


# The cost model lives in dss_tpu_torch/plan/costs.py (the planner
# owns it); the name is re-exported here as the reference does.
_CostModel = CostModel


class _BatchController:
    """AIMD-shaped drain-size controller.

    Tracks one number: the next batch's max drain size (`cur`).  A
    batch whose end-to-end pipeline time (pack + device + collect)
    exceeds `target_ms` halves it — long batches are what push queue
    wait (and thus p50) past the latency budget.  A SATURATED batch
    (drained the full `cur` — demand exceeds the batch size) finishing
    under target_ms / 2 doubles it — there is headroom to amortize the
    dispatch round trip over more queries.  Unsaturated batches leave
    `cur` alone: demand, not the controller, is the binding constraint.
    """

    __slots__ = ("min_batch", "max_batch", "target_ms", "cur",
                 "grows", "shrinks")

    def __init__(self, min_batch: int = 64, max_batch: int = 4096,
                 target_ms: float = 25.0, start: Optional[int] = None):
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.target_ms = float(target_ms)
        cur = 8 * self.min_batch if start is None else int(start)
        self.cur = max(self.min_batch, min(self.max_batch, cur))
        self.grows = 0
        self.shrinks = 0

    def observe(self, n_items: int, total_ms: float) -> None:
        if total_ms > self.target_ms and self.cur > self.min_batch:
            self.cur = max(self.min_batch, self.cur // 2)
            self.shrinks += 1
        elif (
            n_items >= self.cur
            and total_ms < self.target_ms / 2
            and self.cur < self.max_batch
        ):
            self.cur = min(self.max_batch, self.cur * 2)
            self.grows += 1

    def drain_cap(
        self, headroom_ms: Optional[float], cost: _CostModel,
        inflight: int, inflight_host_chunks: int = 0,
        resident_ready: bool = False, inflight_resident: int = 0,
    ) -> int:
        """Deadline-aware drain bound — the logic lives in
        plan.plan_drain_cap (one HEADROOM_SAFETY budget shared with
        the route choice, so the drain sizing and the plan can never
        disagree); this shim keeps the controller's historical call
        shape for callers that hold a bare cost model (the coalescer
        itself goes through its planner in _drain_locked)."""
        state = _plan_state_of(
            cost,
            inflight_device=int(inflight),
            inflight_host_chunks=int(inflight_host_chunks),
            inflight_resident=int(inflight_resident),
            resident_ready=bool(resident_ready),
        )
        return plan_drain_cap(self.cur, headroom_ms, state)


def _env_bool(v: str) -> bool:
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(s)


def env_knobs() -> dict:
    """QueryCoalescer constructor kwargs from DSS_CO_* environment
    variables (the deployment-level serving config; docs/SERVING.md).
    Unset variables are omitted so the constructor defaults hold."""
    out = {}
    for env, key, conv in (
        ("DSS_CO_MIN_BATCH", "min_batch", int),
        ("DSS_CO_MAX_BATCH", "max_batch", int),
        ("DSS_CO_TARGET_BATCH_MS", "target_batch_ms", float),
        ("DSS_CO_QUEUE_DEPTH", "queue_depth", int),
        ("DSS_CO_ADMISSION_WAIT_S", "admission_wait_s", float),
        ("DSS_CO_PIPELINE_DEPTH", "pipeline_depth", int),
        ("DSS_CO_INLINE", "inline", _env_bool),
        # deadline-aware routing: the per-query serving SLO (0 disables
        # SLO-derived deadlines; route deadlines still apply) and the
        # boot seeds of the EWMA cost models
        ("DSS_CO_SLO_MS", "slo_ms", float),
        ("DSS_CO_EST_FLOOR_MS", "est_floor_ms", float),
        ("DSS_CO_EST_ITEM_MS", "est_item_ms", float),
        ("DSS_CO_EST_CHUNK_MS", "est_chunk_ms", float),
        # resident serving kernel (ops/resident.py): enable the
        # persistent device-feeder loop, seed ITS OWN floor estimate
        # (never shared with the cold-device floor), and size the
        # host ring / device stream depth
        ("DSS_CO_RESIDENT", "resident", _env_bool),
        ("DSS_CO_EST_RES_FLOOR_MS", "est_res_floor_ms", float),
        ("DSS_CO_EST_RES_LAT_MS", "est_res_lat_ms", float),
        ("DSS_CO_RES_RING", "res_ring", int),
        ("DSS_CO_RES_INFLIGHT", "res_inflight", int),
    ):
        raw = os.environ.get(env)
        if raw is not None:
            try:
                out[key] = conv(raw)
            except ValueError:
                raise ValueError(f"{env}={raw!r} is not a valid {key}")
    return out


# inflight-queue sentinel: tells the collect stage to exit
_DONE = object()

# fraction of a batch's tightest headroom the planner budgets for the
# serving route itself (the rest covers decode + caller wake) — the
# value lives in dss_tpu_torch/plan/planner.py, shared by the route
# choice and plan_drain_cap so they can never disagree.
_HEADROOM_SAFETY = _PLAN_HEADROOM_SAFETY


class QueryCoalescer:
    """Pipelined two-stage coalescer: pack thread + collect thread per
    DarTable, bounded admission, adaptive drain size."""

    def __init__(
        self,
        table,
        *,
        min_batch: int = 64,
        max_batch: int = 4096,
        target_batch_ms: float = 25.0,
        queue_depth: int = 4,
        admission_wait_s: float = 0.25,
        pipeline_depth: int = 2,
        inline: bool = True,
        slo_ms: float = 0.0,  # 0 = no SLO-derived deadlines: items
        #   carry only the propagated route deadline.  Deployments
        #   chasing a joint qps+latency target set DSS_CO_SLO_MS (the
        #   serving recipe runs with 50 ms) — the router only ever forces
        #   the host route under REAL deadline pressure, so the
        #   conservative default cannot regress bulk throughput.
        est_floor_ms: float = 20.0,
        est_item_ms: float = 0.02,
        est_chunk_ms: float = 0.3,
        resident: bool = False,  # enable the resident loop
        #   (ops/resident.py): a persistent device-feeder stream with
        #   captured CUDA graphs per shape bucket becomes a third route
        #   candidate with its own cost-model key.  Default off so
        #   host-only callers and tests keep the two-route behavior
        #   unless they ask (DSS_CO_RESIDENT=1).
        est_res_floor_ms: Optional[float] = None,  # resident floor
        #   seed (DSS_CO_EST_RES_FLOOR_MS); None = est_floor_ms / 4
        est_res_lat_ms: Optional[float] = None,  # resident stream
        #   full-latency seed (DSS_CO_EST_RES_LAT_MS); None =
        #   est_floor_ms — one round trip, the honest prior
        res_ring: int = 32,  # resident host ring capacity (batches)
        res_inflight: int = 4,  # resident device stream depth
        clock=time.monotonic,  # injectable for fake-clock routing tests
    ):
        self._table = table
        self._cond = threading.Condition()
        self._queue: List[_Item] = []
        self._closed = False
        self._busy = False  # an inline batch is executing on a caller
        self._packing = False  # the pack stage is mid-drain
        self._inflight = 0  # packed batches not yet collected
        self._inflight_items = 0  # queries inside those batches
        self._inflight_device = 0  # of those batches: on the device
        self._inflight_host_chunks = 0  # forced-host chunks queued at
        #                                 the collect thread
        self._ctl = _BatchController(
            min_batch=min_batch, max_batch=max_batch,
            target_ms=target_batch_ms,
        )
        self._queue_depth = int(queue_depth)
        self._max_queue = self._queue_depth * self._ctl.max_batch
        self._admission_wait_s = float(admission_wait_s)
        self._inline = bool(inline)
        self._clock = clock
        # per-query serving SLO: each admitted item must complete
        # within slo_ms (capped by the propagated route deadline);
        # 0 disables SLO-derived deadlines
        self._slo_ms = float(slo_ms)
        # the host-chunk bucket mirrors the warmed host-path width
        # every table serves chunks at (FastTable.HOST_MAX_BATCH)
        chunk = FastTable.HOST_MAX_BATCH
        # the planner owns ALL cost models (dss_tpu_torch/plan): every route
        # decision, the drain sizing, and the Retry-After throughput
        # read the same estimates through it.  self._cost stays as the
        # live CostModel alias — observation call sites and the
        # routing tests address it directly.
        self._planner = Planner(
            floor_ms=est_floor_ms, item_ms=est_item_ms,
            chunk_ms=est_chunk_ms, chunk=chunk,
            res_floor_ms=est_res_floor_ms, res_lat_ms=est_res_lat_ms,
        )
        self._cost = self._planner.cost
        # resident loop (created on demand — needs a table with the
        # submit/collect split)
        self._res_loop = None
        self._res_ring = int(res_ring)
        self._res_inflight = int(res_inflight)
        self._inflight_resident = 0  # batches queued at the res loop
        if resident:
            self._make_resident_loop()
        self._inflight_q: _queue.Queue = _queue.Queue(
            maxsize=max(1, int(pipeline_depth))
        )
        self._pack_thread: Optional[threading.Thread] = None
        self._collect_thread: Optional[threading.Thread] = None
        # stage-time + shed accounting (stats() -> /metrics gauges)
        self._slock = threading.Lock()
        self._stat_batches = 0
        self._stat_items = 0
        self._stat_inline = 0
        self._stat_shed = 0
        self._stat_deadline_shed = 0
        self._stat_route_host = 0  # batches fully served on the host
        self._stat_route_hostchunk = 0  # of those: forced chunked route
        self._stat_route_device = 0  # batches that touched the device
        self._stat_route_resident = 0  # batches via the resident loop
        self._stat_device_loss_absorbed = 0  # device-loss batches
        #   re-served on the host instead of erroring callers
        self._stat_pack_ms = 0.0
        self._stat_device_ms = 0.0
        self._stat_collect_ms = 0.0
        self._stat_last_batch = 0
        self._ema_qps = 0.0  # recent drain throughput, for Retry-After
        # optional read-cache counter view (set_cache_view): per-class
        # co_cache_* gauges merged into stats()
        self._cache_view = None
        # optional per-key-range load accounting (set_load_view): every
        # locally-served query stamps its covering's buckets, feeding
        # the skew-aware shard rebalancer
        self._load_view = None
        # optional multi-chip offload: big read-only batches can run on
        # a fresh ShardedReplica mesh instead of the local device
        self._mesh_fn = None
        self._mesh_fresh = None
        self._mesh_min = 64
        self._mesh_max = 256  # beyond this, ONE local fused dispatch
        #                       beats serialized mesh chunk round trips
        self._mesh_bgen = None  # replica boundary-generation getter:
        #   plans record WHICH shard placement they were made against
        self.mesh_offloads = 0
        # optional degradation ladder (chaos.DegradationLadder): when
        # attached, device-loss failures flip DEVICE_LOST (the planner
        # stops admitting device-class routes) and the failed batch is
        # re-served on the host — no caller ever sees the loss
        self._health = None

    def _make_resident_loop(self):
        """Create (once) the resident device-feeder loop and install
        the fold-time capture hook on the table.  Requires the
        submit/collect split; silently stays off for plain tables."""
        if self._res_loop is not None:
            return
        if getattr(self._table, "query_many_submit", None) is None:
            return
        from dss_tpu_torch.ops.resident import ResidentLoop

        self._res_loop = ResidentLoop(
            self._table,
            ring_capacity=self._res_ring,
            max_inflight=self._res_inflight,
        )
        set_warm = getattr(self._table, "set_resident_warm", None)
        if set_warm is not None:
            kern = self._res_loop.kernel

            def warm_hook(ft, _kern=kern):
                # fold-time warm: only tables big enough to route to
                # the device are worth grid captures — the tiny L1
                # tiers a minor fold rebuilds serve from the host path
                # anyway.  ASYNC on purpose: captures inside the fold
                # would stall it; until a bucket lands, submits launch
                # B1 eagerly.
                if ft.n_postings >= 1 << 14:
                    _kern.warm_async(ft)

            set_warm(warm_hook)

    def resident_loop(self):
        """The attached ResidentLoop, or None (boot warm + tests)."""
        return self._res_loop

    def set_health(self, ladder) -> None:
        """Attach the store's degradation ladder (dss_store wiring):
        the planner reads device_ok from it and device-loss failures
        report into it."""
        self._health = ladder

    def _device_ok(self) -> bool:
        h = self._health
        return True if h is None else h.device_ok()

    def _absorb_device_loss(self, e: BaseException) -> bool:
        """Is `e` a device loss this pipeline should absorb (report
        DEVICE_LOST to the ladder, re-serve the batch on the host)
        instead of delivering to callers?"""
        if not chaos.is_device_loss(e):
            return False
        with self._slock:
            self._stat_device_loss_absorbed += 1
        if self._health is not None:
            self._health.enter("device_lost", reason=str(e))
        return True

    def _host_rerun(self, batch: List[_Item]) -> None:
        """Serve a device-failed batch via forced host chunks — the
        pure-host path (FastTable.query_host_chunked), so a lost
        device costs latency, never correctness or a caller 5xx."""
        try:
            keys, lo, hi, t0s, t1s, now, owners = self._pack_args(batch)
            submit = getattr(self._table, "query_many_submit", None)
            if submit is not None:
                pq = submit(
                    keys, lo, hi, t0s, t1s, now=now, owner_ids=owners,
                    host_route=True,
                )
                self._deliver_results(
                    batch, self._table.query_many_collect(pq)
                )
            else:
                self._deliver_results(
                    batch,
                    self._table.query_many(
                        keys, lo, hi, t0s, t1s, now=now,
                        owner_ids=owners, host_route=True,
                    ),
                )
        except BaseException as e:  # noqa: BLE001 — deliver to callers
            self._deliver_error(batch, e)

    def set_cache_view(self, fn) -> None:
        """Attach the read cache's per-class counter view (readcache
        .ReadCache.class_stats): co_cache_{hits,misses,invalidations}
        then ride this coalescer's stats into /metrics as
        dss_dar_<class>_co_cache_* — hits ARE part of the serving
        story (they bypass this pipeline entirely: no admission, no
        deadline stamp, no Retry-After backlog contribution)."""
        self._cache_view = fn

    def set_load_view(self, load) -> None:
        """Attach a tiers.RangeLoad: every query THIS pipeline serves
        records its covering + measured result work into the per-key-
        range load EWMA the skew-aware shard splitter plans from.
        Only coalescer-served traffic counts by construction — read-
        cache hits bypass the pipeline entirely and never reach a
        shard, and mesh-offloaded batches are recorded by the replica
        itself (its own serving entry), never double-counted here."""
        self._load_view = load

    def set_mesh_delegate(self, fn, fresh_fn, min_batch: int = 64,
                          bgen_fn=None):
        """Route batches of >= min_batch bounded-staleness queries
        (every item flagged allow_stale, no owner filters) to `fn`
        (the ShardedReplica mesh) when fresh_fn() says the replica is
        caught up.  Conflict prechecks never set allow_stale, so
        correctness-critical reads always hit the local table.
        `bgen_fn` (optional) reports the replica's shard-boundary
        generation so every Plan records which placement it was
        decided against."""
        self._mesh_fn = fn
        self._mesh_fresh = fresh_fn
        self._mesh_min = min_batch
        self._mesh_bgen = bgen_fn

    def configure(
        self,
        *,
        min_batch: Optional[int] = None,
        max_batch: Optional[int] = None,
        target_batch_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        admission_wait_s: Optional[float] = None,
        inline: Optional[bool] = None,
        slo_ms: Optional[float] = None,
        resident: Optional[bool] = None,
        est_floor_ms: Optional[float] = None,
        est_item_ms: Optional[float] = None,
        est_chunk_ms: Optional[float] = None,
        est_res_floor_ms: Optional[float] = None,
        est_res_lat_ms: Optional[float] = None,
        res_ring: Optional[int] = None,
        res_inflight: Optional[int] = None,
    ) -> None:
        """Adjust serving knobs at runtime (ops endpoint / tests / the
        tune actuator).  Pipeline depth is fixed at construction (the
        double buffer).  resident=True attaches the resident loop
        (idempotent); resident=False detaches it for NEW batches (the
        loop drains what it holds — in-flight callers still resolve).
        The est_* knobs reseed the live CostModel (CostModel.reseed —
        the tuner's hot-swap path; winsorization would otherwise make
        a post-flip correction crawl); res_ring/res_inflight resize
        the resident loop by detach+reattach when one is running
        (in-flight batches drain first, same contract as resident
        toggling)."""
        if (est_floor_ms is not None or est_item_ms is not None
                or est_chunk_ms is not None
                or est_res_floor_ms is not None
                or est_res_lat_ms is not None):
            self._cost.reseed(
                floor_ms=est_floor_ms, item_ms=est_item_ms,
                chunk_ms=est_chunk_ms,
                res_floor_ms=est_res_floor_ms,
                res_lat_ms=est_res_lat_ms,
            )
        if res_ring is not None or res_inflight is not None:
            if res_ring is not None:
                self._res_ring = max(1, int(res_ring))
            if res_inflight is not None:
                self._res_inflight = max(1, int(res_inflight))
            if self._res_loop is not None:
                loop, self._res_loop = self._res_loop, None
                loop.close(join=True)
                self._make_resident_loop()
        if resident is not None:
            if resident:
                self._make_resident_loop()
            elif self._res_loop is not None:
                loop, self._res_loop = self._res_loop, None
                loop.close(join=True)
        with self._cond:
            if slo_ms is not None:
                self._slo_ms = float(slo_ms)
            if min_batch is not None:
                self._ctl.min_batch = int(min_batch)
            if max_batch is not None:
                self._ctl.max_batch = int(max_batch)
            if target_batch_ms is not None:
                self._ctl.target_ms = float(target_batch_ms)
            self._ctl.cur = max(
                self._ctl.min_batch, min(self._ctl.max_batch, self._ctl.cur)
            )
            if queue_depth is not None:
                self._queue_depth = int(queue_depth)
            self._max_queue = self._queue_depth * self._ctl.max_batch
            if admission_wait_s is not None:
                self._admission_wait_s = float(admission_wait_s)
            if inline is not None:
                self._inline = bool(inline)
            self._cond.notify_all()

    def _ensure_threads(self):
        if self._pack_thread is None or not self._pack_thread.is_alive():
            self._pack_thread = threading.Thread(
                target=self._pack_loop, name="dar-coalescer-pack",
                daemon=True,
            )
            self._pack_thread.start()
        if (
            self._collect_thread is None
            or not self._collect_thread.is_alive()
        ):
            self._collect_thread = threading.Thread(
                target=self._collect_loop, name="dar-coalescer-collect",
                daemon=True,
            )
            self._collect_thread.start()

    def _retry_after_locked(self) -> float:
        """Queue-drain horizon estimate for the 429 Retry-After: live
        backlog (queued + actually in-flight items, not a batch-size
        guess) over the measured drain-rate EWMA.  Before any drain
        has been observed, the PLANNER's best-plan throughput for the
        queued shape class stands in — the throughput of the route it
        would actually choose for what is queued, not an unconditional
        min(host, device).  The old fallback quoted `min_route_qps`
        even when the planner would never pick that route for the
        queued traffic: an all-stale bulk overload the resident
        stream absorbs was told to wait at cold-dispatch-floor rates
        (5 s horizons inviting synchronized retry storms), and a
        fresh-SLO overload draining hostward was quoted device
        throughput it will never see."""
        backlog = len(self._queue) + self._inflight_items
        qps = self._ema_qps
        if qps <= 1.0:
            # plan for what is ACTUALLY queued: the drained shape the
            # pack stage will see next (same headroom scan as
            # _drain_locked, same shape derivation as _shape_of)
            look = self._queue[: self._ctl.cur]
            now_m = self._clock()
            headroom_ms = None
            for it in look:
                if (
                    it.deadline is not None
                    and not it.allow_stale
                    and not it.expired(now_m)
                ):
                    h = (it.deadline - now_m) * 1000.0
                    if headroom_ms is None or h < headroom_ms:
                        headroom_ms = h
            all_stale = bool(look) and all(
                it.allow_stale for it in look
            )
            qps = max(
                1.0,
                self._planner.backlog_qps(
                    self._ctl.cur, self._capture_state(), headroom_ms,
                    all_stale=all_stale,
                ),
            )
        return min(5.0, max(0.05, backlog / qps))

    def query(
        self,
        keys: np.ndarray,
        alt_lo=None,
        alt_hi=None,
        t_start=None,
        t_end=None,
        *,
        now: int,
        owner_id=None,
        allow_stale: bool = False,
    ) -> List[str]:
        """Blocking single query, executed as part of a micro-batch.
        Raises errors.OverloadedError when the bounded queue stays full
        past the admission wait (the caller should back off)."""
        keys = np.asarray(keys, np.int32).ravel()
        if len(keys) == 0:
            return []
        # deadline at admission: the serving SLO from "now" (queue wait
        # counts against it), capped by the route deadline the HTTP
        # timeout middleware propagated.  Bounded-staleness queries
        # carry only the route deadline — they are explicitly latency-
        # tolerant, so they never drag a batch onto the host route.
        route_dl = _deadline.get_route_deadline()
        if allow_stale or self._slo_ms <= 0:
            dl = route_dl
        else:
            dl = self._clock() + self._slo_ms / 1000.0
            if route_dl is not None:
                dl = min(dl, route_dl)
        if dl is not None and dl <= self._clock():
            # the route deadline was consumed before the query reached
            # the store (slow auth/parse/covering): shed NOW — the
            # inline path would otherwise run a scan whose response
            # the timeout middleware has already replaced with a 504
            with self._slock:
                self._stat_deadline_shed += 1
            raise errors.deadline_exceeded(
                "request deadline expired before query admission"
            )
        item = _Item(
            keys, alt_lo, alt_hi, t_start, t_end, now, owner_id,
            allow_stale, deadline=dl,
        )
        # trace handle captured on the caller's thread: the pipeline
        # stamps span timings onto the item and THIS thread records
        # them after the event resolves (cross-thread span handoff)
        th = _trace.current()
        t_adm_w = 0
        if th is not None:
            item.tctx = th
            t_adm_w = time.time_ns()
        inline = False
        deadline = None
        with self._cond:
            while True:
                if self._closed:
                    raise RuntimeError("coalescer is closed")
                if (
                    self._inline
                    and not self._busy
                    and not self._packing
                    and self._inflight == 0
                    and not self._queue
                ):
                    # lone caller: run inline as a batch of 1 — skips
                    # two thread handoffs (~0.15 ms on a loaded host).
                    # Reads are lock-free (immutable state grab), so
                    # executing on the caller's thread is safe; `_busy`
                    # makes arrivals during execution queue up and
                    # batch as before.
                    self._busy = True
                    inline = True
                    break
                if budget.is_host_only():
                    # event-loop caller would block in event.wait()
                    # behind another thread's (possibly compiling)
                    # batch: bounce to the executor path instead
                    raise budget.NeedsDevice()
                if len(self._queue) < self._max_queue:
                    if th is not None:
                        item.enq_ns = time.time_ns()
                    self._queue.append(item)
                    self._ensure_threads()
                    self._cond.notify_all()
                    break
                # admission control: the queue is at capacity.  Wait a
                # bounded moment for the pipeline to drain, then shed —
                # bounded latency for admitted work beats a backlog
                # whose p50 grows without limit.
                t_mono = time.monotonic()
                if deadline is None:
                    deadline = t_mono + max(0.0, self._admission_wait_s)
                if t_mono >= deadline:
                    with self._slock:
                        self._stat_shed += 1
                    raise errors.OverloadedError(
                        f"query queue full ({self._max_queue} deep); "
                        "request shed",
                        retry_after_s=self._retry_after_locked(),
                    )
                self._cond.wait(deadline - t_mono)
        if th is not None:
            # the admission gate: usually microseconds, the full
            # admission_wait under backpressure
            _trace.add_span(
                th, "admission", t_adm_w,
                (time.time_ns() - t_adm_w) / 1e6,
            )
        if inline:
            # the lone-caller shortcut must not bypass the router: an
            # idle-server fresh query whose candidates overflow the
            # auto host cap would otherwise ride the device dispatch
            # floor and blow the very SLO the router protects
            hr = None
            if item.deadline is not None and not item.allow_stale:
                hr = max(0.0, (item.deadline - self._clock()) * 1000.0)
            try:
                self._execute([item], headroom_ms=hr)
                with self._slock:
                    self._stat_inline += 1
            finally:
                with self._cond:
                    self._busy = False
                    if self._queue and not self._closed:
                        self._ensure_threads()
                    self._cond.notify_all()
        else:
            t_wait = time.perf_counter()
            item.event.wait()
            _stages.mark(
                "coalesce_wait_ms",
                (time.perf_counter() - t_wait) * 1000,
            )
        if th is not None:
            self._record_item_spans(item, th)
        if item.error is not None:
            raise item.error
        # item.via_mesh marks bounded-stale mesh output; the reference
        # notes it to its read cache here, which the port does not have
        # yet (no mesh delegate is attached either)
        return item.result

    def close(self, join: bool = True, timeout: float = 30.0):
        """Stop accepting queries and (by default) wait for BOTH stages
        to drain — queued and in-flight batches complete, and joining
        prevents the interpreter tearing down the device runtime while
        a stage is mid-dispatch.  The resident loop is closed LAST
        (after the pack stage can no longer enqueue into its ring):
        it drains the ring, so batches still queued there at shutdown
        are submitted, collected, and delivered like any other."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            pack_th = self._pack_thread
            coll_th = self._collect_thread
        if not join:
            return
        me = threading.current_thread()
        for th in (pack_th, coll_th):
            if th is not None and th is not me:
                th.join(timeout)
        if self._res_loop is not None:
            self._res_loop.close(join=True, timeout=timeout)

    # -- pipeline stages ------------------------------------------------------

    def _shape_of(self, batch: List[_Item],
                  inline: bool = False) -> BatchShape:
        """The planner's view of a drained batch."""
        # getattr defaults: the routing tests drive this with bare
        # placeholder items (the pre-planner router read only len())
        return BatchShape(
            n=len(batch),
            all_stale=all(
                getattr(it, "allow_stale", False) for it in batch
            ),
            owner_scoped=any(
                getattr(it, "owner_id", -1) >= 0 for it in batch
            ),
            inline=inline,
        )

    def _capture_state(self, host_only: bool = False):
        """Freeze the planner's full decision input: live cost
        estimates + this pipeline's pressure counters + which routes
        are attached right now.  Racy unlocked reads of the pressure
        counters are deliberate and unchanged from the pre-planner
        router — a decision made one batch stale is still safe (the
        counters only pad predictions)."""
        bgen = 0
        if self._mesh_bgen is not None:
            try:
                bgen = int(self._mesh_bgen())
            except Exception:  # noqa: BLE001 — introspection only
                bgen = 0
        return self._planner.capture(
            inflight_device=self._inflight_device,
            inflight_host_chunks=self._inflight_host_chunks,
            inflight_resident=self._inflight_resident,
            resident_ready=self._resident_ready(),
            mesh_ready=self._mesh_fn is not None,
            mesh_min=self._mesh_min,
            mesh_max=self._mesh_max,
            host_only=host_only,
            boundary_gen=bgen,
            device_ok=self._device_ok(),
        )

    def _mesh_eligible(self, batch: List[_Item]) -> bool:
        from dss_tpu_torch.plan.planner import mesh_admissible

        return mesh_admissible(
            self._shape_of(batch), self._capture_state()
        )

    def _drain_locked(self):
        """Pop the next drain off the queue (caller holds _cond):
        -> (batch, expired, headroom_ms).  Items whose deadline already
        passed are split out for fast-shedding; headroom_ms is the
        tightest remaining deadline among the drainable fresh items
        (None when none carries a deadline — e.g. an all-stale-ok
        drain); the drain size is the AIMD controller output bounded
        by what the predicted route cost fits into that headroom."""
        now_m = self._clock()
        look = self._queue[: self._ctl.cur]
        headroom_ms = None
        for it in look:
            if (
                it.deadline is not None
                and not it.allow_stale
                and not it.expired(now_m)
            ):
                h = (it.deadline - now_m) * 1000.0
                if headroom_ms is None or h < headroom_ms:
                    headroom_ms = h
        cap = self._planner.drain_cap(
            self._ctl.cur, headroom_ms, self._capture_state()
        )
        batch: List[_Item] = []
        expired: List[_Item] = []
        taken = 0
        for it in look:
            if it.expired(now_m):
                expired.append(it)
                taken += 1
                continue
            if len(batch) >= cap:
                break
            batch.append(it)
            taken += 1
        del self._queue[:taken]
        return batch, expired, headroom_ms

    def _resident_ready(self) -> bool:
        """Resident route admissible right now: loop attached and its
        host ring has space (a full ring means the device stream is
        already saturated — routing more at it would just queue)."""
        return self._res_loop is not None and self._res_loop.has_space()

    def _plan_batch(self, batch, headroom_ms):
        """Plan a pack-stage drain: ONE planner decision over all
        attached routes (mesh / resident / cold device / forced host
        chunks), recorded in the co_plan_* counters.  The policy
        itself lives in dss_tpu_torch/plan/planner.decide — a pure function
        pinned decision-identical to the pre-planner router."""
        return self._planner.plan(
            self._shape_of(batch), self._capture_state(), headroom_ms,
        )

    def _choose_route(self, batch, headroom_ms,
                      allow_resident: bool = True) -> str:
        """Route-string view of the planner decision (the pre-planner
        router's contract, kept for the routing tests): never returns
        "mesh" — the mesh candidate was historically decided before
        this comparison and still is (_plan_batch handles it)."""
        return self._planner.plan(
            self._shape_of(batch), self._capture_state(), headroom_ms,
            allow_resident=allow_resident, allow_mesh=False,
            record=False,
        ).route

    def _choose_host_route(self, batch, headroom_ms) -> bool:
        """Boolean view of _choose_route for consumers that CANNOT
        ride the resident loop (the inline lone-caller path and the
        mesh fallback run synchronously on the caller's thread).  The
        resident candidate is excluded from the comparison: a batch
        cleared only because the stream's latency fits would otherwise
        be run as a COLD dispatch here and blow the very deadline the
        clearance assumed."""
        return (
            self._choose_route(batch, headroom_ms, allow_resident=False)
            == "hostchunk"
        )

    def _pack_loop(self):
        """Stage 1: drain the queue (deadline-capped), fast-shed
        expired items, route the batch (host chunks vs fused device
        kernel) by predicted cost vs headroom, pack windows on the
        host, start any device kernel asynchronously.  Hands
        (batch, pending) to the collect stage through a bounded double
        buffer, so pack of batch N+1 overlaps device execution +
        decode of batch N."""
        while True:
            with self._cond:
                # also wait while an inline batch is executing: its
                # arrivals should form ONE next batch, not race it
                while (not self._queue or self._busy) and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    break
                batch, expired, headroom_ms = self._drain_locked()
                self._packing = True
                self._inflight += 1
                self._inflight_items += len(batch)
                # queue space just opened: wake admission waiters
                self._cond.notify_all()
            if expired:
                # deadline expired while queued: typed 504 now, not a
                # wasted kernel slot later
                self._deliver_error(
                    expired,
                    errors.deadline_exceeded(
                        "request deadline expired in the serving queue"
                    ),
                )
                with self._slock:
                    self._stat_deadline_shed += len(expired)
            if not batch:
                with self._cond:
                    self._packing = False
                    self._inflight -= 1
                    self._cond.notify_all()
                continue
            # cross-thread tracing: when any drained item carries a
            # trace handle, the pipeline measures its stages as
            # (name, start, dur) tuples and stamps them onto the
            # items at delivery — one `traced` check per batch when
            # tracing is off
            traced = any(it.tctx is not None for it in batch)
            tr_spans = [] if traced else None
            t0 = time.perf_counter()
            t0_w = time.time_ns() if traced else 0
            pq = None
            kind = "exec"
            host_route = False
            used_device = False
            try:
                submit = getattr(self._table, "query_many_submit", None)
                if submit is not None:
                    # ONE planner decision covers every attached route;
                    # a "mesh" plan rides the synchronous exec path
                    # exactly as the pre-planner mesh-eligibility
                    # check did (freshness re-verified at execution,
                    # local fallback re-plans inline)
                    if traced:
                        tp_w, tp0 = time.time_ns(), time.perf_counter()
                    route = self._plan_batch(batch, headroom_ms).route
                    if traced:
                        tr_spans.append((
                            "plan", tp_w,
                            (time.perf_counter() - tp0) * 1000,
                            {"route": route},
                        ))
                    if route == "resident":
                        if self._enqueue_resident(batch, tr_spans):
                            # the resident loop owns this batch now:
                            # its feeder submits into the device
                            # stream, its collector delivers + feeds
                            # the resident cost key.  Nothing goes
                            # through the collect stage.
                            with self._cond:
                                self._packing = False
                                self._cond.notify_all()
                            continue
                        # ring filled between the plan and the
                        # enqueue: demote to a cold dispatch (the
                        # pack stage never blocks on the stream)
                        self._planner.note_fallback()
                        route = "device"
                    if route != "mesh":
                        host_route = route == "hostchunk"
                        if host_route:
                            # forced chunked host scans execute on the
                            # COLLECT stage: running them here would
                            # serialize the two-stage pipeline exactly
                            # when deadline pressure needs it most
                            # (pack keeps draining while collect scans)
                            kind = "hostchunk"
                        else:
                            keys, lo, hi, t0s, t1s, now, owners = (
                                self._pack_args(batch)
                            )
                            if traced:
                                td_w = time.time_ns()
                                td0 = time.perf_counter()
                            try:
                                # chaos seam: the cold fused dispatch
                                chaos.fault_point("device.dispatch")
                                pq = submit(
                                    keys, lo, hi, t0s, t1s,
                                    now=now, owner_ids=owners,
                                    host_route=False,
                                )
                            except BaseException as e:
                                if not self._absorb_device_loss(e):
                                    raise
                                # device lost at submit: demote THIS
                                # batch to forced host chunks (the
                                # collect stage runs them) — the
                                # planner stops admitting the device
                                # class from the next state capture
                                host_route = True
                                kind = "hostchunk"
                                pq = None
                            else:
                                kind = "table"
                                used_device = self._pq_used_device(pq)
                                if traced:
                                    tr_spans.append((
                                        "device.dispatch", td_w,
                                        (time.perf_counter() - td0)
                                        * 1000,
                                        {"used_device": used_device},
                                    ))
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                self._deliver_error(batch, e)
                with self._cond:
                    self._packing = False
                    self._inflight -= 1
                    self._inflight_items -= len(batch)
                    self._cond.notify_all()
                continue
            pack_ms = (time.perf_counter() - t0) * 1000
            if traced:
                tr_spans.append(("coalesce.pack", t0_w, pack_ms, None))
            if used_device or kind == "hostchunk":
                # count the pressure BEFORE the handoff: the collect
                # thread decrements after processing, so incrementing
                # after put() could briefly hide in-flight work from
                # the router's predictions
                with self._cond:
                    if used_device:
                        self._inflight_device += 1
                    else:
                        self._inflight_host_chunks += (
                            self._cost._chunks(len(batch))
                        )
            # bounded handoff: blocks when the collect stage is
            # pipeline_depth batches behind (the double buffer)
            self._inflight_q.put(
                (batch, kind, pq, pack_ms, host_route, used_device,
                 tr_spans)
            )
            with self._cond:
                self._packing = False
        # shutdown sentinel — put OUTSIDE the condition lock: the
        # handoff queue may be full, and blocking on put() while
        # holding _cond deadlocks against the collect stage's
        # end-of-batch `with self._cond` accounting (collect could
        # then never drain the queue to unblock this put)
        self._inflight_q.put(_DONE)

    def _collect_loop(self):
        """Stage 2: wait for the device, decode, deliver results, and
        feed the batch-size controller + the route cost models."""
        while True:
            handoff = self._inflight_q.get()
            if handoff is _DONE:
                return
            (batch, kind, pq, pack_ms, host_route, used_device,
             tr_spans) = handoff
            t0 = time.perf_counter()
            t1 = t0
            device_ms = 0.0
            # what the batch ACTUALLY rode (a forced host batch can
            # fall back to the device per tier); used_device keeps the
            # pack-time accounting for the pressure-counter decrement
            observed_device = used_device
            try:
                if kind == "table":
                    pq.wait_device()
                    t1 = time.perf_counter()
                    device_ms = (t1 - t0) * 1000
                    results = self._table.query_many_collect(pq)
                    if tr_spans is not None:
                        coll_ms = (time.perf_counter() - t1) * 1000
                        now_w = time.time_ns()
                        self._stamp_spans(batch, tr_spans + [
                            ("device.wait",
                             now_w - int((device_ms + coll_ms) * 1e6),
                             device_ms, None),
                            ("collect", now_w - int(coll_ms * 1e6),
                             coll_ms, None),
                        ])
                    self._deliver_results(batch, results)
                elif kind == "hostchunk":
                    # the deadline router's forced route, deferred here
                    # so it overlaps the pack of the next drain.  Run
                    # the split halves: a tier whose chunks overflow
                    # the raised candidate cap silently rides the
                    # device, and that outcome must be OBSERVED (fed to
                    # the device model, counted as a device batch) or
                    # one fallback would poison est_chunk_ms with a
                    # dispatch floor and mislabel the route mix
                    keys, lo, hi, t0s, t1s, now, owners = (
                        self._pack_args(batch)
                    )
                    if tr_spans is not None:
                        th_w = time.time_ns()
                        th0 = time.perf_counter()
                    pq = self._table.query_many_submit(
                        keys, lo, hi, t0s, t1s,
                        now=now, owner_ids=owners, host_route=True,
                    )
                    observed_device = self._pq_used_device(pq)
                    results = self._table.query_many_collect(pq)
                    if tr_spans is not None:
                        self._stamp_spans(batch, tr_spans + [
                            ("host.scan", th_w,
                             (time.perf_counter() - th0) * 1000,
                             {"fallback_device": observed_device}),
                        ])
                    self._deliver_results(batch, results)
                else:
                    # mesh-planned (or submit-less table): the full
                    # synchronous path, mesh-first with local fallback
                    # (plan already recorded at pack time)
                    self._execute(batch, record_plan=False)
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                if self._absorb_device_loss(e):
                    # device lost while this batch was in flight:
                    # re-serve it on the pure host path — callers pay
                    # latency, never a 5xx (the ladder's DEVICE_LOST
                    # contract)
                    self._host_rerun(batch)
                else:
                    self._deliver_error(batch, e)
            collect_ms = (time.perf_counter() - t1) * 1000
            total_ms = pack_ms + device_ms + collect_ms
            with self._slock:
                self._stat_batches += 1
                self._stat_items += len(batch)
                self._stat_pack_ms += pack_ms
                self._stat_device_ms += device_ms
                self._stat_collect_ms += collect_ms
                self._stat_last_batch = len(batch)
                if kind in ("table", "hostchunk"):
                    # feed the EWMA cost models with the measured
                    # end-to-end batch cost (what a queued caller pays)
                    if observed_device:
                        self._stat_route_device += 1
                        self._cost.observe_device(len(batch), total_ms)
                    else:
                        self._stat_route_host += 1
                        if host_route:
                            self._stat_route_hostchunk += 1
                        if host_route or len(batch) >= self._cost.chunk:
                            # tiny auto-host batches cost one SCAN, not
                            # one warmed 64-wide CHUNK — feeding them
                            # in would train est_chunk_ms to ~a point
                            # lookup and make the first pressure burst
                            # over-drain its headroom
                            self._cost.observe_host(len(batch), total_ms)
                if total_ms > 0:
                    inst = len(batch) / (total_ms / 1000.0)
                    self._ema_qps = (
                        inst if self._ema_qps == 0.0
                        else 0.8 * self._ema_qps + 0.2 * inst
                    )
            with self._cond:
                self._ctl.observe(len(batch), total_ms)
                self._inflight -= 1
                self._inflight_items -= len(batch)
                if used_device:
                    self._inflight_device -= 1
                elif kind == "hostchunk":
                    self._inflight_host_chunks -= self._cost._chunks(
                        len(batch)
                    )
                self._cond.notify_all()

    @staticmethod
    def _record_item_spans(item: _Item, th) -> None:
        """Record the pipeline-stamped spans through the caller's own
        trace handle (runs on the caller's thread, after the event) —
        plus the queue-wait span derived from enqueue -> first stamped
        span."""
        spans = item.tspans or ()
        if item.enq_ns and spans:
            first = min(s[1] for s in spans)
            if first > item.enq_ns:
                _trace.add_span(
                    th, "queue_wait", item.enq_ns,
                    (first - item.enq_ns) / 1e6,
                )
        for rec in spans:
            name, start_ns, dur_ms = rec[0], rec[1], rec[2]
            attrs = rec[3] if len(rec) > 3 else None
            _trace.add_span(th, name, start_ns, dur_ms, attrs=attrs)

    @staticmethod
    def _stamp_spans(batch: List[_Item], spans) -> None:
        """Attach the batch's measured span tuples to every traced
        item (the caller threads record them — see _record_item_spans).
        Must run BEFORE results are delivered: event.set releases the
        caller."""
        for it in batch:
            if it.tctx is not None:
                it.tspans = spans

    @staticmethod
    def _deliver_error(batch: List[_Item], e: BaseException) -> None:
        for it in batch:
            if not it.event.is_set():
                it.error = e
                it.event.set()

    def _deliver_results(self, batch: List[_Item], results) -> None:
        load = self._load_view
        for it, res in zip(batch, results):
            it.result = res
            it.event.set()
            if load is not None and not it.via_mesh:
                # after event.set() on purpose: load accounting must
                # never add latency in front of a waiting caller
                try:
                    load.record(it.keys, len(res))
                except Exception:  # noqa: BLE001 — metrics-only path
                    pass

    def _enqueue_resident(self, batch: List[_Item],
                          pre_spans=None) -> bool:
        """Hand a drained batch to the resident loop's host ring.
        Non-blocking: False (ring full / loop closed) leaves the batch
        with the caller, which falls back to the cold device path —
        the pack stage never stalls behind the device stream.  The
        loop's collector delivers results AND feeds the resident cost
        key with the measured marginal (inter-completion) cost; the
        cold-device floor is never touched by these observations.
        `pre_spans` carries pack-stage trace spans (plan) stamped onto
        traced items together with the stream span at delivery."""
        loop = self._res_loop
        if loop is None:
            return False
        payload = self._pack_args(batch)

        def done(results, err, gap_ms, lat_ms, used_device,
                 _batch=batch, _pre=pre_spans):
            if err is not None:
                if self._absorb_device_loss(err):
                    # the stream died mid-flight: re-serve on the host
                    # (runs on the loop's collector thread — the
                    # stream is dead anyway, nothing to serialize on)
                    self._host_rerun(_batch)
                else:
                    self._deliver_error(_batch, err)
            else:
                if _pre is not None:
                    self._stamp_spans(_batch, _pre + [(
                        "resident.stream",
                        time.time_ns() - int(lat_ms * 1e6), lat_ms,
                        {"gap_ms": round(gap_ms, 3),
                         "used_device": bool(used_device)},
                    )])
                self._deliver_results(_batch, results)
            with self._slock:
                self._stat_batches += 1
                self._stat_items += len(_batch)
                self._stat_last_batch = len(_batch)
                self._stat_route_resident += 1
                if err is None:
                    if used_device:
                        # only batches that actually rode the device
                        # stream feed the resident keys — a batch whose
                        # tiers all answered host-side completes in
                        # sub-ms and would train the stream estimates
                        # toward host-scan cost, sending later
                        # deadline traffic into a stream that cannot
                        # deliver it (the cold path gates its models
                        # on observed_device for the same reason)
                        self._cost.observe_resident(
                            len(_batch), gap_ms, lat_ms
                        )
                    elif len(_batch) >= self._cost.chunk:
                        self._cost.observe_host(len(_batch), gap_ms)
                if gap_ms > 0:
                    inst = len(_batch) / (gap_ms / 1000.0)
                    self._ema_qps = (
                        inst if self._ema_qps == 0.0
                        else 0.8 * self._ema_qps + 0.2 * inst
                    )
            with self._cond:
                self._ctl.observe(len(_batch), gap_ms)
                self._inflight -= 1
                self._inflight_items -= len(_batch)
                self._inflight_resident -= 1
                self._cond.notify_all()

        with self._cond:
            self._inflight_resident += 1
        if loop.enqueue(payload, done):
            return True
        with self._cond:
            self._inflight_resident -= 1
        return False

    @staticmethod
    def _pq_used_device(pq) -> bool:
        """Did this submitted batch touch the device?  (A forced host
        batch can still fall back per tier on candidate-cap overflow —
        the router's accounting must see what actually happened.)
        Delegates to _PendingQuery.used_device when available so the
        predicate lives in one place (dar/snapshot.py)."""
        if pq is None:
            return False
        fn = getattr(pq, "used_device", None)
        if fn is not None:
            return bool(fn())
        return any(
            p is not None for p in getattr(pq, "tier_pending", ())
        )

    @staticmethod
    def _pack_args(batch: List[_Item]):
        """Marshal a batch into the array arguments shared by
        query_many / query_many_submit / the mesh fn."""
        return (
            [it.keys for it in batch],
            np.asarray([it.alt_lo for it in batch], np.float32),
            np.asarray([it.alt_hi for it in batch], np.float32),
            np.asarray([it.t_start for it in batch], np.int64),
            np.asarray([it.t_end for it in batch], np.int64),
            np.asarray([it.now for it in batch], np.int64),
            np.asarray([it.owner_id for it in batch], np.int32),
        )

    # -- synchronous execution (inline path + mesh batches) -------------------

    def _execute(self, batch: List[_Item], headroom_ms=None,
                 record_plan: bool = True):
        try:
            b = len(batch)
            traced = any(it.tctx is not None for it in batch)
            # plan the synchronous execution: resident excluded (this
            # runs on the caller's thread — a cold dispatch dressed as
            # the stream would blow the deadline the stream's latency
            # cleared), host_only honored (an event-loop caller never
            # gets the raised-cap forced scans).  record_plan=False on
            # the collect-stage path, whose batch was already planned
            # at pack time.
            if traced:
                tp_w, tp0 = time.time_ns(), time.perf_counter()
            plan = self._planner.plan(
                self._shape_of(batch, inline=True),
                self._capture_state(host_only=budget.is_host_only()),
                headroom_ms,
                allow_resident=False,
                record=record_plan,
            )
            plan_span = None
            if traced:
                plan_span = (
                    "plan", tp_w, (time.perf_counter() - tp0) * 1000,
                    {"route": plan.route},
                )
            if plan.route == "mesh" and self._mesh_fresh():
                try:
                    # chunk to the warmed bucket (the replica warms
                    # batch=min_batch per rebuild): a 65..4096 batch
                    # must not stall every caller on a fresh multi-chip
                    # compile for an unwarmed pow2 bucket
                    for start in range(0, b, self._mesh_min):
                        part = batch[start : start + self._mesh_min]
                        keys, lo, hi, t0s, t1s, now, _ = (
                            self._pack_args(part)
                        )
                        if traced:
                            tm_w = time.time_ns()
                            tm0 = time.perf_counter()
                        results = self._mesh_fn(
                            keys, lo, hi, t0s, t1s, now
                        )
                        if traced:
                            self._stamp_spans(part, [plan_span, (
                                "mesh", tm_w,
                                (time.perf_counter() - tm0) * 1000,
                                None,
                            )])
                        for it, res in zip(part, results):
                            it.via_mesh = True  # before event.set()
                            it.result = res
                            it.event.set()
                    self.mesh_offloads += 1
                    return
                except Exception:  # noqa: BLE001 — fall back local
                    import logging

                    logging.getLogger("dss.dar").exception(
                        "mesh offload failed; serving batch locally"
                    )
            keys, lo, hi, t0s, t1s, now, owners = self._pack_args(batch)
            # the plan already honored host-only callers (the event
            # loop's inline-read budget): a host_only state makes the
            # forced-chunk candidate inadmissible, so the auto path's
            # 2^16 cap stays the loop's worst case and anything bigger
            # raises NeedsDevice and re-routes on the executor
            host_route = plan.route == "hostchunk"
            submit = getattr(self._table, "query_many_submit", None)
            t0 = time.perf_counter()
            t0_w = time.time_ns() if traced else 0
            used_device = None
            if submit is not None:
                # run the split halves so the chosen route is
                # observable: inline traffic must feed the cost models
                # too, or a low-load deployment would route on the
                # boot seed forever
                try:
                    if not host_route:
                        chaos.fault_point("device.dispatch")
                    pq = submit(
                        keys, lo, hi, t0s, t1s, now=now,
                        owner_ids=owners, host_route=host_route,
                    )
                    used_device = self._pq_used_device(pq)
                    if traced:
                        disp_ms = (time.perf_counter() - t0) * 1000
                        tc_w, tc0 = time.time_ns(), time.perf_counter()
                    results = self._table.query_many_collect(pq)
                    if traced:
                        spans = [plan_span]
                        if host_route:
                            spans.append((
                                "host.scan", t0_w,
                                disp_ms
                                + (time.perf_counter() - tc0) * 1000,
                                None,
                            ))
                        else:
                            # the dispatch seam (incl. any injected
                            # device.dispatch fault delay) and the
                            # wait+decode, split like the pipeline's
                            spans.append((
                                "device.dispatch", t0_w, disp_ms,
                                {"used_device": bool(used_device)},
                            ))
                            spans.append((
                                "collect", tc_w,
                                (time.perf_counter() - tc0) * 1000,
                                None,
                            ))
                        self._stamp_spans(batch, spans)
                except BaseException as e:
                    if not self._absorb_device_loss(e):
                        raise
                    # device lost under a synchronous caller: retry
                    # once on the pure host route
                    pq = submit(
                        keys, lo, hi, t0s, t1s, now=now,
                        owner_ids=owners, host_route=True,
                    )
                    used_device = False
                    results = self._table.query_many_collect(pq)
            else:
                results = self._table.query_many(
                    keys, lo, hi, t0s, t1s, now=now, owner_ids=owners,
                    host_route=host_route,
                )
                if traced:
                    self._stamp_spans(batch, [plan_span, (
                        "host.scan", t0_w,
                        (time.perf_counter() - t0) * 1000, None,
                    )])
            if used_device is not None:
                total_ms = (time.perf_counter() - t0) * 1000
                with self._slock:
                    if used_device:
                        self._cost.observe_device(b, total_ms)
                    elif host_route or b >= self._cost.chunk:
                        self._cost.observe_host(b, total_ms)
            self._deliver_results(batch, results)
        except BaseException as e:  # noqa: BLE001 — deliver to callers
            self._deliver_error(batch, e)

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        """Serving-pipeline gauges (flow into /metrics via the index's
        stats): queue depth, adaptive batch size, per-stage time
        totals, shed count."""
        with self._cond:
            out = {
                "co_queue_depth": len(self._queue),
                "co_queue_cap": self._max_queue,
                "co_inflight": self._inflight,
                "co_inflight_items": self._inflight_items,
                "co_batch_size": self._ctl.cur,
                "co_batch_grows": self._ctl.grows,
                "co_batch_shrinks": self._ctl.shrinks,
                "co_slo_ms": self._slo_ms,
            }
        with self._slock:
            out.update(
                co_batches=self._stat_batches,
                co_items=self._stat_items,
                co_inline=self._stat_inline,
                co_shed=self._stat_shed,
                co_deadline_shed=self._stat_deadline_shed,
                co_route_host_batches=self._stat_route_host,
                co_route_hostchunk_batches=self._stat_route_hostchunk,
                co_route_device_batches=self._stat_route_device,
                co_route_resident_batches=self._stat_route_resident,
                co_device_loss_absorbed=self._stat_device_loss_absorbed,
                co_device_ok=int(self._device_ok()),
                co_pack_ms_total=round(self._stat_pack_ms, 3),
                co_device_ms_total=round(self._stat_device_ms, 3),
                co_collect_ms_total=round(self._stat_collect_ms, 3),
                co_last_batch=self._stat_last_batch,
                co_ema_qps=round(self._ema_qps, 1),
                # live cost-model estimates (the router's inputs);
                # the resident floor is its OWN key — see _CostModel
                co_est_device_floor_ms=round(self._cost.est_floor_ms, 4),
                co_est_device_item_ms=round(self._cost.est_item_ms, 5),
                co_est_host_chunk_ms=round(self._cost.est_chunk_ms, 4),
                co_est_resident_floor_ms=round(
                    self._cost.est_res_floor_ms, 4
                ),
                co_est_resident_lat_ms=round(
                    self._cost.est_res_lat_ms, 4
                ),
            )
        # resident-loop gauges: stable key set whether or not the loop
        # is attached.  The co_res_aot_* names are the reference's; here
        # they count captured-graph entries (hits, misses, entries, build
        # time), and co_res_graph_* adds what graphs have and
        # executables do not (busy entries, graphs captured, captures
        # that failed)
        if self._res_loop is not None:
            rs = self._res_loop.stats()
        else:
            rs = {
                "ring_depth": 0, "ring_cap": 0, "inflight": 0,
                "enqueued": 0, "rejected": 0, "graph_hits": 0,
                "graph_misses": 0, "graph_buckets": 0, "graph_busy": 0,
                "graph_captures": 0, "graph_capture_failures": 0,
                "graph_capture_ms_total": 0.0,
            }
        out.update(
            co_res_ring_depth=rs["ring_depth"],
            co_res_ring_cap=rs["ring_cap"],
            co_res_inflight=rs["inflight"],
            co_res_enqueued=rs["enqueued"],
            co_res_rejected=rs["rejected"],
            co_res_aot_hits=rs["graph_hits"],
            co_res_aot_misses=rs["graph_misses"],
            co_res_aot_buckets=rs["graph_buckets"],
            co_res_aot_compile_ms_total=rs["graph_capture_ms_total"],
            co_res_graph_busy=rs["graph_busy"],
            co_res_graph_captures=rs["graph_captures"],
            co_res_graph_capture_failures=rs["graph_capture_failures"],
        )
        # planner decision mix (co_plan_*): how often each of the six
        # routes was the chosen plan — the cache row is filled from
        # the read-cache view below (a hit IS a plan, chosen before
        # this pipeline ever sees the query)
        out.update(self._planner.stats())
        # per-class read-cache counters (co_cache_*): stable key set so
        # the /metrics series exist on every deployment
        view = self._cache_view
        if view is not None:
            out.update(view())
        else:
            out.update(
                co_cache_hits=0, co_cache_misses=0,
                co_cache_invalidations=0,
            )
        hits = int(out.get("co_cache_hits", 0) or 0)
        out["co_plan_cache"] += hits
        out["co_plan_total"] += hits
        out["mesh_offloads"] = self.mesh_offloads
        return out

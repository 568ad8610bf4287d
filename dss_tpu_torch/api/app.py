"""The REST application: routes, auth enforcement, error mapping.

Route surface mirrors the reference's REST bindings:
  RID  (rid.proto:527-630):  /v1/dss/identification_service_areas,
                             /v1/dss/subscriptions
  SCD  (scd.proto:602-716):  /dss/v1/{operation_references,
                             subscriptions, constraint_references,
                             reports}
  Aux  (aux_service.proto):  /aux/v1/validate_oauth
  plus /healthy (cmds/http-gateway/main.go:82-90).

Error mapping follows myCodeToHTTPStatus/myHTTPError
(cmds/http-gateway/main.go:102-237): StatusError -> JSON
{error, message, code}; MISSING_OVNS -> HTTP 409 whose body is the
AirspaceConflictResponse itself; AREA_TOO_LARGE -> HTTP 413.

Scope tables mirror pkg/rid/server/server.go:34-49,
pkg/scd/server.go:58-76, pkg/aux_/server.go:17-21.

A copy of the reference's `dss_tpu/api/app.py`, the shm front's read-
worker proxy included.  What the port does not have yet raises
`NotImplementedError` naming its slice when it is asked for: a
federation router (federation slice).  Without it the reference's
federation branches are no-ops, so they are left out here.  Inline
reads follow `native.available()` (`_native_ready`), and
`/debug/profile` records a `torch.profiler` Chrome trace where the
reference records a JAX trace.
"""

from __future__ import annotations

import asyncio
import functools
import json
import math
import time
from typing import Optional

from aiohttp import web

from dss_tpu_torch import errors
from dss_tpu_torch.auth.authorizer import (
    Authorizer,
    require_all_scopes,
    require_any_scope,
)

RID_READ = "dss.read.identification_service_areas"
RID_WRITE = "dss.write.identification_service_areas"
SCD_SC = "utm.strategic_coordination"
SCD_CM = "utm.constraint_management"
SCD_CC = "utm.constraint_consumption"

_RID = "/ridpb.DiscoveryAndSynchronizationService/"
_SCD = "/scdpb.UTMAPIUSSDSSAndUSSUSSService/"
_AUX = "/auxpb.DSSAuxService/"

RID_SCOPES = {
    _RID + "CreateIdentificationServiceArea": require_all_scopes(RID_WRITE),
    _RID + "UpdateIdentificationServiceArea": require_all_scopes(RID_WRITE),
    _RID + "DeleteIdentificationServiceArea": require_all_scopes(RID_WRITE),
    _RID + "GetIdentificationServiceArea": require_all_scopes(RID_READ),
    _RID + "SearchIdentificationServiceAreas": require_all_scopes(RID_READ),
    _RID + "CreateSubscription": require_all_scopes(RID_WRITE),
    _RID + "UpdateSubscription": require_all_scopes(RID_WRITE),
    _RID + "DeleteSubscription": require_all_scopes(RID_WRITE),
    _RID + "GetSubscription": require_all_scopes(RID_READ),
    _RID + "SearchSubscriptions": require_all_scopes(RID_READ),
    _AUX + "ValidateOauth": require_all_scopes(RID_WRITE),
    _AUX + "DebugProfile": require_all_scopes(RID_WRITE),
    _AUX + "DebugTraces": require_all_scopes(RID_WRITE),
    # cross-region federation peer surface: any read scope may query;
    # sync ships full state, so it demands a read scope too
    _AUX + "FederationQuery": require_any_scope(
        RID_READ, SCD_SC, SCD_CC, SCD_CM
    ),
    _AUX + "FederationSync": require_any_scope(
        RID_READ, SCD_SC, SCD_CC, SCD_CM
    ),
    # push-pipeline surface (dss_tpu/push): a USS manages its own
    # webhook registration with any write scope; status is a read;
    # ingest is the cross-region peer hop (same trust as federation)
    _AUX + "PushPutHook": require_any_scope(
        RID_WRITE, SCD_SC, SCD_CC, SCD_CM
    ),
    _AUX + "PushStatus": require_any_scope(
        RID_READ, SCD_SC, SCD_CC, SCD_CM
    ),
    _AUX + "PushIngest": require_any_scope(
        RID_READ, SCD_SC, SCD_CC, SCD_CM
    ),
}

SCD_SCOPES = {
    _SCD + "PutOperationReference": require_any_scope(SCD_SC),
    _SCD + "GetOperationReference": require_any_scope(SCD_SC),
    _SCD + "DeleteOperationReference": require_any_scope(SCD_SC),
    _SCD + "SearchOperationReferences": require_any_scope(SCD_SC),
    _SCD + "PutSubscription": require_any_scope(SCD_SC, SCD_CC),
    _SCD + "GetSubscription": require_any_scope(SCD_SC, SCD_CC),
    _SCD + "DeleteSubscription": require_any_scope(SCD_SC, SCD_CC),
    _SCD + "QuerySubscriptions": require_any_scope(SCD_SC, SCD_CC),
    _SCD + "PutConstraintReference": require_any_scope(SCD_CM),
    _SCD + "GetConstraintReference": require_any_scope(SCD_SC, SCD_CC, SCD_CM),
    _SCD + "DeleteConstraintReference": require_any_scope(SCD_CM),
    _SCD + "QueryConstraintReferences": require_any_scope(
        SCD_SC, SCD_CC, SCD_CM
    ),
    _SCD + "MakeDssReport": require_any_scope(SCD_SC, SCD_CC, SCD_CM),
    _AUX + "ReplicaSearchOperations": require_any_scope(SCD_SC),
}


def _error_response(e: errors.StatusError) -> web.Response:
    if e.code == errors.Code.MISSING_OVNS:
        # special 409 schema: the body IS the AirspaceConflictResponse
        # (cmds/http-gateway/main.go:187-200)
        body = e.details or {"message": e.message}
        return web.json_response(body, status=e.http_status)
    headers = None
    retry_after = getattr(e, "retry_after_s", None)
    if retry_after is not None:
        # overload shed (429): tell the client when the queue should
        # have drained; well-behaved USS clients back off accordingly
        headers = {"Retry-After": str(max(1, math.ceil(retry_after)))}
    return web.json_response(
        {"error": e.message, "message": e.message, "code": int(e.code)},
        status=e.http_status,
        headers=headers,
    )


@web.middleware
async def error_middleware(request, handler):
    try:
        return await handler(request)
    except errors.StatusError as e:
        return _error_response(e)
    except web.HTTPException:
        raise
    except Exception as e:  # noqa: BLE001 — normalize to the error schema
        return _error_response(errors.internal(str(e)))


def make_trace_middleware(verbose: bool = True):
    """Per-request tracing (the reference's --trace-requests analog,
    pkg/logging/http.go:36-55, upgraded twice): assigns/propagates an
    X-Request-Id AND a W3C traceparent — the trace id IS the request
    id — opens the request's root span when the trace subsystem is
    active (obs/trace.py: head-sampled, tail-captured past
    DSS_TRACE_SLOW_MS), and returns both headers on every response,
    errors included, so one id greps across every process log of the
    front.  `verbose` additionally emits the X-Dss-Stages breakdown
    header (--trace_requests)."""
    import uuid as _uuid

    from dss_tpu_torch.obs import trace as _trace

    def _root_name(request) -> str:
        resource = (
            request.match_info.route.resource
            if request.match_info is not None
            else None
        )
        route = (
            resource.canonical if resource is not None else "(unmatched)"
        )
        return f"http {request.method} {route}"

    @web.middleware
    async def trace_middleware(request, handler):
        ctx = _trace.new_trace(
            request.headers.get("traceparent"),
            request.headers.get("X-Request-Id"),
        )
        # a caller-SUPPLIED id is echoed verbatim (USS operators
        # correlate by exact match of their own id); only minted ids
        # are the trace id itself.  A supplied id still maps onto the
        # trace deterministically (trace_id_from_request_id), and the
        # traceparent header carries the canonical trace id either way.
        rid = request.headers.get("X-Request-Id") or (
            ctx.trace_id if ctx is not None else _uuid.uuid4().hex[:16]
        )
        request["dss_trace"] = {"request_id": rid, "ctx": ctx}
        t0 = time.perf_counter()
        status = 500
        try:
            resp = await handler(request)
            status = resp.status
        except web.HTTPException as e:
            # error responses are the ones operators most need to
            # correlate — tag them too
            status = e.status
            e.headers["X-Request-Id"] = rid
            if ctx is not None:
                e.headers["traceparent"] = _trace.format_traceparent(
                    ctx.trace_id, ctx.root_span_id, ctx.sampled
                )
            raise
        finally:
            _trace.finish_root(
                ctx, _root_name(request),
                (time.perf_counter() - t0) * 1000.0,
                status=status,
            )
        resp.headers["X-Request-Id"] = rid
        if ctx is not None:
            resp.headers["traceparent"] = _trace.format_traceparent(
                ctx.trace_id, ctx.root_span_id, ctx.sampled
            )
        stages = request.get("dss_stages")
        if verbose and stages:
            # machine-readable per-stage breakdown for callers
            # (benchmarks, USS operators correlating latency)
            resp.headers["X-Dss-Stages"] = ";".join(
                f"{k}={v}" for k, v in sorted(stages.items())
            )
        return resp

    return trace_middleware


def _trace_handle(request):
    """The request's root-span trace handle (or None): what _call
    installs on the executor thread so service-layer spans parent
    under this request."""
    from dss_tpu_torch.obs import trace as _trace

    tr = request.get("dss_trace") if request is not None else None
    ctx = tr.get("ctx") if tr else None
    if ctx is None or not ctx.recording:
        return None
    return _trace.SpanHandle(ctx, ctx.root_span_id)


def make_timeout_middleware(timeout_s: float):
    """Per-request deadline (the reference's 10 s default RPC timeout,
    cmds/grpc-backend/main.go:48): a handler that exceeds it gets a 504
    DEADLINE_EXCEEDED and releases the connection.  The abandoned
    executor call keeps running to completion in its worker thread
    (same abandonment semantics as a Go ctx deadline firing while the
    SQL round trip is in flight); /healthy is exempt so orchestration
    probes never queue behind a wedged store."""

    # asyncio.timeout cancels in-place (no extra task per request,
    # unlike wait_for); async_timeout is the same shape for
    # Python < 3.11.  Resolved once here so a missing async_timeout
    # wheel fails at startup, not per-request at serve time.
    timeout_ctx = getattr(asyncio, "timeout", None)
    if timeout_ctx is None:
        import async_timeout

        timeout_ctx = async_timeout.timeout

    @web.middleware
    async def timeout_middleware(request, handler):
        # /debug/profile deliberately runs longer than any deadline
        if request.path in ("/healthy", "/debug/profile"):
            return await handler(request)
        # absolute per-request deadline for the serving stack: the
        # query coalescer caps its SLO-derived item deadlines with it
        # (_call installs it on the worker thread via dar/deadline.py)
        request["dss_deadline"] = time.monotonic() + timeout_s
        try:
            async with timeout_ctx(timeout_s):
                return await handler(request)
        except (TimeoutError, asyncio.TimeoutError):
            return _error_response(
                errors.deadline_exceeded(
                    f"request exceeded the {timeout_s:g}s deadline"
                )
            )

    return timeout_middleware


async def _call(fn, *args, request=None):
    """Run a synchronous service call off the event loop.  The service
    layer holds the store lock and may run multi-ms device work (first
    call: the kernels' nvcc build); keeping it off the loop lets
    other requests (and /healthy) proceed — the goroutine-per-RPC
    analog of grpc-go.  When `request` is given, the per-stage sink is
    installed on the worker thread so service code's covering/store/
    serialize timings land in the request's stage breakdown."""
    from dss_tpu_torch.dar import deadline as _deadline
    from dss_tpu_torch.dar import readcache as _readcache
    from dss_tpu_torch.obs import stages as _stages
    from dss_tpu_torch.obs import trace as _trace

    loop = asyncio.get_running_loop()
    sink = None if request is None else request.get("dss_stages")
    route_dl = None if request is None else request.get("dss_deadline")
    th = _trace_handle(request)
    t0 = time.perf_counter()

    def run():
        if sink is not None:
            _stages.set_sink(sink)
        if route_dl is not None:
            _deadline.set_route_deadline(route_dl)
        try:
            # trace handoff to the executor thread: a "service" span
            # under the request root; everything the service layer
            # opens (covering/store/serialize stages, cache lookups,
            # coalescer batch spans) parents under it
            with _trace.use(th), _trace.span("service"):
                return fn(*args)
        finally:
            # the store's search path left its freshness note on THIS
            # thread (readcache thread-local); hand it to the handler
            # for the X-DSS-Freshness response header.  take_ always
            # clears, so a pooled worker never leaks a note across
            # requests.
            note = _readcache.take_note()
            if request is not None and note is not None:
                request["dss_freshness"] = note
            if sink is not None:
                _stages.set_sink(None)
            if route_dl is not None:
                _deadline.set_route_deadline(None)

    try:
        return await loop.run_in_executor(None, run)
    finally:
        if sink is not None:
            sink["service_ms"] = round(
                (time.perf_counter() - t0) * 1000, 3
            )


async def _call_r(request, fn, *args):
    """Handler-side _call: threads the request through for tracing."""
    return await _call(fn, *args, request=request)


def _freshness_json_response(request, data) -> web.Response:
    """json_response carrying the X-DSS-Freshness header when the
    service call left a note: region epoch + DAR write generation +
    cache hit/miss, so operators can verify the version fence from
    the wire without reading code.  When the store's degradation
    ladder is non-healthy the header additionally carries
    `;mode=<condition>` — a degraded answer (hostchunk-only serving,
    fenced-cache reads during a region outage) is honest about it.
    (The reference adds federation provenance here; the port has no
    federation yet.)"""
    note = request.get("dss_freshness")
    headers = None
    if note is not None:
        val = (
            f"epoch={note['epoch'] or '-'};"
            f"class={note['cls']};gen={note['gen']};"
            f"cache={'hit' if note['hit'] else 'miss'}"
        )
        mode = None
        health_fn = request.app.get("dss_health_fn")
        if health_fn is not None:
            try:
                mode = health_fn()
            except Exception:  # noqa: BLE001 — header is best-effort
                mode = None
            if mode == "healthy":
                mode = None
        if mode:
            val += f";mode={mode}"
        headers = {"X-DSS-Freshness": val}
    return web.json_response(data, headers=headers)


# dict-valued store stats render as labeled gauge families; the label
# name is per-metric (everything else is the shard family)
_GAUGE_VEC_LABELS = {
    "dss_breaker_state": "remote",
    "dss_fault_injected_total": "site",
    "dss_fed_peer_state": "region",
    "dss_fed_mirror_lag_s": "region",
    "dss_push_breaker_state": "uss",
    # self-tuning knob families (dss_tpu/tune): active vs proposed
    # values per hot-swappable knob — the Grafana tuner panel diffs
    # the two series
    "dss_tune_knob_active": "knob",
    "dss_tune_knob_proposed": "knob",
    # shared-memory front per-worker counters (parallel/shmring.py):
    # the leader aggregates every worker's shm stats block so ONE
    # scrape sees the whole front, keyed by the worker's process id
    **{
        f"dss_shm_worker_{name}": "process"
        for name in (
            "enqueued", "served", "cache_hits", "cache_misses",
            "ring_full", "timeouts", "oversize", "proxy_fallbacks",
            "assembly_misses", "errors", "plan_shm", "plan_proxy",
        )
    },
}


# Routes a read-worker serves from its local WAL-tail replica; every
# other route is proxied to the write leader.  Searches are the hot
# path and inherently scan-like (bounded staleness = the follower poll
# interval, same contract as a region-mode non-writing instance);
# point reads and all mutations go to the leader for freshness.
WORKER_LOCAL_ROUTES = {
    ("GET", "/healthy"),
    ("GET", "/metrics"),
    ("GET", "/status"),
    # the trace flight recorder is PER PROCESS by design: the worker
    # serving this connection answers with its own recorder (the
    # stitched ring trace lives worker-side), never proxied
    ("GET", "/aux/v1/debug/traces"),
    ("GET", "/aux/v1/validate_oauth"),
    ("GET", "/v1/dss/identification_service_areas"),
    ("GET", "/v1/dss/subscriptions"),
    ("POST", "/dss/v1/operation_references/query"),
    ("POST", "/dss/v1/subscriptions/query"),
    ("POST", "/dss/v1/constraint_references/query"),
    # NOTE: the federation peer surface is deliberately NOT here —
    # worker-reader mode refuses --federation_map outright
    # (cmds/server.py): a worker's plain WAL-tail replica would serve
    # cross-region coverings partially.
}

_PROXY_SKIP_HEADERS = {
    "host", "content-length", "transfer-encoding", "connection",
}


def make_worker_proxy_middleware(leader_url: str, follower=None,
                                 costs=None):
    """Read-worker request routing: local serving for searches, proxy
    to the leader for everything else.  After a successful proxied
    mutation the worker waits (bounded) for its replica to reach the
    leader's WAL seq — read-your-writes for clients that keep their
    connection (and thus this worker) across a write->search flow.

    With the shared-memory front attached, a locally-served search
    that cannot ride the ring (ring full, owner dead, oversized
    payload, injected `shm.ring.enqueue` fault) raises ShmFallback —
    caught HERE and re-served over the loopback proxy, so ring
    saturation degrades to the old proxy cost instead of blocking or
    erroring.  `costs` (the front's WorkerCostModel) observes the
    measured proxy round trip of each such fallback search, so the
    shm-vs-proxy price comparison learns the REAL loopback cost
    instead of trusting the DSS_SHM_PROXY_MS seed forever."""
    import aiohttp as _aiohttp

    from dss_tpu_torch.dar.shmfront import ShmFallback

    session: dict = {}

    async def _get_session():
        if "s" not in session:
            session["s"] = _aiohttp.ClientSession(
                timeout=_aiohttp.ClientTimeout(total=60)
            )
        return session["s"]

    @web.middleware
    async def worker_proxy(request, handler):
        resource = (
            request.match_info.route.resource
            if request.match_info is not None
            else None
        )
        canonical = resource.canonical if resource is not None else None
        fell_back = False
        if (request.method, canonical) in WORKER_LOCAL_ROUTES:
            try:
                return await handler(request)
            except ShmFallback:
                fell_back = True  # loopback proxy below
        sess = await _get_session()
        body = await request.read()
        t0 = time.perf_counter()
        t0_w = time.time_ns()
        headers = {
            k: v
            for k, v in request.headers.items()
            if k.lower() not in _PROXY_SKIP_HEADERS
        }
        # propagate THIS hop's trace identity instead of minting a
        # fresh id leader-side: the worker's trace middleware already
        # resolved/minted the id, and the loopback hop must carry it
        # (one grep-able id across worker AND leader access logs)
        from dss_tpu_torch.obs import trace as _trace

        tr = request.get("dss_trace")
        if tr is not None:
            headers["X-Request-Id"] = tr["request_id"]
            ctx = tr.get("ctx")
            if ctx is not None:
                headers["traceparent"] = _trace.format_traceparent(
                    ctx.trace_id, ctx.root_span_id, ctx.sampled
                )
        try:
            async with sess.request(
                request.method,
                leader_url + request.path_qs,
                data=body,
                headers=headers,
            ) as upstream:
                payload = await upstream.read()
                seq = upstream.headers.get("X-Dss-Wal-Seq")
        except (_aiohttp.ClientError, asyncio.TimeoutError) as e:
            return _error_response(
                errors.unavailable(f"write leader unreachable: {e}")
            )
        proxy_ms = (time.perf_counter() - t0) * 1000.0
        sink = request.get("dss_stages")
        if sink is not None:
            sink["proxy_ms"] = round(
                sink.get("proxy_ms", 0.0) + proxy_ms, 3
            )
        th = _trace_handle(request)
        if th is not None:
            _trace.add_span(
                th, "proxy", t0_w, proxy_ms,
                attrs={"fallback": fell_back},
            )
        if fell_back and costs is not None:
            # a fallback-proxied SEARCH is the exact request shape the
            # ring would have served — feed its measured round trip to
            # the worker cost model (writes/other routes would skew it)
            costs.observe_proxy(proxy_ms)
        if (
            follower is not None
            and seq
            and request.method in ("PUT", "DELETE", "POST")
            and upstream.status < 400
        ):
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, functools.partial(follower.wait_for, int(seq), 1.0)
            )
        return web.Response(
            body=payload,
            status=upstream.status,
            content_type=upstream.content_type,
        )

    async def close_session(app):
        if "s" in session:
            await session["s"].close()

    worker_proxy.on_cleanup = close_session
    return worker_proxy


def make_wal_seq_middleware(wal_seq_fn):
    """Leader-side: stamp the current WAL seq on successful mutation
    responses so read workers can wait for their replica to catch up
    (read-your-writes across the proxy)."""

    @web.middleware
    async def wal_seq(request, handler):
        resp = await handler(request)
        if request.method in ("PUT", "DELETE", "POST") and resp.status < 400:
            resp.headers["X-Dss-Wal-Seq"] = str(wal_seq_fn())
        return resp

    return wal_seq


def _native_ready() -> bool:
    """Whether the native host halves (covering, window pack, host
    query) are loaded.  Without them a search can fall back to a
    multi-ms numpy covering, so inline reads stay on the executor."""
    try:
        from dss_tpu_torch import native

        return native.available()
    except Exception:  # pragma: no cover
        return False


async def _params(request) -> dict:
    if request.method in ("GET", "DELETE"):
        return {}
    try:
        body = await request.text()
        params = json.loads(body) if body else {}
    except ValueError as e:
        raise errors.bad_request(f"malformed request body: {e}")
    if not isinstance(params, dict):
        raise errors.bad_request("request body must be a JSON object")
    return params


def build_app(
    rid_service=None,
    scd_service=None,
    authorizer: Optional[Authorizer] = None,
    *,
    enable_scd: bool = True,
    metrics=None,
    dump_requests: bool = False,
    stats_fn=None,
    status_fn=None,  # freshness introspection: DSSStore.freshness_status
    health_fn=None,  # degradation mode: DSSStore.health.mode_name
    default_timeout_s: float = 10.0,
    replica=None,  # ShardedOpReplica: multi-chip read-replica surface
    federation=None,  # FederationRouter: the federation slice (raises)
    push=None,  # PushPipeline: webhook registry + ingest surface
    trace_requests: bool = False,
    profile_dir: str = "",
    worker_proxy=None,  # read-worker mode: proxy middleware to leader
    wal_seq_fn=None,  # leader mode: stamp WAL seq on mutations
    inline_reads: bool = False,  # run read handlers on the event loop
) -> web.Application:
    from dss_tpu_torch.obs.logging import make_access_log_middleware

    if federation is not None:
        errors.later_slice("the federation peer surface", "federation")
    middlewares = [
        make_access_log_middleware(
            metrics, dump_requests=dump_requests, health_fn=health_fn
        ),
        # id propagation + the trace root span are ALWAYS on (near-
        # zero cost while DSS_TRACE_* is unset); --trace_requests only
        # adds the verbose X-Dss-Stages response header
        make_trace_middleware(verbose=trace_requests),
    ]
    if default_timeout_s and default_timeout_s > 0:
        middlewares.append(make_timeout_middleware(default_timeout_s))
    middlewares.append(error_middleware)
    if wal_seq_fn is not None:
        middlewares.append(make_wal_seq_middleware(wal_seq_fn))
    if worker_proxy is not None:
        # innermost: local-read routes fall through to handlers, the
        # rest forward to the leader (already wrapped by log/deadline)
        middlewares.append(worker_proxy)
    app = web.Application(middlewares=middlewares)
    # where each READ handler ran: on the event loop (inline), re-run
    # on the executor after an inline attempt raised NeedsDevice, or on
    # the executor from the start.  The server logs it at shutdown.
    read_routes = {"inline": 0, "rerun": 0, "executor": 0}
    app["dss_read_routes"] = read_routes
    if worker_proxy is not None and hasattr(worker_proxy, "on_cleanup"):
        app.on_cleanup.append(worker_proxy.on_cleanup)
    if health_fn is not None:
        # the degradation-ladder mode: read by _freshness_json_response
        # so degraded answers carry `;mode=...` in X-DSS-Freshness
        app["dss_health_fn"] = health_fn

    async def _call_read(request, fn, *args):
        """Service call for READ handlers.  With inline_reads (single-
        core hosts), runs directly on the event loop: reads are
        lock-free against the immutable store state and take ~0.3 ms,
        so on one core the two executor handoffs are pure overhead.

        Inline execution is OPTIMISTIC under a host-only budget: any
        path that would dispatch to the device, trigger a kernel
        build, or block behind another thread's batch raises
        NeedsDevice, and the (pure) read re-runs on the executor —
        the loop never stalls on device work.  Multi-core deployments
        keep the executor throughout."""
        if not inline_reads or not _native_ready():
            # without the native covering kernel a search can fall back
            # to a multi-ms numpy BFS — keep that off the event loop
            read_routes["executor"] += 1
            return await _call(fn, *args, request=request)
        from dss_tpu_torch.dar import budget as _budget
        from dss_tpu_torch.dar import deadline as _deadline
        from dss_tpu_torch.dar import readcache as _readcache
        from dss_tpu_torch.obs import stages as _stages
        from dss_tpu_torch.obs import trace as _trace

        sink = request.get("dss_stages")
        before = None if sink is None else dict(sink)
        route_dl = request.get("dss_deadline")
        th = _trace_handle(request)
        t0 = time.perf_counter()
        if sink is not None:
            _stages.set_sink(sink)
        if route_dl is not None:
            _deadline.set_route_deadline(route_dl)
        _budget.set_host_only(True)
        # clear any stale freshness note on the loop thread: a prior
        # request that escalated to the executor mid-note must not
        # donate its note to this one (first-wins would keep it)
        _readcache.take_note()
        try:
            with _trace.use(th), _trace.span("service"):
                out = fn(*args)
            read_routes["inline"] += 1
            return out
        except _budget.NeedsDevice:
            read_routes["rerun"] += 1
            if sink is not None:
                # drop the aborted inline attempt's partial stage
                # timings — the executor re-run records the real ones
                sink.clear()
                sink.update(before)
            # drop the aborted attempt's note BEFORE awaiting: the
            # executor re-run stashes the real one, other inline
            # requests may interleave during the await, and the
            # finally below must find this thread's slot empty
            _readcache.take_note()
            return await _call(fn, *args, request=request)
        finally:
            _budget.set_host_only(False)
            note = _readcache.take_note()
            if note is not None:
                request["dss_freshness"] = note
            if sink is not None:
                _stages.set_sink(None)
                sink["service_ms"] = round(
                    (time.perf_counter() - t0) * 1000, 3
                )
            if route_dl is not None:
                _deadline.set_route_deadline(None)

    def auth(request, operation: str) -> str:
        """-> owner.  No authorizer configured (unit harness) -> anon."""
        if authorizer is None:
            return "anonymous"
        t0 = time.perf_counter()
        t0_w = time.time_ns()
        try:
            owner = authorizer.authorize(
                request.headers.get("Authorization"), operation
            )
        finally:
            auth_ms = (time.perf_counter() - t0) * 1000
            sink = request.get("dss_stages")
            if sink is not None:
                sink["auth_ms"] = round(auth_ms, 3)
            th = _trace_handle(request)
            if th is not None:
                from dss_tpu_torch.obs import trace as _trace

                _trace.add_span(th, "auth_ms", t0_w, auth_ms)
        request["dss_owner"] = owner
        return owner

    # -- health + metrics (no auth) ------------------------------------------

    async def healthy(request):
        return web.Response(text="ok")

    app.router.add_get("/healthy", healthy)

    async def status(request):
        """Freshness introspection (no auth, like /healthy): region
        epoch, per-class DAR write generation + cell-clock high-water
        mark, and read-cache counters — the operator's view of the
        version fence (docs/SERVING.md)."""
        if status_fn is None:
            return web.json_response({"ok": True})
        return web.json_response(await _call_r(request, status_fn))

    app.router.add_get("/status", status)

    async def debug_traces(request):
        """The per-process trace flight recorder as span-tree JSON:
        kept traces (head-sampled + tail-captured slow ones), newest
        last, plus the recorder counters.  ?trace_id= narrows to one
        trace; ?limit=N bounds the response.  Worker-local: each
        process of a front answers with its OWN recorder — the
        stitched worker->owner trace lives on the worker that served
        the request."""
        from dss_tpu_torch.obs import trace as _trace

        auth(request, _AUX + "DebugTraces")
        tid = request.query.get("trace_id", "")
        if tid:
            found = _trace.recorder().find(tid.strip().lower())
            return web.json_response({
                "traces": [found] if found is not None else [],
                "stats": _trace.stats(),
            })
        try:
            limit = int(request.query.get("limit", 0))
        except ValueError:
            raise errors.bad_request("bad limit param")
        return web.json_response({
            "traces": _trace.recorder().traces(limit=limit),
            "stats": _trace.stats(),
        })

    app.router.add_get("/aux/v1/debug/traces", debug_traces)

    if metrics is not None:

        async def metrics_handler(request):
            if stats_fn is not None:
                # stats take the store lock (writers hold it across
                # device work) — keep the event loop free
                stats = await _call_r(request, stats_fn)
                for name, val in stats.items():
                    if isinstance(val, dict):
                        # keyed gauge families — dss_shard_load{shard},
                        # dss_breaker_state{remote},
                        # dss_fault_injected_total{site}
                        metrics.set_gauge_vec(
                            name,
                            _GAUGE_VEC_LABELS.get(name, "shard"),
                            val,
                        )
                    else:
                        metrics.set_gauge(name, val)
            return web.Response(
                text=metrics.render(),
                content_type="text/plain",
            )

        app.router.add_get("/metrics", metrics_handler)

    # -- aux -----------------------------------------------------------------

    async def validate_oauth(request):
        owner = auth(request, _AUX + "ValidateOauth")
        want = request.query.get("owner", "")
        if want and want != owner:
            raise errors.permission_denied(
                f"owner mismatch, required: {want}, "
                f"but oauth token has {owner}"
            )
        return web.json_response({})

    app.router.add_get("/aux/v1/validate_oauth", validate_oauth)

    if profile_dir:
        # opt-in device profiling (the reference's Cloud-Profiler
        # --gcp_prof_service_name analog, grpc-backend main.go:235-241):
        # POST /debug/profile?seconds=N records a torch.profiler trace
        # (host ops, and CUDA kernels and copies on a card) while live
        # traffic keeps flowing, and writes it into profile_dir as a
        # Chrome trace; view it in Perfetto or chrome://tracing
        import concurrent.futures as _futures
        import os as _os
        import threading as _threading

        profile_lock = _threading.Lock()
        # dedicated executor: a 60 s capture must not occupy a slot of
        # the shared pool that runs store-locked service calls
        profile_pool = _futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dss-profile"
        )

        async def debug_profile(request):
            auth(request, _AUX + "DebugProfile")
            try:
                seconds = float(request.query.get("seconds", 3.0))
            except ValueError:
                raise errors.bad_request("bad seconds param")
            if not (0.0 < seconds <= 60.0):  # also rejects NaN
                raise errors.bad_request(
                    "seconds must be in (0, 60]"
                )
            if not profile_lock.acquire(blocking=False):
                raise errors.unavailable("a profile capture is running")

            def capture():
                try:
                    import torch
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        acts.append(ProfilerActivity.CUDA)
                    with profile(activities=acts) as prof:
                        time.sleep(seconds)
                    _os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(_os.path.join(
                        profile_dir, f"dss-profile-{time.time_ns()}.json"
                    ))
                finally:
                    profile_lock.release()

            await asyncio.get_running_loop().run_in_executor(
                profile_pool, capture
            )
            return web.json_response(
                {"profile_dir": profile_dir, "seconds": seconds}
            )

        app.router.add_post("/debug/profile", debug_profile)

    if push is not None:
        # the push-pipeline surface (dss_tpu/push): webhook hook
        # registry (durable in the delivery WAL), operator status, and
        # the cross-region ingest hop federation forwards ride

        async def push_put_hook(request):
            owner = auth(request, _AUX + "PushPutHook")
            uss = request.match_info["uss"]
            if authorizer is not None and owner != uss:
                raise errors.permission_denied(
                    f"hook for {uss} may only be managed by {uss}"
                )
            params = await _params(request)
            url = params.get("url", "")
            if not url:
                raise errors.bad_request("missing required url")
            try:
                hook = push.register_hook(
                    uss, url, params.get("qos", "bulk")
                )
            except ValueError as e:
                raise errors.bad_request(str(e))
            return web.json_response({"uss": uss, **hook})

        async def push_delete_hook(request):
            owner = auth(request, _AUX + "PushPutHook")
            uss = request.match_info["uss"]
            if authorizer is not None and owner != uss:
                raise errors.permission_denied(
                    f"hook for {uss} may only be managed by {uss}"
                )
            return web.json_response(
                {"uss": uss, "removed": push.unregister_hook(uss)}
            )

        async def push_get_hooks(request):
            auth(request, _AUX + "PushStatus")
            return web.json_response({"hooks": push.hooks()})

        async def push_status(request):
            auth(request, _AUX + "PushStatus")
            return web.json_response(push.status())

        async def push_ingest(request):
            auth(request, _AUX + "PushIngest")
            payload = await _params(request)
            return web.json_response(
                await _call_r(
                    request,
                    functools.partial(push.ingest_remote, payload),
                )
            )

        app.router.add_put("/aux/v1/push/hooks/{uss}", push_put_hook)
        app.router.add_delete(
            "/aux/v1/push/hooks/{uss}", push_delete_hook
        )
        app.router.add_get("/aux/v1/push/hooks", push_get_hooks)
        app.router.add_get("/aux/v1/push/status", push_status)
        app.router.add_post("/aux/v1/push/ingest", push_ingest)

    if replica is not None:
        # the multi-chip read-replica surface (SURVEY §7 step 7): area
        # searches served from the ShardedDar snapshot the replica
        # tails out of the WAL / region log
        import time as _time

        from dss_tpu_torch.geo import covering as geo_covering
        from dss_tpu_torch.geo import s2cell as _s2
        from dss_tpu_torch.services import serialization as _ser

        def _now_ns_fn():
            return int(_time.time() * 1e9)

        # URL segment -> (replica class, auth operation, response key,
        # owner-scoped).  Subscription ids are owner-private: those
        # surfaces filter to the authenticated owner's entities, same
        # as the store search paths.
        replica_surfaces = {
            "operations": (
                "ops", _AUX + "ReplicaSearchOperations",
                "operation_ids", False,
            ),
            "identification_service_areas": (
                "isas",
                _RID + "SearchIdentificationServiceAreas",
                "service_area_ids", False,
            ),
            "subscriptions": (
                "rid_subs", _RID + "SearchSubscriptions",
                "subscription_ids", True,
            ),
            "scd_subscriptions": (
                "scd_subs", _SCD + "QuerySubscriptions",
                "subscription_ids", True,
            ),
            "constraints": (
                "constraints", _SCD + "QueryConstraintReferences",
                "constraint_ids", False,
            ),
        }

        async def replica_search(request):
            surface = replica_surfaces.get(request.match_info["surface"])
            if surface is None:
                raise errors.bad_request(
                    "unknown replica surface; one of: "
                    + ", ".join(sorted(replica_surfaces))
                )
            cls, operation, out_key, owner_scoped = surface
            owner = auth(request, operation)
            area = request.query.get("area", "")
            try:
                cells = geo_covering.area_to_cell_ids(area)
            except geo_covering.AreaTooLargeError as e:
                raise errors.area_too_large(str(e))
            except geo_covering.BadAreaError as e:
                raise errors.bad_request(str(e))
            keys = _s2.cell_to_dar_key(cells)

            def parse_t(name):
                raw = request.query.get(name, "")
                if not raw:
                    return None
                from dss_tpu_torch.clock import to_nanos

                try:
                    return to_nanos(_ser.parse_time(raw))
                except (ValueError, TypeError) as e:
                    raise errors.bad_request(f"bad {name}: {e}")

            def parse_f(name):
                raw = request.query.get(name, "")
                if not raw:
                    return None
                try:
                    return float(raw)
                except ValueError:
                    raise errors.bad_request(f"bad {name}: {raw!r}")

            ids = await _call_r(request,
                functools.partial(
                    replica.query,
                    keys,
                    parse_f("altitude_lo"),
                    parse_f("altitude_hi"),
                    parse_t("earliest_time"),
                    parse_t("latest_time"),
                    now=_now_ns_fn(),
                    cls=cls,
                    owner=owner if owner_scoped else None,
                )
            )
            return web.json_response(
                {out_key: ids, "replica": replica.stats()}
            )

        app.router.add_get(
            "/aux/v1/replica/{surface}", replica_search
        )

    # -- RID -----------------------------------------------------------------

    if rid_service is not None:
        rid = rid_service

        async def isa_create(request):
            owner = auth(request, _RID + "CreateIdentificationServiceArea")
            return web.json_response(
                await _call_r(request, rid.create_isa, 
                    request.match_info["id"], await _params(request), owner
                )
            )

        async def isa_update(request):
            owner = auth(request, _RID + "UpdateIdentificationServiceArea")
            return web.json_response(
                await _call_r(request, rid.update_isa, 
                    request.match_info["id"],
                    request.match_info["version"],
                    await _params(request),
                    owner,
                )
            )

        async def isa_delete(request):
            owner = auth(request, _RID + "DeleteIdentificationServiceArea")
            return web.json_response(
                await _call_r(request, rid.delete_isa, 
                    request.match_info["id"],
                    request.match_info["version"],
                    owner,
                )
            )

        async def isa_get(request):
            auth(request, _RID + "GetIdentificationServiceArea")
            return web.json_response(await _call_read(request, rid.get_isa, request.match_info["id"]))

        async def isa_search(request):
            auth(request, _RID + "SearchIdentificationServiceAreas")
            return _freshness_json_response(
                request,
                await _call_read(request, rid.search_isas,
                    request.query.get("area", ""),
                    request.query.get("earliest_time"),
                    request.query.get("latest_time"),
                ),
            )

        async def sub_create(request):
            owner = auth(request, _RID + "CreateSubscription")
            return web.json_response(
                await _call_r(request, rid.create_subscription, 
                    request.match_info["id"], await _params(request), owner
                )
            )

        async def sub_update(request):
            owner = auth(request, _RID + "UpdateSubscription")
            return web.json_response(
                await _call_r(request, rid.update_subscription, 
                    request.match_info["id"],
                    request.match_info["version"],
                    await _params(request),
                    owner,
                )
            )

        async def sub_delete(request):
            owner = auth(request, _RID + "DeleteSubscription")
            return web.json_response(
                await _call_r(request, rid.delete_subscription, 
                    request.match_info["id"],
                    request.match_info["version"],
                    owner,
                )
            )

        async def sub_get(request):
            auth(request, _RID + "GetSubscription")
            return web.json_response(
                await _call_read(request, rid.get_subscription, request.match_info["id"])
            )

        async def sub_search(request):
            owner = auth(request, _RID + "SearchSubscriptions")
            return _freshness_json_response(
                request,
                await _call_read(request, rid.search_subscriptions, request.query.get("area", ""), owner),
            )

        base = "/v1/dss/identification_service_areas"
        app.router.add_put(base + "/{id}", isa_create)
        app.router.add_put(base + "/{id}/{version}", isa_update)
        app.router.add_delete(base + "/{id}/{version}", isa_delete)
        app.router.add_get(base + "/{id}", isa_get)
        app.router.add_get(base, isa_search)
        sbase = "/v1/dss/subscriptions"
        app.router.add_put(sbase + "/{id}", sub_create)
        app.router.add_put(sbase + "/{id}/{version}", sub_update)
        app.router.add_delete(sbase + "/{id}/{version}", sub_delete)
        app.router.add_get(sbase + "/{id}", sub_get)
        app.router.add_get(sbase, sub_search)

    # -- SCD -----------------------------------------------------------------

    if scd_service is not None and enable_scd:
        scd = scd_service

        async def op_put(request):
            owner = auth(request, _SCD + "PutOperationReference")
            return web.json_response(
                await _call_r(request, scd.put_operation, 
                    request.match_info["entityuuid"],
                    await _params(request),
                    owner,
                )
            )

        async def op_get(request):
            owner = auth(request, _SCD + "GetOperationReference")
            return web.json_response(
                await _call_read(request, scd.get_operation, request.match_info["entityuuid"], owner)
            )

        async def op_delete(request):
            owner = auth(request, _SCD + "DeleteOperationReference")
            return web.json_response(
                await _call_r(request, scd.delete_operation, request.match_info["entityuuid"], owner)
            )

        async def op_query(request):
            owner = auth(request, _SCD + "SearchOperationReferences")
            return _freshness_json_response(
                request,
                await _call_read(request, scd.search_operations, await _params(request), owner),
            )

        async def scd_sub_put(request):
            owner = auth(request, _SCD + "PutSubscription")
            return web.json_response(
                await _call_r(request, scd.put_subscription, 
                    request.match_info["subscriptionid"],
                    await _params(request),
                    owner,
                )
            )

        async def scd_sub_get(request):
            owner = auth(request, _SCD + "GetSubscription")
            return web.json_response(
                await _call_r(request, scd.get_subscription, 
                    request.match_info["subscriptionid"], owner
                )
            )

        async def scd_sub_delete(request):
            owner = auth(request, _SCD + "DeleteSubscription")
            return web.json_response(
                await _call_r(request, scd.delete_subscription, 
                    request.match_info["subscriptionid"], owner
                )
            )

        async def scd_sub_query(request):
            owner = auth(request, _SCD + "QuerySubscriptions")
            return _freshness_json_response(
                request,
                await _call_read(request, scd.query_subscriptions, await _params(request), owner),
            )

        async def constraint_put(request):
            owner = auth(request, _SCD + "PutConstraintReference")
            return web.json_response(
                await _call_r(request, scd.put_constraint,
                    request.match_info["entityuuid"],
                    await _params(request),
                    owner,
                )
            )

        async def constraint_get(request):
            owner = auth(request, _SCD + "GetConstraintReference")
            return web.json_response(
                await _call_read(request, scd.get_constraint,
                    request.match_info["entityuuid"], owner
                )
            )

        async def constraint_delete(request):
            owner = auth(request, _SCD + "DeleteConstraintReference")
            return web.json_response(
                await _call_r(request, scd.delete_constraint,
                    request.match_info["entityuuid"], owner
                )
            )

        async def constraint_query(request):
            owner = auth(request, _SCD + "QueryConstraintReferences")
            return _freshness_json_response(
                request,
                await _call_read(request, scd.query_constraints, await _params(request), owner),
            )

        async def dss_report(request):
            auth(request, _SCD + "MakeDssReport")
            return web.json_response(
                await _call_r(request, scd.make_dss_report, await _params(request))
            )

        # exact /query routes registered before the {entityuuid} patterns
        app.router.add_post("/dss/v1/operation_references/query", op_query)
        app.router.add_post("/dss/v1/subscriptions/query", scd_sub_query)
        app.router.add_post(
            "/dss/v1/constraint_references/query", constraint_query
        )
        app.router.add_post("/dss/v1/reports", dss_report)
        app.router.add_put("/dss/v1/operation_references/{entityuuid}", op_put)
        app.router.add_get("/dss/v1/operation_references/{entityuuid}", op_get)
        app.router.add_delete(
            "/dss/v1/operation_references/{entityuuid}", op_delete
        )
        app.router.add_put(
            "/dss/v1/subscriptions/{subscriptionid}", scd_sub_put
        )
        app.router.add_get(
            "/dss/v1/subscriptions/{subscriptionid}", scd_sub_get
        )
        app.router.add_delete(
            "/dss/v1/subscriptions/{subscriptionid}", scd_sub_delete
        )
        app.router.add_put(
            "/dss/v1/constraint_references/{entityuuid}", constraint_put
        )
        app.router.add_get(
            "/dss/v1/constraint_references/{entityuuid}", constraint_get
        )
        app.router.add_delete(
            "/dss/v1/constraint_references/{entityuuid}", constraint_delete
        )

    return app

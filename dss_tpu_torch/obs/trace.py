"""End-to-end distributed tracing: spans, W3C propagation, a bounded
flight recorder.  A copy of the reference's `dss_tpu/obs/trace.py`;
the port's coalescer records the same span names and nesting
(tests/test_torch_trace.py), and the shm owner's fixed span slots
(OWNER_SLOTS) are the reference's wire format.  It is the per-RPC
latency breakdown the DSS gets for free from CockroachDB SQL tracing,
rebuilt for a stack where one request crosses up to four process
boundaries (shm worker -> device owner over the seqlock ring, loopback
write proxy, federation peers, region log).

Design rules, in order:

  NEAR-ZERO COST WHEN OFF.  Tracing is active only when
  DSS_TRACE_SAMPLE > 0 or DSS_TRACE_SLOW_MS > 0.  Every seam is gated
  on one module-global bool read (`current()` returns None immediately
  when off), the same discipline as chaos.fault_point, and the
  recorder counts its buffer allocations (`dss_trace_allocs_total`) so
  the disabled path is COUNTER-VERIFIED to allocate nothing — not
  assumed to.

  ONE TRACE ID END TO END.  The trace id IS the X-Request-Id: HTTP
  hops carry W3C `traceparent` (+ X-Request-Id for humans), the shm
  ring carries the id + sampled bit in reserved slot words
  (parallel/shmring.py), and every hop echoes the id on error
  responses, so grep-by-trace works across all process logs of one
  front.

  HEAD SAMPLING + TAIL CAPTURE.  A trace is recorded when its head
  decision sampled it (deterministic in the trace id, so a propagated
  decision is consistent across processes) OR — retroactively — when
  the root span breaches DSS_TRACE_SLOW_MS: spans are buffered per
  trace until the root finishes, then kept or dropped.  The p99
  breaches you are hunting are exactly the traces you keep.

  BOUNDED EVERYTHING.  Pending buffers are capped (traces and spans
  per trace), the kept-trace ring is a fixed-size flight recorder
  (DSS_TRACE_RING), and every drop is counted — the
  DssTraceRecorderSaturated alert reads those counters.

Span starts are wall-clock ns (so trees from different processes line
up on one axis); durations are measured with the caller's own timer.
The span-tree JSON is served from the worker-local
`/aux/v1/debug/traces` endpoint (api/app.py).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TraceContext",
    "SpanHandle",
    "TraceRecorder",
    "configure",
    "env_config",
    "enabled",
    "parse_traceparent",
    "format_traceparent",
    "trace_id_from_request_id",
    "new_trace",
    "current",
    "use",
    "span",
    "add_span",
    "finish_root",
    "propagation_headers",
    "begin_collect",
    "end_collect",
    "recorder",
    "stats",
    "OWNER_SLOTS",
    "owner_slot_vector",
]

# The fixed owner-side span vocabulary carried back across the shm
# ring as 8 reserved response words (duration ns per slot, see
# parallel/shmring.py): the owner cannot ship arbitrary span names
# through fixed-layout slots, so the names ARE the indices.  Order is
# wire format — append only.
OWNER_SLOTS = (
    "owner.queue_wait",   # slot claim -> serve thread pickup
    "admission",          # coalescer admission gate
    "cache.lookup",       # owner-side read-cache consult
    "plan",               # planner decision
    "device.dispatch",    # fused submit (+ wait) — the chaos seam
    "collect",            # device wait + decode + overlay merge
    "host.scan",          # forced/auto host route scan
    "owner.serve",        # whole serve_fn envelope
)
_OWNER_SLOT_INDEX = {n: i for i, n in enumerate(OWNER_SLOTS)}


# -- configuration -----------------------------------------------------------

def _env(name: str, default, conv):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return conv(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid {conv.__name__}"
        )


def _env_float(name: str, default: float) -> float:
    return _env(name, default, float)


def _env_int(name: str, default: int) -> int:
    return _env(name, default, int)


def env_config() -> dict:
    """The DSS_TRACE_* knob surface (docs/OPERATIONS.md)."""
    return {
        "sample": _env_float("DSS_TRACE_SAMPLE", 0.0),
        "slow_ms": _env_float("DSS_TRACE_SLOW_MS", 0.0),
        "ring": _env_int("DSS_TRACE_RING", 256),
        "max_spans": _env_int("DSS_TRACE_MAX_SPANS", 256),
        "max_pending": _env_int("DSS_TRACE_MAX_PENDING", 1024),
    }


_SAMPLE = 0.0
_SLOW_MS = 0.0
_ENABLED = False  # mirror of (sample > 0 or slow_ms > 0): the one gate

_tls = threading.local()


class TraceContext:
    """One request's trace identity: the 32-hex trace id (also the
    X-Request-Id), the root span id, the head-sampling decision, and
    whether spans should be recorded at all (sampled, or armed for
    tail capture)."""

    __slots__ = ("trace_id", "root_span_id", "sampled", "recording",
                 "start_ns")

    def __init__(self, trace_id: str, root_span_id: str, sampled: bool,
                 recording: bool, start_ns: int):
        self.trace_id = trace_id
        self.root_span_id = root_span_id
        self.sampled = sampled
        self.recording = recording
        self.start_ns = start_ns


class SpanHandle:
    """What `current()` hands a cross-thread consumer: the context plus
    the span id that was active at capture time — child spans recorded
    through the handle parent there, so a coalescer batch span lands
    under the request's service span, not floating at the root."""

    __slots__ = ("ctx", "span_id")

    def __init__(self, ctx: TraceContext, span_id: str):
        self.ctx = ctx
        self.span_id = span_id


# span ids: cheap per-process counter over a random 64-bit base (no
# per-span entropy draw on the hot path)
_sid_lock = threading.Lock()
_sid_next = random.getrandbits(63) | 1


def _next_span_id() -> str:
    global _sid_next
    with _sid_lock:
        _sid_next = (_sid_next + 1) & ((1 << 64) - 1) or 1
        return format(_sid_next, "016x")


# -- W3C traceparent ---------------------------------------------------------

_HEX = set("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(value) -> Optional[Tuple[str, str, bool]]:
    """-> (trace_id, parent_span_id, sampled) or None for anything
    malformed.  Strict W3C: version-ff rejected, all-zero ids
    rejected, exact field widths."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or not _is_hex(ver) or ver == "ff":
        return None
    if ver == "00" and len(parts) != 4:
        return None
    if len(tid) != 32 or not _is_hex(tid) or tid == "0" * 32:
        return None
    if len(sid) != 16 or not _is_hex(sid) or sid == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return tid, sid, bool(int(flags, 16) & 1)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def trace_id_from_request_id(rid: str) -> str:
    """Coerce a legacy X-Request-Id into a 32-hex trace id: hex ids
    are zero-padded/truncated (so the id stays greppable across logs
    that saw the original), anything else is hashed."""
    s = (rid or "").strip().lower().replace("-", "")
    if _is_hex(s) and s != "":
        s = s[:32].rjust(32, "0")
        if s != "0" * 32:
            return s
    # stable digest of the opaque id
    import hashlib

    return hashlib.sha1((rid or "").encode()).hexdigest()[:32]


def _mint_trace_id() -> str:
    tid = format(random.getrandbits(128), "032x")
    return tid if tid != "0" * 32 else _mint_trace_id()


def _head_sampled(trace_id: str) -> bool:
    """Deterministic in the trace id: every process of the front makes
    the same decision for the same id, so a propagated trace never
    records on one hop and drops on the next."""
    if _SAMPLE <= 0.0:
        return False
    if _SAMPLE >= 1.0:
        return True
    return (int(trace_id[-8:], 16) / float(1 << 32)) < _SAMPLE


# -- the flight recorder -----------------------------------------------------

# span tuple layout (kept tiny; dict trees are built only for KEPT
# traces): (span_id, parent_id, name, start_ns, dur_ms, attrs|None)


class TraceRecorder:
    """Bounded per-process recorder: pending span buffers per live
    trace, a fixed-capacity ring of kept traces, and counters for
    every allocation and drop (the zero-alloc-when-disabled and
    saturation assertions read these)."""

    def __init__(self, capacity: int = 256, max_spans: int = 256,
                 max_pending: int = 1024):
        self.capacity = max(1, int(capacity))
        self.max_spans = max(8, int(max_spans))
        self.max_pending = max(4, int(max_pending))
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, List[tuple]]" = OrderedDict()
        self._ring: deque = deque(maxlen=self.capacity)
        # counters (monotonic; exported as dss_trace_* in /metrics)
        self.allocs = 0          # pending buffers created — THE zero-
        #                          alloc-when-disabled assertion target
        self.started = 0
        self.kept_sampled = 0
        self.kept_slow = 0
        self.dropped_fast = 0    # finished unsampled, under the bound
        self.dropped_pending = 0  # pending cap hit: trace untracked
        self.dropped_spans = 0   # per-trace span cap hit
        self.evicted = 0         # ring evictions (oldest kept trace)

    def begin(self, trace_id: str) -> bool:
        """Start buffering a trace.  False when the pending cap is hit
        — the trace still propagates, it just cannot be recorded here
        (counted, alert-visible)."""
        with self._lock:
            self.started += 1
            if trace_id in self._pending:
                return True
            if len(self._pending) >= self.max_pending:
                self.dropped_pending += 1
                return False
            self._pending[trace_id] = []
            self.allocs += 1
            return True

    def add(self, trace_id: str, span: tuple) -> None:
        with self._lock:
            buf = self._pending.get(trace_id)
            if buf is None:
                return
            if len(buf) >= self.max_spans:
                self.dropped_spans += 1
                return
            buf.append(span)

    def abandon(self, trace_id: str) -> None:
        """Drop a pending trace without a keep decision (a hop that
        only collects — the shm owner — or an aborted request)."""
        with self._lock:
            self._pending.pop(trace_id, None)

    def finish(self, ctx: TraceContext, root_name: str, dur_ms: float,
               status=None, attrs: Optional[dict] = None) -> bool:
        """Root span finished: keep (sampled, or tail-captured past
        the slow bound) or drop.  -> whether the trace was kept."""
        slow = _SLOW_MS > 0.0 and dur_ms >= _SLOW_MS
        keep = ctx.sampled or slow
        with self._lock:
            spans = self._pending.pop(ctx.trace_id, None)
            if not keep:
                self.dropped_fast += 1
                return False
            if ctx.sampled:
                self.kept_sampled += 1
            if slow:
                self.kept_slow += 1
            if len(self._ring) >= self.capacity:
                self.evicted += 1
            root_attrs = dict(attrs or {})
            if status is not None:
                root_attrs["status"] = status
            root = (
                ctx.root_span_id, None, root_name, ctx.start_ns,
                round(dur_ms, 3), root_attrs or None,
            )
            self._ring.append({
                "trace_id": ctx.trace_id,
                "kept": "slow" if (slow and not ctx.sampled)
                else "sampled",
                "duration_ms": round(dur_ms, 3),
                "spans": [root] + (spans or []),
            })
        return True

    # -- introspection -------------------------------------------------------

    @staticmethod
    def _tree(entry: dict) -> dict:
        """Span tuples -> nested span tree (children under parents;
        orphans — a parent span that was dropped by the span cap —
        attach to the root)."""
        spans = entry["spans"]
        nodes = {}
        for sid, parent, name, start_ns, dur_ms, attrs in spans:
            nodes[sid] = {
                "span_id": sid,
                "name": name,
                "start_ns": int(start_ns),
                "duration_ms": dur_ms,
                **({"attrs": attrs} if attrs else {}),
                "children": [],
            }
        root_sid = spans[0][0]
        for sid, parent, *_ in spans[1:]:
            host = nodes.get(parent) if parent is not None else None
            if host is None or host is nodes[sid]:
                host = nodes[root_sid]
            host["children"].append(nodes[sid])
        for n in nodes.values():
            n["children"].sort(key=lambda c: c["start_ns"])
        return {
            "trace_id": entry["trace_id"],
            "kept": entry["kept"],
            "duration_ms": entry["duration_ms"],
            "root": nodes[root_sid],
        }

    def traces(self, limit: int = 0) -> List[dict]:
        """Kept traces as span trees, newest last."""
        with self._lock:
            entries = list(self._ring)
        if limit > 0:
            entries = entries[-limit:]
        return [self._tree(e) for e in entries]

    def find(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            for e in self._ring:
                if e["trace_id"] == trace_id:
                    return self._tree(e)
        return None

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._ring.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "dss_trace_enabled": int(_ENABLED),
                "dss_trace_sample_rate": _SAMPLE,
                "dss_trace_slow_ms": _SLOW_MS,
                "dss_trace_started_total": self.started,
                "dss_trace_kept_sampled_total": self.kept_sampled,
                "dss_trace_kept_slow_total": self.kept_slow,
                "dss_trace_dropped_total": (
                    self.dropped_pending + self.dropped_spans
                    + self.evicted
                ),
                "dss_trace_pending": len(self._pending),
                "dss_trace_ring_depth": len(self._ring),
                "dss_trace_ring_cap": self.capacity,
                "dss_trace_allocs_total": self.allocs,
            }


_RECORDER = TraceRecorder(**{
    k: v for k, v in env_config().items()
    if k in ("max_spans", "max_pending")
} | {"capacity": env_config()["ring"]})


def recorder() -> TraceRecorder:
    return _RECORDER


def stats() -> dict:
    return _RECORDER.stats()


def configure(sample: Optional[float] = None,
              slow_ms: Optional[float] = None,
              ring: Optional[int] = None,
              max_spans: Optional[int] = None,
              max_pending: Optional[int] = None) -> None:
    """Runtime/test configuration; None leaves a knob unchanged.
    Resizing the ring replaces the recorder's deque (kept traces
    survive up to the new capacity)."""
    global _SAMPLE, _SLOW_MS, _ENABLED, _RECORDER
    if sample is not None:
        _SAMPLE = max(0.0, float(sample))
    if slow_ms is not None:
        _SLOW_MS = max(0.0, float(slow_ms))
    if ring is not None or max_spans is not None or max_pending is not None:
        old = _RECORDER
        _RECORDER = TraceRecorder(
            capacity=ring if ring is not None else old.capacity,
            max_spans=max_spans if max_spans is not None else old.max_spans,
            max_pending=(
                max_pending if max_pending is not None
                else old.max_pending
            ),
        )
    _ENABLED = _SAMPLE > 0.0 or _SLOW_MS > 0.0


def enabled() -> bool:
    return _ENABLED


# load the env knobs once at import (server boot reads the same env)
configure(**{
    k: v for k, v in env_config().items() if k in ("sample", "slow_ms")
})


# -- per-thread context ------------------------------------------------------

def new_trace(traceparent: Optional[str] = None,
              request_id: Optional[str] = None) -> Optional[TraceContext]:
    """Start (or join) a trace for an inbound request.  None when
    tracing is disabled — callers fall back to plain X-Request-Id
    minting, and no recorder state is touched (the zero-alloc path).

    The sampling decision is LOCAL POLICY, recomputed from the trace
    id: because _head_sampled is deterministic in the id, every
    process of a front running the same DSS_TRACE_SAMPLE reaches the
    same decision without trusting the wire — and an external
    client's traceparent sampled flag can NOT override the local rate
    (an OTel-instrumented USS sending flag=01 on every request would
    otherwise churn the flight recorder and evict exactly the
    tail-captured breaches an operator armed DSS_TRACE_SLOW_MS to
    hunt).  Spans are buffered only when the trace can actually be
    kept: head-sampled, or tail capture armed."""
    if not _ENABLED:
        return None
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        tid = parsed[0]
    elif request_id:
        tid = trace_id_from_request_id(request_id)
    else:
        tid = _mint_trace_id()
    sampled = _head_sampled(tid)
    recording = sampled or _SLOW_MS > 0.0
    ctx = TraceContext(
        trace_id=tid,
        root_span_id=_next_span_id(),
        sampled=sampled,
        recording=recording,
        start_ns=time.time_ns(),
    )
    if recording and not _RECORDER.begin(tid):
        ctx.recording = False
    return ctx


def current() -> Optional[SpanHandle]:
    """The active (recording) span handle on this thread, or None —
    ONE attribute read when tracing is disabled or inactive here."""
    if not _ENABLED:
        return None
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not ctx.recording:
        return None
    return SpanHandle(ctx, getattr(_tls, "parent", None)
                      or ctx.root_span_id)


class _Use:
    """Context manager installing a handle's context on this thread
    (the executor-handoff seam: api/app._call sets it on the worker
    thread so service-layer spans parent correctly)."""

    __slots__ = ("_handle", "_prev")

    def __init__(self, handle):
        self._handle = handle

    def __enter__(self):
        self._prev = (
            getattr(_tls, "ctx", None), getattr(_tls, "parent", None)
        )
        if self._handle is not None:
            _tls.ctx = self._handle.ctx
            _tls.parent = self._handle.span_id
        else:
            # clear: a pooled executor thread must never inherit a
            # previous request's context
            _tls.ctx = None
            _tls.parent = None
        return self._handle

    def __exit__(self, *exc):
        _tls.ctx, _tls.parent = self._prev
        return False


def use(handle: Optional[SpanHandle]) -> _Use:
    return _Use(handle)


class _NoopSpan:
    __slots__ = ()

    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: context manager measuring its own duration and
    parenting children opened on the same thread while it is open."""

    __slots__ = ("name", "span_id", "_parent", "_ctx", "_attrs",
                 "_t0", "_start_ns", "_prev_parent")

    def __init__(self, ctx, parent, name, attrs):
        self._ctx = ctx
        self._parent = parent
        self.name = name
        self._attrs = attrs
        self.span_id = _next_span_id()

    def __enter__(self):
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._prev_parent = getattr(_tls, "parent", None)
        _tls.parent = self.span_id
        return self

    def set(self, **attrs):
        if self._attrs is None:
            self._attrs = attrs
        else:
            self._attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb):
        _tls.parent = self._prev_parent
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        _emit(
            self._ctx, self.span_id, self._parent, self.name,
            self._start_ns, dur_ms, self._attrs,
        )
        return False


def span(name: str, **attrs):
    """Open a child span of this thread's current span.  A reusable
    no-op when tracing is inactive here (one branch, no allocation)."""
    if not _ENABLED:
        return _NOOP
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not ctx.recording:
        return _NOOP
    return _Span(
        ctx, getattr(_tls, "parent", None) or ctx.root_span_id,
        name, attrs or None,
    )


def _emit(ctx, span_id, parent, name, start_ns, dur_ms, attrs) -> None:
    collector = getattr(_tls, "collect", None)
    rec = (
        span_id, parent, name, int(start_ns), round(dur_ms, 3),
        attrs or None,
    )
    if collector is not None:
        collector.append(rec)
        return
    _RECORDER.add(ctx.trace_id, rec)


def add_span(handle: Optional[SpanHandle], name: str, start_ns: int,
             dur_ms: float, attrs: Optional[dict] = None,
             parent: Optional[str] = None) -> Optional[str]:
    """Record an externally-measured span under `handle` (the cross-
    thread seam: the coalescer's pipeline stamps batch timings onto
    items, and the caller's thread records them through the handle it
    captured at admission).  -> the new span id (for chaining
    children), or None when not recording."""
    if handle is None:
        return None
    sid = _next_span_id()
    _emit(
        handle.ctx, sid, parent or handle.span_id, name, start_ns,
        dur_ms, attrs,
    )
    return sid


def finish_root(ctx: Optional[TraceContext], name: str, dur_ms: float,
                status=None, attrs: Optional[dict] = None) -> bool:
    """Finish a request's root span and let the recorder keep or drop
    the trace (head sample / tail capture)."""
    if ctx is None:
        return False
    if not ctx.recording:
        _RECORDER.abandon(ctx.trace_id)
        return False
    return _RECORDER.finish(ctx, name, dur_ms, status=status,
                            attrs=attrs)


def propagation_headers(
    handle: Optional[SpanHandle] = None,
) -> Dict[str, str]:
    """Outbound headers for a cross-process hop: W3C traceparent (the
    current span becomes the remote's parent) + X-Request-Id (the
    trace id, for log grep).  {} when tracing is inactive here."""
    if handle is None:
        handle = current()
        if handle is None:
            return {}
    return {
        "traceparent": format_traceparent(
            handle.ctx.trace_id, handle.span_id, handle.ctx.sampled
        ),
        "X-Request-Id": handle.ctx.trace_id,
    }


# -- collector mode (the shm owner) ------------------------------------------


class _Collect:
    """Thread-state token for a collect-mode activation (the shm
    owner serves a worker's request and ships span timings back in
    fixed response words instead of recording locally)."""

    __slots__ = ("spans", "_prev")


def begin_collect(trace_id: str, sampled: bool = True) -> _Collect:
    """Activate a collect-mode context on this thread: spans emitted
    by the serve path land in a local list (no recorder allocation),
    to be encoded into shm response words by the caller."""
    tok = _Collect()
    tok.spans = []
    tok._prev = (
        getattr(_tls, "ctx", None), getattr(_tls, "parent", None),
        getattr(_tls, "collect", None),
    )
    ctx = TraceContext(
        trace_id=trace_id, root_span_id=_next_span_id(),
        sampled=sampled, recording=True, start_ns=time.time_ns(),
    )
    _tls.ctx = ctx
    _tls.parent = ctx.root_span_id
    _tls.collect = tok.spans
    return tok


def end_collect(tok: _Collect) -> List[tuple]:
    """Deactivate collect mode -> the collected span tuples."""
    _tls.ctx, _tls.parent, _tls.collect = tok._prev
    return tok.spans


def owner_slot_vector(spans: Sequence[tuple],
                      extra: Optional[Dict[str, float]] = None
                      ) -> List[int]:
    """Fold collected spans into the fixed OWNER_SLOTS duration vector
    (ns per slot; duplicate names sum).  `extra` adds slot durations
    measured outside the collected region (owner.queue_wait,
    owner.serve) in milliseconds."""
    vec = [0] * len(OWNER_SLOTS)
    for _sid, _parent, name, _start, dur_ms, _attrs in spans:
        idx = _OWNER_SLOT_INDEX.get(name)
        if idx is not None:
            vec[idx] += int(dur_ms * 1e6)
    if extra:
        for name, ms in extra.items():
            idx = _OWNER_SLOT_INDEX.get(name)
            if idx is not None:
                vec[idx] += int(ms * 1e6)
    return vec

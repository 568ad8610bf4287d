"""Thread-local per-stage timing sink for request handling (a copy of
the reference's `dss_tpu/obs/stages.py`).

The serving stack (api/app.py `_call`) installs a per-request dict as
this thread's sink before invoking the synchronous service layer;
service code brackets its phases with `stage("covering_ms")` etc.  The
access-log middleware then emits the collected stages to the trace log,
the X-Dss-Stages response header (when tracing), and aggregate
counters in /metrics — so "where does the p50 go" is measured per
stage instead of guessed (the per-RPC latency breakdown the reference
gets from its SQL tracing).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from dss_tpu_torch.obs import trace

_tls = threading.local()


def set_sink(sink) -> None:
    """Install (or clear, with None) this thread's stage sink."""
    _tls.sink = sink


def get_sink():
    return getattr(_tls, "sink", None)


def mark(name: str, duration_ms: float, span: bool = True) -> None:
    """Record an externally-measured duration into the current sink
    (no-op without one).  For callers that cannot bracket the timed
    region with `stage` — e.g. the coalescer recording how long an
    item waited for its micro-batch.  Repeated marks accumulate.
    When a trace is recording on this thread the mark also lands as a
    span (start back-dated by the duration); span=False skips that for
    callers that record a richer span of their own for the same
    region (the shm ring round trip)."""
    sink = getattr(_tls, "sink", None)
    if sink is None:
        return
    sink[name] = round(sink.get(name, 0.0) + duration_ms, 3)
    if not span:
        return
    h = trace.current()
    if h is not None:
        trace.add_span(
            h, name, time.time_ns() - int(duration_ms * 1e6),
            duration_ms,
        )


@contextmanager
def stage(name: str):
    """Time a block into the current sink (no-op without a sink).
    Repeated stages accumulate.  When a trace is recording on this
    thread the block is also a span — service phases (covering/store/
    serialize) become tree nodes for free, with real nesting (spans
    opened inside the block parent under it)."""
    sink = getattr(_tls, "sink", None)
    if sink is None:
        yield
        return
    sp = trace.span(name)
    t0 = time.perf_counter()
    try:
        with sp:
            yield
    finally:
        sink[name] = round(
            sink.get(name, 0.0) + (time.perf_counter() - t0) * 1000, 3
        )

"""Ambient per-request deadline propagation (route -> serving stack).
A copy of the reference's `dss_tpu/dar/deadline.py`.

The HTTP timeout middleware (api/app.py) knows each request's absolute
deadline; the QueryCoalescer — four call layers down, reached through
service and store code that has no deadline parameter — needs it to
route the request's micro-batch (chunked exact host scans when the
device round trip would blow the tightest queued headroom) and to
fast-shed work whose deadline already expired in queue.

Rather than threading a `deadline` kwarg through every service/store
signature, the deadline rides a thread-local — the same pattern the
per-stage tracer (obs/stages.set_sink) and the host-only read budget
(dar/budget.set_host_only) already use for request-scoped context that
crosses the handler -> executor -> store boundary.  api/app.py installs
it on the worker thread (or the event loop, for inline reads) around
each service call; dar/coalesce.QueryCoalescer reads it at admission
and caps the item's SLO-derived deadline with it.

Deadlines are absolute `time.monotonic()` instants (never wall clock:
NTP steps must not expire queued work)."""

from __future__ import annotations

import threading
from typing import Optional

_tls = threading.local()


def set_route_deadline(deadline: Optional[float]) -> None:
    """Install (or clear, with None) the current request's absolute
    monotonic deadline on this thread."""
    _tls.deadline = deadline


def get_route_deadline() -> Optional[float]:
    """The absolute monotonic deadline of the request being served on
    this thread, or None outside a deadline-scoped request."""
    return getattr(_tls, "deadline", None)

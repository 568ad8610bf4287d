"""Structured logging (the zap analog, pkg/logging/logging.go).

Env controls mirror the reference: DSS_LOG_LEVEL (debug/info/warn/
error, logging.go:35-41) and DSS_LOG_FORMAT ("json" | "console",
logging.go:43-49).  `access_log_middleware` is the grpc_zap request
interceptor + HTTP access-log middleware analog (logging.go:85-95,
http.go:36-55); `dump` mirrors --dump_requests proto dumping
(logging.go:106-120).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import asyncio
import time
from typing import Optional

_CONFIGURED = False


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure_logging(
    level: Optional[str] = None, fmt: Optional[str] = None
) -> None:
    global _CONFIGURED
    level = (level or os.environ.get("DSS_LOG_LEVEL") or "info").lower()
    fmt = (fmt or os.environ.get("DSS_LOG_FORMAT") or "json").lower()
    lvl = {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }.get(level, logging.INFO)
    root = logging.getLogger("dss")
    root.setLevel(lvl)
    root.handlers.clear()
    h = logging.StreamHandler(sys.stderr)
    if fmt == "console":
        h.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
    else:
        h.setFormatter(JsonFormatter())
    root.addHandler(h)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str = "dss") -> logging.Logger:
    if not _CONFIGURED:
        configure_logging()
    return logging.getLogger(name if name.startswith("dss") else f"dss.{name}")


def log_fields(logger: logging.Logger, level: int, msg: str, **fields):
    logger.log(level, msg, extra={"fields": fields})


def make_access_log_middleware(metrics=None, dump_requests: bool = False,
                               health_fn=None,
                               logger_name: str = "dss.access"):
    """aiohttp middleware: one JSON access-log line per request with
    method/path/status/duration/owner, the trace id (`trace=` — the
    same id every hop of the front logs, so grep-by-trace crosses
    process logs), the active degraded-mode tag when `health_fn`
    reports one, optional request/response body dump (--dump_requests
    analog), and RED metric recording."""
    from aiohttp import web

    logger = get_logger(logger_name)

    @web.middleware
    async def access_log(request, handler):
        start = time.perf_counter()
        # per-stage timing sink: service code (via obs.stages) and the
        # auth/service call wrappers add parse/auth/covering/store/
        # serialize millisecond entries here
        request["dss_stages"] = {}
        body = None
        if dump_requests and request.can_read_body:
            # bound the dump buffer: skip bodies over 64 KB (or with no
            # declared length) so a large body can't inflate per-request
            # memory; truncated again to 4096 chars at log time below
            cl = request.content_length
            if cl is not None and cl <= 65536:
                # bounded in TIME too: this read happens outside the
                # per-request deadline middleware, so a client
                # trickling a declared-length body must not hold the
                # connection forever
                try:
                    body = await asyncio.wait_for(request.text(), 5.0)
                except asyncio.TimeoutError:
                    body = "(body read timed out)"
            elif cl is None:
                body = "(body of undeclared length not dumped)"
            else:
                body = f"(body of {cl} bytes not dumped)"
        status = 500
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            dur = time.perf_counter() - start
            stages = request.get("dss_stages") or {}
            if logger.isEnabledFor(logging.INFO):
                fields = {
                    "method": request.method,
                    "path": request.path,
                    "status": status,
                    "duration_ms": round(dur * 1000, 3),
                    "remote": request.remote,
                }
                owner = request.get("dss_owner")
                if owner:
                    fields["owner"] = owner
                fields.update(stages)
                tr = request.get("dss_trace")
                if tr is None:
                    # no trace middleware on this app (region log
                    # server): the propagated header is still the id
                    rid = request.headers.get("X-Request-Id")
                    tr = {"request_id": rid} if rid else None
                if tr is not None:
                    fields["request_id"] = tr["request_id"]
                    ctx = tr.get("ctx")
                    fields["trace"] = (
                        ctx.trace_id if ctx is not None
                        else tr["request_id"]
                    )
                if health_fn is not None:
                    try:
                        mode = health_fn()
                    except Exception:  # noqa: BLE001 — tag best-effort
                        mode = None
                    if mode and mode != "healthy":
                        fields["mode"] = mode
                if body is not None:
                    fields["request_body"] = body[:4096]
                log_fields(logger, logging.INFO, "request", **fields)
            if metrics is not None:
                # label with the matched route's canonical pattern
                # (/v1/.../{id}) so untrusted path segments can never
                # mint new label series; unmatched paths (404
                # scanners) collapse to one label
                resource = (
                    request.match_info.route.resource
                    if request.match_info is not None
                    else None
                )
                route = (
                    resource.canonical
                    if resource is not None
                    else "(unmatched)"
                )
                metrics.observe_request(request.method, route, status, dur)
                for st, ms in stages.items():
                    metrics.observe_stage(route, st, ms / 1000.0)

    return access_log

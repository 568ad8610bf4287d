"""DSS error vocabulary.

The port of the reference's `dss_tpu/errors.py`.  Mirrors the DSS's
gRPC status-code vocabulary (pkg/errors/errors.go) including the two
custom codes
AreaTooLarge=18 (-> HTTP 413) and MissingOVNs=19 (-> HTTP 409 with an
AirspaceConflictResponse body, cmds/http-gateway/main.go:102-147), and
the DSS_ERRORS_OBFUSCATE_INTERNAL_ERRORS toggle (errors.go:31-43).
"""

from __future__ import annotations

import os
from enum import IntEnum


class Code(IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16
    # DSS custom codes (reference pkg/errors/errors.go:21-29)
    AREA_TOO_LARGE = 18
    MISSING_OVNS = 19


# HTTP status mapping (reference cmds/http-gateway/main.go:102-147; the
# standard grpc-gateway table plus the DSS custom codes).
HTTP_STATUS = {
    Code.OK: 200,
    Code.CANCELLED: 408,
    Code.UNKNOWN: 500,
    Code.INVALID_ARGUMENT: 400,
    Code.DEADLINE_EXCEEDED: 504,
    Code.NOT_FOUND: 404,
    Code.ALREADY_EXISTS: 409,
    Code.PERMISSION_DENIED: 403,
    Code.RESOURCE_EXHAUSTED: 429,
    Code.FAILED_PRECONDITION: 400,
    Code.ABORTED: 409,
    Code.OUT_OF_RANGE: 400,
    Code.UNIMPLEMENTED: 501,
    Code.INTERNAL: 500,
    Code.UNAVAILABLE: 503,
    Code.DATA_LOSS: 500,
    Code.UNAUTHENTICATED: 401,
    Code.AREA_TOO_LARGE: 413,
    Code.MISSING_OVNS: 409,
}


class StatusError(Exception):
    """An error with a status code, the lingua franca across layers."""

    def __init__(self, code: Code, message: str, details=None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.details = details  # e.g. AirspaceConflictResponse payload

    @property
    def http_status(self) -> int:
        return HTTP_STATUS.get(self.code, 500)

    def __repr__(self):
        return f"StatusError({self.code.name}, {self.message!r})"


def _obfuscate_internal() -> bool:
    # Default is to obfuscate; env var parsing per reference errors.go:36-42.
    raw = os.environ.get("DSS_ERRORS_OBFUSCATE_INTERNAL_ERRORS")
    if raw is None:
        return True
    try:
        return raw.strip().lower() in ("1", "t", "true", "yes", "y", "on")
    except Exception:
        return True


def already_exists(id_str: str) -> StatusError:
    return StatusError(Code.ALREADY_EXISTS, "resource already exists: " + id_str)


def version_mismatch(msg: str) -> StatusError:
    return StatusError(Code.ABORTED, msg)


def not_found(id_str: str) -> StatusError:
    return StatusError(Code.NOT_FOUND, "resource not found: " + id_str)


def bad_request(msg: str) -> StatusError:
    return StatusError(Code.INVALID_ARGUMENT, msg)


def internal(msg: str) -> StatusError:
    if _obfuscate_internal():
        return StatusError(Code.INTERNAL, "Internal Server Error")
    return StatusError(Code.INTERNAL, msg)


def exhausted(msg: str) -> StatusError:
    return StatusError(Code.RESOURCE_EXHAUSTED, msg)


class OverloadedError(StatusError):
    """The serving queue is full: the request was shed at admission
    instead of joining an unbounded backlog (bounded-latency overload
    degradation).  Maps to HTTP 429; `retry_after_s` is the estimated
    queue-drain horizon the transport layer surfaces as Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(Code.RESOURCE_EXHAUSTED, message)
        self.retry_after_s = float(retry_after_s)


def permission_denied(msg: str) -> StatusError:
    return StatusError(Code.PERMISSION_DENIED, msg)


def unauthenticated(msg: str) -> StatusError:
    return StatusError(Code.UNAUTHENTICATED, msg)


def unavailable(msg: str) -> StatusError:
    return StatusError(Code.UNAVAILABLE, msg)


def deadline_exceeded(msg: str) -> StatusError:
    return StatusError(Code.DEADLINE_EXCEEDED, msg)


def area_too_large(msg: str) -> StatusError:
    return StatusError(Code.AREA_TOO_LARGE, msg)


def unimplemented(msg: str) -> StatusError:
    return StatusError(Code.UNIMPLEMENTED, msg)


def missing_ovns(conflicting_ops) -> StatusError:
    """The special AirspaceConflictResponse error (reference
    pkg/scd/errors/errors.go:22-59): the client must be shown the
    operations it lacks OVNs for."""
    return StatusError(
        Code.MISSING_OVNS,
        "at least one current operation is missing from the key",
        details=conflicting_ops,
    )


def retry_write_conflicts(fn):
    """Service-method decorator: re-run the whole (rolled-back)
    operation when a region optimistic append lost a disjointness race
    — the internal-retry contract the reference gets from its CRDB txn
    retrier (pkg/rid/cockroach/store.go:19-26).  The retry rides the
    lease path (the coordinator cools down to lease-only after a
    conflict), so it serializes instead of racing again."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        attempts = 3
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except StatusError as e:
                if (
                    not getattr(e, "retryable_write_conflict", False)
                    or attempt == attempts - 1
                ):
                    raise
        raise AssertionError("unreachable")

    return wrapper


def later_slice(what: str, slice_: str):
    """Raise for a part of the reference that a later slice of the port
    brings: a flag, argument or hook that is set, never at import."""
    raise NotImplementedError(
        f"{what} is not ported yet; it comes with the {slice_} slice"
    )

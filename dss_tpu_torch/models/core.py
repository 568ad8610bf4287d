"""Core value types.

Mirrors the upstream DSS's pkg/models/models.go (ID, Owner, the base-32
commit-timestamp Version used as an RMW fencing token) and
pkg/scd/models/models.go (the opaque OVN and https-only USS base URL
validation).
"""

from __future__ import annotations

import base64
import hashlib
import re
from datetime import datetime, timezone

from dss_tpu_torch import errors
from dss_tpu_torch.clock import from_nanos, to_nanos

# Go strconv base-32 digit set (FormatUint/ParseUint with base=32).
_BASE32_DIGITS = "0123456789abcdefghijklmnopqrstuv"
_BASE32_INDEX = {c: i for i, c in enumerate(_BASE32_DIGITS)}

_UUID_RE = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$"
)

ID = str
Owner = str


def validate_uuid(id_str: str) -> None:
    """Request-level UUID validation (reference pkg/validations)."""
    if not _UUID_RE.match(id_str or ""):
        raise errors.bad_request(f"invalid uuid: {id_str!r}")


def _format_base32(n: int) -> str:
    if n == 0:
        return "0"
    out = []
    while n:
        out.append(_BASE32_DIGITS[n & 31])
        n >>= 5
    return "".join(reversed(out))


def _parse_base32(s: str) -> int:
    n = 0
    for c in s:
        try:
            n = (n << 5) | _BASE32_INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base-32 digit {c!r}")
    if n >= 1 << 64:
        raise ValueError("value out of uint64 range")
    return n


class Version:
    """RID version: a base-32-encoded commit timestamp (nanoseconds),
    used as an RMW fencing token (reference pkg/models/models.go:40-61)."""

    __slots__ = ("_nanos", "_s")

    def __init__(self, nanos: int, s: str):
        self._nanos = nanos
        self._s = s

    @classmethod
    def from_string(cls, s: str) -> "Version":
        if not s:
            raise ValueError("requires version string")
        return cls(_parse_base32(s), s)

    @classmethod
    def from_time(cls, t: datetime) -> "Version":
        nanos = to_nanos(t)
        return cls(nanos, _format_base32(nanos))

    @property
    def empty(self) -> bool:
        return self._nanos == 0

    def matches(self, other: "Version | None") -> bool:
        if other is None:
            return False
        return self._s == other._s

    def to_timestamp(self) -> datetime:
        return from_nanos(self._nanos)

    def __str__(self) -> str:
        return self._s

    def __repr__(self) -> str:
        return f"Version({self._s})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Version) and self._s == other._s

    def __hash__(self):
        return hash(self._s)


def version_matches(v: Version | None, w: Version | None) -> bool:
    if v is None or w is None:
        return False
    return v.matches(w)


OVN = str


def new_ovn_from_time(t: datetime, salt: str) -> OVN:
    """OVN = base64(sha256(salt + RFC3339(t))) — reference
    pkg/scd/models/models.go:35-40.  RFC3339 here matches Go's format:
    seconds precision, 'Z' for UTC."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    t_utc = t.astimezone(timezone.utc)
    stamp = t_utc.strftime("%Y-%m-%dT%H:%M:%SZ")
    digest = hashlib.sha256((salt + stamp).encode()).digest()
    return base64.b64encode(digest).decode()


def ovn_valid(ovn: str) -> bool:
    return 16 <= len(ovn) <= 128


def validate_uss_base_url(url: str) -> None:
    """https-only (reference pkg/scd/models/models.go:67-83)."""
    m = re.match(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://", url or "")
    scheme = m.group(1).lower() if m else ""
    if scheme == "https":
        return
    if scheme == "http":
        raise ValueError("uss_base_url in new_subscription must use TLS")
    raise ValueError("uss_base_url must support https scheme")

"""Clock abstraction so every layer can run against a fake clock.

The reference swaps a fake clock into package-level DefaultClock vars in
tests (pkg/rid/application/application_test.go:9-10,43); here the clock
is injected explicitly and a FakeClock is provided for tests.
Times are timezone-aware UTC datetimes everywhere.
"""

from __future__ import annotations

import threading
from datetime import datetime, timedelta, timezone


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def to_nanos(t: datetime) -> int:
    """Datetime -> unix nanoseconds (int, exact). Naive treated as UTC."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    micros = (t - _EPOCH) // timedelta(microseconds=1)
    return micros * 1000


def from_nanos(ns: int) -> datetime:
    return datetime.fromtimestamp(ns / 1e9, tz=timezone.utc)


class Clock:
    """Real wall clock."""

    def now(self) -> datetime:
        return utcnow()


class FakeClock(Clock):
    """Settable clock for tests."""

    def __init__(self, start: datetime | None = None):
        self._lock = threading.Lock()
        self._now = start or datetime(2026, 1, 1, tzinfo=timezone.utc)

    def now(self) -> datetime:
        with self._lock:
            return self._now

    def advance(self, **kwargs):
        with self._lock:
            self._now += timedelta(**kwargs)

    def set(self, t: datetime):
        with self._lock:
            self._now = t if t.tzinfo else t.replace(tzinfo=timezone.utc)


SYSTEM_CLOCK = Clock()

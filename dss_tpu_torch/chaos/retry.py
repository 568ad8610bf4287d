"""One retry policy for the whole stack.

Before this module, three transports each grew their own loop:
RegionClient hand-rolled `min(0.05 * 2**attempt, 0.5) * (0.5 + rand)`,
the mirror sender hand-rolled `min(0.1 * 2**fails, 2.0) * (0.5+rand)`,
and the region coordinator slept a FIXED 2.0 s after every optimistic
conflict — so two coordinators that collided once re-collided in
lockstep forever.  All three now share:

  RetryPolicy       jittered exponential backoff with a cap and an
                    optional deadline budget, deterministic when
                    seeded (the chaos tests replay exact schedules)
  CircuitBreaker    per-remote closed/open/half-open, feeding the
                    dss_breaker_state{remote} gauge and driving the
                    degradation ladder (all endpoints open ==
                    REGION_LOG_DOWN)
  BreakerRegistry   the keyed family of breakers for one client

The breaker is deliberately advisory on single-path transports: it
never blocks the ONLY endpoint (an open breaker there just means every
attempt is a half-open probe), it reorders multi-endpoint rotation
away from open remotes, and its state is the operator signal.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

__all__ = [
    "RetryPolicy",
    "Deadline",
    "CircuitBreaker",
    "BreakerRegistry",
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
]

# numeric gauge values for dss_breaker_state{remote}
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2


class RetryPolicy:
    """Jittered exponential backoff: attempt k (0-based) sleeps
    min(base * multiplier**k, cap) * uniform(1-jitter, 1+jitter).
    Stateless between calls — the caller owns the attempt counter —
    so one policy object can serve many concurrent loops."""

    __slots__ = ("base_s", "cap_s", "multiplier", "jitter", "_rng",
                 "_lock")

    def __init__(
        self,
        base_s: float = 0.05,
        cap_s: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        seed: Optional[int] = None,
    ):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.multiplier = float(multiplier)
        self.jitter = max(0.0, min(1.0, float(jitter)))
        self._rng = random.Random(seed) if seed is not None else random
        self._lock = threading.Lock()

    def raw_backoff_s(self, attempt: int) -> float:
        """The un-jittered curve (its cap is the honest Retry-After
        quote for 'come back when the breaker may have reset').  The
        exponent is clamped BEFORE exponentiating: callers feed
        unbounded failure streaks (a mirror flapping for an hour), and
        multiplier**1075 would raise OverflowError inside the very
        retry loop that must never die — any clamped value is already
        far past the cap."""
        return min(
            self.base_s
            * self.multiplier ** min(64, max(0, int(attempt))),
            self.cap_s,
        )

    def backoff_s(self, attempt: int) -> float:
        raw = self.raw_backoff_s(attempt)
        j = self.jitter
        if j <= 0.0:
            return raw
        with self._lock:  # seeded Random is not thread-safe
            u = self._rng.random()
        return raw * (1.0 - j + 2.0 * j * u)

    def sleep(self, attempt: int, deadline: "Optional[Deadline]" = None,
              sleep_fn=time.sleep) -> float:
        """Sleep the attempt's backoff, clipped to the deadline budget.
        Returns the seconds actually slept (0.0 when the deadline is
        already spent — the caller's loop condition should then bail)."""
        d = self.backoff_s(attempt)
        if deadline is not None:
            d = min(d, max(0.0, deadline.remaining_s()))
        if d > 0.0:
            sleep_fn(d)
        return d


class Deadline:
    """A wall-clock retry budget (monotonic)."""

    __slots__ = ("_at", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self._clock = clock
        self._at = clock() + float(budget_s)

    def remaining_s(self) -> float:
        return self._at - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self._at


class CircuitBreaker:
    """Closed/open/half-open per remote.

    `fail_threshold` consecutive failures opens the breaker for
    `reset_s`; after the cooldown the next allow() is a half-open
    probe — success closes, failure re-opens (a fresh cooldown).
    Thread-safe; the clock is injectable for deterministic tests."""

    __slots__ = ("fail_threshold", "reset_s", "_clock", "_lock",
                 "_fails", "_state", "_open_until", "trips")

    def __init__(
        self,
        fail_threshold: int = 5,
        reset_s: float = 5.0,
        clock=time.monotonic,
    ):
        self.fail_threshold = max(1, int(fail_threshold))
        self.reset_s = float(reset_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._fails = 0
        self._state = BREAKER_CLOSED
        self._open_until = 0.0
        self.trips = 0  # times the breaker opened

    def _state_locked(self) -> int:
        if (
            self._state == BREAKER_OPEN
            and self._clock() >= self._open_until
        ):
            self._state = BREAKER_HALF_OPEN
        return self._state

    @property
    def state(self) -> int:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """May a call go to this remote right now?  Open -> no;
        half-open/closed -> yes (each half-open call is a probe)."""
        with self._lock:
            return self._state_locked() != BREAKER_OPEN

    def record_success(self) -> None:
        with self._lock:
            self._fails = 0
            self._state = BREAKER_CLOSED

    def record_failure(self) -> None:
        with self._lock:
            st = self._state_locked()
            self._fails += 1
            if st == BREAKER_HALF_OPEN or self._fails >= self.fail_threshold:
                if st != BREAKER_OPEN:
                    self.trips += 1
                self._state = BREAKER_OPEN
                self._open_until = self._clock() + self.reset_s

    def cooldown_remaining_s(self) -> float:
        """Seconds until a half-open probe is allowed (0 when not
        open) — the honest Retry-After for callers shed by an outage."""
        with self._lock:
            if self._state_locked() != BREAKER_OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock())


class BreakerRegistry:
    """The per-remote breaker family for one client; states() feeds
    the dss_breaker_state{remote} gauge family."""

    def __init__(
        self,
        fail_threshold: int = 5,
        reset_s: float = 5.0,
        clock=time.monotonic,
    ):
        self._kw = dict(
            fail_threshold=fail_threshold, reset_s=reset_s, clock=clock
        )
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, remote: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(remote)
            if b is None:
                b = CircuitBreaker(**self._kw)
                self._breakers[remote] = b
            return b

    def states(self) -> Dict[str, int]:
        with self._lock:
            return {r: b.state for r, b in self._breakers.items()}

    def all_open(self) -> bool:
        """Every known remote refused past its threshold — the signal
        that flips the ladder to REGION_LOG_DOWN."""
        with self._lock:
            if not self._breakers:
                return False
            return all(
                b.state == BREAKER_OPEN for b in self._breakers.values()
            )

    def min_cooldown_s(self, default: float = 1.0) -> float:
        """The soonest any remote allows a probe — the Retry-After an
        all-breakers-open outage quotes to shed writers."""
        with self._lock:
            if not self._breakers:
                return default
            vals = [
                b.cooldown_remaining_s() for b in self._breakers.values()
            ]
        live = [v for v in vals if v > 0.0]
        return min(live) if live else default

"""SCD entity models: Operation references + Subscriptions + Constraints.

Mirrors the upstream DSS's pkg/scd/models/operations.go and
subscriptions.go: int32 fencing versions, OVNs, operation states, and
the subscription time-range rules (shared with RID).  Constraint
references go BEYOND the reference (constraints_handler.go:12-30 stubs
them): same int32 fencing version + OVN discipline as operations, no
state machine (a constraint is authoritative airspace data, not a
negotiated intent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import List, Optional

import numpy as np

from dss_tpu_torch import errors
from dss_tpu_torch.models.core import OVN, Owner

MAX_SUBSCRIPTION_DURATION = timedelta(hours=24)
MAX_CLOCK_SKEW = timedelta(minutes=5)


class OperationState:
    UNKNOWN = ""
    ACCEPTED = "Accepted"
    ACTIVATED = "Activated"
    NON_CONFORMING = "NonConforming"
    CONTINGENT = "Contingent"
    ENDED = "Ended"

    ALL = (ACCEPTED, ACTIVATED, NON_CONFORMING, CONTINGENT, ENDED)
    # States whose upserts require the full OVN key
    # (pkg/scd/store/cockroach/operations.go:335-347).
    REQUIRES_KEY = (ACCEPTED, ACTIVATED)


@dataclass
class Operation:
    id: str
    owner: Owner
    version: int = 0  # int32 fencing token (scd/models/models.go:17-22)
    ovn: OVN = ""
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    altitude_lower: Optional[float] = None
    altitude_upper: Optional[float] = None
    uss_base_url: str = ""
    state: str = OperationState.UNKNOWN
    cells: np.ndarray = field(default_factory=lambda: np.array([], np.uint64))
    subscription_id: str = ""
    # The op's USS consumes constraint updates (its subscription has
    # notify_for_constraints) and therefore participates in
    # constraint-aware deconfliction: upserts in REQUIRES_KEY states
    # must present the OVN of every intersecting constraint, and the
    # AirspaceConflict payload lists missing constraints alongside
    # missing operations.  Ops that never declared awareness keep the
    # reference's op-only key check.
    constraint_aware: bool = False

    def validate_time_range(self) -> None:
        """operations.go:78-94."""
        if self.start_time is None:
            raise errors.bad_request("Operation must have an time_start")
        if self.end_time is None:
            raise errors.bad_request("Operation must have an time_end")
        if self.end_time < self.start_time:
            raise errors.bad_request(
                "Operation time_end must be after time_start"
            )


@dataclass
class Constraint:
    """Constraint reference: an authority-published airspace restriction
    (mass-event closure, emergency corridor, geofence).  Carries the
    same int32 fencing version + OVN pair as Operation; unlike
    operations there is no state machine and upserts never require an
    OVN key — constraints deconflict operations, nothing deconflicts a
    constraint."""

    id: str
    owner: Owner
    version: int = 0  # int32 fencing token, same rules as Operation
    ovn: OVN = ""
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    altitude_lower: Optional[float] = None
    altitude_upper: Optional[float] = None
    uss_base_url: str = ""
    cells: np.ndarray = field(default_factory=lambda: np.array([], np.uint64))

    def validate_time_range(self) -> None:
        if self.start_time is None:
            raise errors.bad_request("Constraint must have a time_start")
        if self.end_time is None:
            raise errors.bad_request("Constraint must have a time_end")
        if self.end_time < self.start_time:
            raise errors.bad_request(
                "Constraint time_end must be after time_start"
            )


@dataclass
class Subscription:
    id: str
    owner: Owner
    version: int = 0
    notification_index: int = 0
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    altitude_hi: Optional[float] = None
    altitude_lo: Optional[float] = None
    base_url: str = ""
    notify_for_operations: bool = False
    notify_for_constraints: bool = False
    implicit_subscription: bool = False
    dependent_operations: List[str] = field(default_factory=list)
    cells: np.ndarray = field(default_factory=lambda: np.array([], np.uint64))

    def adjust_time_range(self, now: datetime, old: "Subscription | None") -> None:
        """scd/models/subscriptions.go:90-128 (same rules as RID)."""
        if self.start_time is None:
            self.start_time = now if old is None else old.start_time
        else:
            if now - self.start_time > MAX_CLOCK_SKEW:
                raise errors.bad_request(
                    "subscription time_start must not be in the past"
                )
        if self.end_time is None and old is not None:
            self.end_time = old.end_time
        if self.end_time is None:
            self.end_time = self.start_time + MAX_SUBSCRIPTION_DURATION
        if self.end_time < self.start_time:
            raise errors.bad_request(
                "subscription time_end must be after time_start"
            )
        if self.end_time - self.start_time > MAX_SUBSCRIPTION_DURATION:
            raise errors.bad_request("subscription window exceeds 24 hours")

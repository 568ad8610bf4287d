"""RID entity models: IdentificationServiceArea + Subscription.

Mirrors the upstream DSS's pkg/rid/models/identification_service_area.go
and subscriptions.go: 4D extents with level-13 cell coverings, base-32
commit-timestamp versions, and the time-range adjustment rules
(5-minute clock skew for starts, 24h max subscription duration).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import List, Optional

import numpy as np

from dss_tpu_torch import errors
from dss_tpu_torch.models.core import Owner, Version
from dss_tpu_torch.models.volumes import Volume4D

MAX_SUBSCRIPTION_DURATION = timedelta(hours=24)
MAX_CLOCK_SKEW = timedelta(minutes=5)


@dataclass
class IdentificationServiceArea:
    id: str
    owner: Owner
    url: str = ""
    cells: np.ndarray = field(default_factory=lambda: np.array([], np.uint64))
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    version: Optional[Version] = None
    altitude_hi: Optional[float] = None
    altitude_lo: Optional[float] = None

    def set_extents(self, extents: Volume4D) -> None:
        """Validation + covering, per identification_service_area.go:71-104."""
        if extents is None:
            return
        self.start_time = extents.start_time
        self.end_time = extents.end_time
        if extents.spatial_volume is None:
            raise errors.bad_request("missing required spatial_volume")
        sv = extents.spatial_volume
        self.altitude_hi = sv.altitude_hi
        self.altitude_lo = sv.altitude_lo
        if sv.footprint is None:
            raise errors.bad_request("spatial_volume missing required footprint")
        self.cells = sv.footprint.calculate_covering()

    def adjust_time_range(
        self, now: datetime, old: "IdentificationServiceArea | None"
    ) -> None:
        """identification_service_area.go:108-140."""
        if self.start_time is None:
            self.start_time = now if old is None else old.start_time
        else:
            if now - self.start_time > MAX_CLOCK_SKEW:
                raise errors.bad_request(
                    "IdentificationServiceArea time_start must not be in the past"
                )
        if self.end_time is None and old is not None:
            self.end_time = old.end_time
        if self.end_time is None:
            raise errors.bad_request(
                "IdentificationServiceArea must have an time_end"
            )
        if self.end_time < self.start_time:
            raise errors.bad_request(
                "IdentificationServiceArea time_end must be after time_start"
            )


@dataclass
class Subscription:
    id: str
    owner: Owner
    url: str = ""
    notification_index: int = 0
    cells: np.ndarray = field(default_factory=lambda: np.array([], np.uint64))
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None
    version: Optional[Version] = None
    altitude_hi: Optional[float] = None
    altitude_lo: Optional[float] = None

    def set_extents(self, extents: Volume4D) -> None:
        """subscriptions.go:98-131."""
        if extents is None:
            return
        self.start_time = extents.start_time
        self.end_time = extents.end_time
        if extents.spatial_volume is None:
            raise errors.bad_request("missing required spatial_volume")
        sv = extents.spatial_volume
        self.altitude_hi = sv.altitude_hi
        self.altitude_lo = sv.altitude_lo
        if sv.footprint is None:
            raise errors.bad_request("spatial_volume missing required footprint")
        self.cells = sv.footprint.calculate_covering()

    def adjust_time_range(self, now: datetime, old: "Subscription | None") -> None:
        """subscriptions.go:135-173: clock-skew gate, defaulting rules and
        the 24h cap."""
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

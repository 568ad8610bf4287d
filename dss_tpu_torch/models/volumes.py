"""4D volumes: the universal spatial-temporal extent type.

Mirrors the upstream DSS's pkg/models/geo.go: Volume4D/Volume3D with a
Geometry footprint (polygon / circle / precomputed cell set), and
UnionVolumes4D which takes the envelope in time and altitude and the
union of coverings in space (geo.go:124-190).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import List, Optional

import numpy as np

from dss_tpu_torch.geo import covering as geo_covering


@dataclass
class LatLngPoint:
    lat: float
    lng: float


class Geometry:
    """A footprint that can compute its level-13 cell covering."""

    def calculate_covering(self) -> np.ndarray:  # uint64 cell ids
        raise NotImplementedError


@dataclass
class GeoPolygon(Geometry):
    vertices: List[LatLngPoint]

    def calculate_covering(self) -> np.ndarray:
        return geo_covering.covering_polygon(
            [(v.lat, v.lng) for v in self.vertices]
        )


@dataclass
class GeoCircle(Geometry):
    center: LatLngPoint
    radius_meter: float

    def calculate_covering(self) -> np.ndarray:
        return geo_covering.covering_circle(
            self.center.lat, self.center.lng, self.radius_meter
        )


@dataclass
class GeoCellUnion(Geometry):
    """A precomputed covering (reference precomputedCellGeometry)."""

    cells: np.ndarray  # uint64

    def calculate_covering(self) -> np.ndarray:
        return np.asarray(self.cells, dtype=np.uint64)


@dataclass
class Volume3D:
    footprint: Optional[Geometry] = None
    altitude_lo: Optional[float] = None
    altitude_hi: Optional[float] = None

    def calculate_covering(self) -> np.ndarray:
        if self.footprint is None:
            raise ValueError("missing footprint")
        # canonical (sorted, deduped) at ingress — one covering form
        # shared by read-cache keying and the DAR pack path
        return geo_covering.canonical_cells(
            self.footprint.calculate_covering()
        )


@dataclass
class Volume4D:
    spatial_volume: Optional[Volume3D] = None
    start_time: Optional[datetime] = None
    end_time: Optional[datetime] = None

    def calculate_spatial_covering(self) -> np.ndarray:
        if self.spatial_volume is None:
            raise ValueError("missing spatial volume")
        return self.spatial_volume.calculate_covering()


def union_volumes_4d(volumes: List[Volume4D]) -> Volume4D:
    """Envelope union: earliest start, latest end, min alt-lo, max alt-hi,
    union of coverings (reference pkg/models/geo.go:124-190)."""
    result = Volume4D()
    merged_cells: set[int] = set()
    have_footprint = False
    for volume in volumes:
        if volume.end_time is not None:
            if result.end_time is None or volume.end_time > result.end_time:
                result.end_time = volume.end_time
        if volume.start_time is not None:
            if result.start_time is None or volume.start_time < result.start_time:
                result.start_time = volume.start_time
        sv = volume.spatial_volume
        if sv is not None:
            if result.spatial_volume is None:
                result.spatial_volume = Volume3D()
            rsv = result.spatial_volume
            if sv.altitude_lo is not None:
                if rsv.altitude_lo is None or sv.altitude_lo < rsv.altitude_lo:
                    rsv.altitude_lo = sv.altitude_lo
            if sv.altitude_hi is not None:
                if rsv.altitude_hi is None or sv.altitude_hi > rsv.altitude_hi:
                    rsv.altitude_hi = sv.altitude_hi
            if sv.footprint is not None:
                cells = sv.footprint.calculate_covering()
                merged_cells.update(int(c) for c in cells)
                have_footprint = True
    if have_footprint:
        result.spatial_volume.footprint = GeoCellUnion(
            np.array(sorted(merged_cells), dtype=np.uint64)
        )
    return result

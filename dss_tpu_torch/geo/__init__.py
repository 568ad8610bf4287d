"""Spherical geometry for the DAR: S2 cells at level 13.

The port of the reference's `dss_tpu/geo`:

  - s2cell: cell-id math (lat/lng -> leaf cell, parents, corners,
    neighbors, DAR keys) as vectorized numpy.
  - covering: polygon / circle / polyline coverings at level 13 with
    the upstream DSS's validation semantics (max area, winding-order
    retry, degenerate-loop polyline fallback), numpy path only.
"""

from dss_tpu_torch.geo.s2cell import (  # noqa: F401
    MAX_LEVEL,
    DAR_LEVEL,
    cell_id_from_latlng,
    cell_id_from_point,
    cell_to_dar_key,
    dar_key_to_cell,
    cell_level,
    cell_parent,
    cell_corners,
    cell_center,
    cell_token,
    latlng_to_xyz,
    xyz_to_latlng,
)
from dss_tpu_torch.geo.covering import (  # noqa: F401
    MAX_AREA_KM2,
    AreaTooLargeError,
    BadAreaError,
    covering_from_loop_points,
    covering_polygon,
    covering_circle,
    area_to_cell_ids,
    loop_area_km2,
    validate_cell,
)

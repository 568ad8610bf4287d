"""Shared value types: IDs, owners, versions, OVNs, 4D volumes."""

from dss_tpu_torch.models.core import (  # noqa: F401
    ID,
    Owner,
    Version,
    OVN,
    new_ovn_from_time,
    validate_uss_base_url,
    validate_uuid,
)
from dss_tpu_torch.models.volumes import (  # noqa: F401
    LatLngPoint,
    GeoPolygon,
    GeoCircle,
    GeoCellUnion,
    Volume3D,
    Volume4D,
    union_volumes_4d,
)

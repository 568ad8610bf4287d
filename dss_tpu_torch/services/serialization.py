"""JSON (proto-JSON wire shapes) <-> model conversion.

The wire shapes follow the reference's generated protos as rendered by
grpc-gateway (pkg/api/v1/ridpb, scdpb): snake_case fields, RFC3339
timestamps; SCD wraps times as {"value": ..., "format": "RFC3339"} and
altitudes as {"value": ..., "reference": "W84", "units": "M"}
(pkg/models/geo.go:510-580).
"""

from __future__ import annotations

import re
from datetime import datetime, timezone
from typing import Optional

from dss_tpu_torch import errors
from dss_tpu_torch.models import rid as ridm
from dss_tpu_torch.models import scd as scdm
from dss_tpu_torch.models.volumes import (
    GeoCircle,
    GeoPolygon,
    LatLngPoint,
    Volume3D,
    Volume4D,
)

TIME_FORMAT_RFC3339 = "RFC3339"


def num(v, what: str, default: float = 0.0) -> float:
    """Coerce an untrusted JSON scalar to float; 400 on garbage."""
    if v is None:
        v = default
    try:
        return float(v)
    except (TypeError, ValueError):
        raise errors.bad_request(f"bad {what}: {v!r}")


def int_field(v, what: str, default: int = 0) -> int:
    """Coerce an untrusted JSON scalar to int; 400 on garbage."""
    if v is None:
        v = default
    try:
        return int(v)
    except (TypeError, ValueError):
        raise errors.bad_request(f"bad {what}: {v!r}")


def _dict_field(v, what: str) -> dict:
    """Untrusted JSON object field: None -> {}, non-dict -> 400."""
    if v is None:
        return {}
    if not isinstance(v, dict):
        raise errors.bad_request(f"bad {what}: expected object")
    return v


def _list_field(v, what: str) -> list:
    """Untrusted JSON array field: None -> [], non-list -> 400; every
    element must be an object."""
    if v is None:
        return []
    if not isinstance(v, list) or any(not isinstance(e, dict) for e in v):
        raise errors.bad_request(f"bad {what}: expected array of objects")
    return v


def parse_time(s: str) -> datetime:
    """RFC3339 -> aware UTC datetime."""
    if not isinstance(s, str) or not s:
        raise ValueError(f"bad timestamp: {s!r}")
    raw = s.strip()
    if raw.endswith(("z", "Z")):
        raw = raw[:-1] + "+00:00"
    # Python < 3.11 fromisoformat only accepts 3- or 6-digit fractional
    # seconds; RFC3339 allows any width (format_time itself emits
    # trailing-zero-stripped fractions) — pad to 6
    m = re.fullmatch(r"(.*T\d\d:\d\d:\d\d)\.(\d+)(.*)", raw)
    if m and len(m.group(2)) not in (3, 6):
        frac = (m.group(2) + "000000")[:6]
        raw = f"{m.group(1)}.{frac}{m.group(3)}"
    t = datetime.fromisoformat(raw)
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t.astimezone(timezone.utc)


def format_time(t: Optional[datetime]) -> Optional[str]:
    if t is None:
        return None
    t = t.astimezone(timezone.utc)
    if t.microsecond:
        return t.strftime("%Y-%m-%dT%H:%M:%S.%f").rstrip("0") + "Z"
    return t.strftime("%Y-%m-%dT%H:%M:%SZ")


# ---------------------------------------------------------------------------
# RID shapes (ridpb)
# ---------------------------------------------------------------------------


def volume4d_from_rid_json(d: dict) -> Volume4D:
    """ridpb.Volume4D: spatial_volume{footprint{vertices[{lat,lng}]},
    altitude_lo, altitude_hi}, time_start, time_end."""
    if not isinstance(d, dict):
        raise errors.bad_request("bad extents")
    result = Volume4D()
    if d.get("time_start") is not None:
        try:
            result.start_time = parse_time(d["time_start"])
        except ValueError as e:
            raise errors.bad_request(f"bad extents: {e}")
    if d.get("time_end") is not None:
        try:
            result.end_time = parse_time(d["time_end"])
        except ValueError as e:
            raise errors.bad_request(f"bad extents: {e}")
    space = d.get("spatial_volume")
    if space is None:
        raise errors.bad_request("bad extents: missing required spatial_volume")
    space = _dict_field(space, "spatial_volume")
    footprint = space.get("footprint")
    if footprint is None:
        raise errors.bad_request(
            "bad extents: spatial_volume missing required footprint"
        )
    footprint = _dict_field(footprint, "footprint")
    vertices = [
        LatLngPoint(lat=num(v.get("lat"), "vertex lat"), lng=num(v.get("lng"), "vertex lng"))
        for v in _list_field(footprint.get("vertices"), "vertices")
    ]
    result.spatial_volume = Volume3D(
        footprint=GeoPolygon(vertices=vertices),
        # proto3 scalars default to 0 when omitted (reference keeps them)
        altitude_lo=num(space.get("altitude_lo"), "altitude_lo"),
        altitude_hi=num(space.get("altitude_hi"), "altitude_hi"),
    )
    return result


def isa_to_json(isa: ridm.IdentificationServiceArea) -> dict:
    out = {
        "id": isa.id,
        "owner": isa.owner,
        "flights_url": isa.url,
        "version": str(isa.version) if isa.version else "",
    }
    if isa.start_time is not None:
        out["time_start"] = format_time(isa.start_time)
    if isa.end_time is not None:
        out["time_end"] = format_time(isa.end_time)
    return out


def rid_sub_to_json(sub: ridm.Subscription) -> dict:
    out = {
        "id": sub.id,
        "owner": sub.owner,
        "callbacks": {"identification_service_area_url": sub.url},
        "notification_index": sub.notification_index,
        "version": str(sub.version) if sub.version else "",
    }
    if sub.start_time is not None:
        out["time_start"] = format_time(sub.start_time)
    if sub.end_time is not None:
        out["time_end"] = format_time(sub.end_time)
    return out


def rid_sub_to_notify_json(sub: ridm.Subscription) -> dict:
    """ridpb.SubscriberToNotify (rid/models/subscriptions.go:55-65)."""
    return {
        "url": sub.url,
        "subscriptions": [
            {
                "notification_index": sub.notification_index,
                "subscription_id": sub.id,
            }
        ],
    }


# ---------------------------------------------------------------------------
# SCD shapes (scdpb)
# ---------------------------------------------------------------------------


def _scd_time(d) -> Optional[datetime]:
    if d is None:
        return None
    value = d.get("value") if isinstance(d, dict) else d
    if value is None:
        return None
    try:
        return parse_time(value)
    except ValueError as e:
        raise errors.bad_request(f"bad time: {e}")


def scd_time_json(t: Optional[datetime]) -> Optional[dict]:
    if t is None:
        return None
    return {"value": format_time(t), "format": TIME_FORMAT_RFC3339}


def _altitude_value(d) -> Optional[float]:
    if d is None:
        return None
    if isinstance(d, dict):
        return num(d.get("value"), "altitude value")
    return num(d, "altitude")


def altitude_json(v: Optional[float]) -> Optional[dict]:
    if v is None:
        return None
    return {"reference": "W84", "units": "M", "value": float(v)}


def volume4d_from_scd_json(d: dict) -> Volume4D:
    """scdpb.Volume4D: volume{outline_polygon|outline_circle,
    altitude_lower, altitude_upper}, time_start, time_end
    (pkg/models/geo.go:428-508)."""
    if not isinstance(d, dict):
        raise errors.bad_request("bad volume")
    result = Volume4D(
        start_time=_scd_time(d.get("time_start")),
        end_time=_scd_time(d.get("time_end")),
    )
    vol3 = _dict_field(d.get("volume"), "volume")
    polygon = vol3.get("outline_polygon")
    circle = vol3.get("outline_circle")
    if polygon is not None and circle is not None:
        raise errors.bad_request(
            "both circle and polygon specified in outline geometry"
        )
    footprint = None
    if polygon is not None:
        polygon = _dict_field(polygon, "outline_polygon")
        footprint = GeoPolygon(
            vertices=[
                LatLngPoint(
                    lat=num(v.get("lat"), "vertex lat"),
                    lng=num(v.get("lng"), "vertex lng"),
                )
                for v in _list_field(polygon.get("vertices"), "vertices")
            ]
        )
    elif circle is not None:
        circle = _dict_field(circle, "outline_circle")
        center = _dict_field(circle.get("center"), "circle center")
        radius = circle.get("radius") or {}
        units = radius.get("units", "M") if isinstance(radius, dict) else "M"
        factor = 1.0 if units == "M" else 0.0  # unknown units -> 0 (reference map)
        footprint = GeoCircle(
            center=LatLngPoint(
                lat=num(center.get("lat"), "circle center lat"),
                lng=num(center.get("lng"), "circle center lng"),
            ),
            radius_meter=factor
            * num(radius.get("value") if isinstance(radius, dict) else radius, "circle radius"),
        )
    result.spatial_volume = Volume3D(
        footprint=footprint,
        altitude_lo=_altitude_value(vol3.get("altitude_lower")),
        altitude_hi=_altitude_value(vol3.get("altitude_upper")),
    )
    return result


def op_to_json(op: scdm.Operation) -> dict:
    out = {
        "id": op.id,
        "ovn": op.ovn,
        "owner": op.owner,
        "version": op.version,
        "uss_base_url": op.uss_base_url,
        "subscription_id": op.subscription_id,
    }
    if op.start_time is not None:
        out["time_start"] = scd_time_json(op.start_time)
    if op.end_time is not None:
        out["time_end"] = scd_time_json(op.end_time)
    return out


def constraint_to_json(cst: scdm.Constraint) -> dict:
    """scdpb.ConstraintReference wire shape — the same field set as an
    operation reference minus state/subscription (a constraint is not a
    negotiated intent)."""
    out = {
        "id": cst.id,
        "ovn": cst.ovn,
        "owner": cst.owner,
        "version": cst.version,
        "uss_base_url": cst.uss_base_url,
    }
    if cst.start_time is not None:
        out["time_start"] = scd_time_json(cst.start_time)
    if cst.end_time is not None:
        out["time_end"] = scd_time_json(cst.end_time)
    return out


def scd_sub_to_json(sub: scdm.Subscription) -> dict:
    out = {
        "id": sub.id,
        "version": sub.version,
        "notification_index": sub.notification_index,
        "uss_base_url": sub.base_url,
        "notify_for_operations": sub.notify_for_operations,
        "notify_for_constraints": sub.notify_for_constraints,
        "implicit_subscription": sub.implicit_subscription,
        "dependent_operations": list(sub.dependent_operations),
    }
    if sub.start_time is not None:
        out["time_start"] = scd_time_json(sub.start_time)
    if sub.end_time is not None:
        out["time_end"] = scd_time_json(sub.end_time)
    return out


def scd_subscribers_to_notify_json(subs) -> list:
    """Group subscription states by USS base URL (pkg/scd/server.go:31-50)."""
    by_url = {}
    for sub in subs:
        by_url.setdefault(sub.base_url, []).append(
            {
                "subscription_id": sub.id,
                "notification_index": sub.notification_index,
            }
        )
    return [
        {"uss_base_url": url, "subscriptions": states}
        for url, states in by_url.items()
    ]

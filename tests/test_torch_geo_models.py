"""The port's geometry and models against the reference's.

Coverings: `covering_polygon`, `covering_circle` and `area_to_cell_ids`
give the same cell ids, or the same error, as the reference's on the
cases of tests/test_covering.py and tests/test_covering_parity.py.  The
reference may answer from its native C++ covering, which
tests/test_native_covering.py pins equal to its Python path; the port
runs the Python path only.  The S2 cell math is compared on seeded
points, and the models' validation rules (versions, OVNs, UUIDs, base
URLs, time ranges, volumes, errors) raise the same errors.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from dss_tpu import clock as r_clock
from dss_tpu import errors as r_errors
from dss_tpu.geo import covering as r_cov
from dss_tpu.geo import s2cell as r_s2
from dss_tpu.models import core as r_core
from dss_tpu.models import rid as r_rid
from dss_tpu.models import scd as r_scd
from dss_tpu.models import volumes as r_vol
from dss_tpu_torch import clock as p_clock
from dss_tpu_torch import errors as p_errors
from dss_tpu_torch.geo import covering as p_cov
from dss_tpu_torch.geo import s2cell as p_s2
from dss_tpu_torch.models import core as p_core
from dss_tpu_torch.models import rid as p_rid
from dss_tpu_torch.models import scd as p_scd
from dss_tpu_torch.models import volumes as p_vol


def outcome(fn, *a):
    """-> ("ok", value as plain data) or ("err", class name, message)."""
    try:
        out = fn(*a)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        msg = e.message if hasattr(e, "message") else str(e)
        code = int(e.code) if hasattr(e, "code") else None
        return ("err", type(e).__name__, code, msg)
    if isinstance(out, np.ndarray):
        return ("ok", str(out.dtype), out.tolist())
    return ("ok", out)


def both(name, *a):
    r = outcome(getattr(r_cov, name), *a)
    p = outcome(getattr(p_cov, name), *a)
    return r, p


def square(lat, lng, h):
    return [(lat - h, lng - h), (lat - h, lng + h),
            (lat + h, lng + h), (lat + h, lng - h)]


# the loops of tests/test_covering.py and tests/test_covering_parity.py
ADVERSARIAL = [
    [(37.427636, -122.170502), (37.408799, -122.064069),
     (37.421265, -122.086504)],
    [(0.0, 0.0), (0.0, 0.005), (-0.005, 0.0025)],
    [(35.20, 44.95), (35.20, 45.05), (35.30, 45.05), (35.30, 44.95)],
    [(35.20, 44.96), (35.30, 45.04), (35.22, 45.08)],
    [(-0.01, -0.01), (-0.01, 0.01), (0.01, 0.01), (0.01, -0.01)],
    [(40.0, -100.0), (40.001, -100.0), (40.0005, -99.9)],
]
POLYGONS = ADVERSARIAL + [
    square(37.0, -122.0, 0.05),
    square(47.6, -122.3, 0.04),
    square(1.0, 2.0, 0.05),
    list(reversed(square(1.0, 2.0, 0.05))),
    square(0.0, 0.0, 0.5),  # too large
    [(0.0, 0.0), (0.0, 0.02), (0.0, 0.04)],  # degenerate: polyline
    [(91.0, 0.0), (0.0, 1.0), (1.0, 1.0)],  # bad latitude
    [(0.0, 0.0), (0.0, 1.0)],  # too few points
    square(40.0, -100.0, 0.08),  # near the area limit
    [(40.0, -100.0), (40.5, -99.5), (40.501, -99.5)],  # thin sliver
    list(reversed(ADVERSARIAL[2])),
]
CIRCLES = [
    (52.5, 13.4, 2000.0), (10.0, 10.0, 3000.0), (40.0, -100.0, 2000.0),
    (52.5, 13.4, 0.0), (95.0, 13.4, 100.0), (40.0, -100.0, 19_900_000.0),
    (-33.9, 151.2, 150.0), (35.25, 45.0, 5000.0),
]
AREAS = [
    "37.0,-122.0,37.05,-122.0,37.05,-122.05,37.0,-122.05",
    "37.0,-122.0,37.05",
    "37.0,-122.0,37.05,-122.0",
    "37.0,-122.0,37.05,-122.0,bogus,-122.05",
    "37.427636,-122.170502,37.408799,-122.064069,37.421265,-122.086504",
    "37.4047,-122.1474,37.4037,-122.1485,37.4035,-122.1466",
    "0.000,0.000,0.000,0.005,-0.005,0.0025",
    "37.4047,-122.1474,37.4037,-122.1485,37.4035,-122.1466,"
    "37.4035,-122.1466",
    "",
    "37.427636,-122.170502,37.408799",
]


@pytest.mark.parametrize("case", range(len(POLYGONS)))
def test_covering_polygon_equals_reference(case):
    r, p = both("covering_polygon", POLYGONS[case])
    assert p == r


@pytest.mark.parametrize("case", range(len(CIRCLES)))
def test_covering_circle_equals_reference(case):
    r, p = both("covering_circle", *CIRCLES[case])
    assert p == r


@pytest.mark.parametrize("case", range(len(AREAS)))
def test_area_to_cell_ids_equals_reference(case):
    r, p = both("area_to_cell_ids", AREAS[case])
    assert p == r
    if p[0] == "ok":
        # memoized and read-only in both
        again = p_cov.area_to_cell_ids(AREAS[case])
        assert again is p_cov.area_to_cell_ids(AREAS[case])
        assert not again.flags.writeable


def test_loop_areas_and_validate_cell_equal_reference():
    for lls in POLYGONS[:9]:
        loops = [
            m.Loop(np.asarray([s.latlng_to_xyz(a, b) for a, b in lls]))
            for m, s in ((r_cov, r_s2), (p_cov, p_s2))
        ]
        assert p_cov.loop_area_km2(loops[1]) == r_cov.loop_area_km2(loops[0])
    c13 = p_s2.cell_id_from_latlng(0.0, 0.0, level=13)
    for c in (c13, p_s2.cell_parent(c13, 12)):
        assert outcome(p_cov.validate_cell, c) == outcome(
            r_cov.validate_cell, c)


def test_s2_cell_math_equals_reference():
    rng = np.random.default_rng(7)
    lats = np.concatenate([rng.uniform(-85, 85, 200),
                           [35.264389, -35.264389, 0.0, 45.0, -0.001]])
    lngs = np.concatenate([rng.uniform(-180, 180, 200),
                           [45.0, -135.0, 45.0, 0.0, -45.0]])
    for level in (13, 30):
        a = r_s2.cell_id_from_latlng(lats, lngs, level=level)
        b = p_s2.cell_id_from_latlng(lats, lngs, level=level)
        assert b.tolist() == a.tolist()
    cids = p_s2.cell_id_from_latlng(lats, lngs, level=13)
    assert p_s2.cell_neighbors8_many(cids).tolist() == (
        r_s2.cell_neighbors8_many(cids).tolist())
    assert np.array_equal(p_s2.cell_corners(cids), r_s2.cell_corners(cids))
    assert np.array_equal(p_s2.cell_center(cids), r_s2.cell_center(cids))
    assert [p_s2.cell_token(c) for c in cids[:20]] == [
        r_s2.cell_token(c) for c in cids[:20]]
    assert p_s2.cell_to_dar_key(cids).tolist() == (
        r_s2.cell_to_dar_key(cids).tolist())
    for fn in ("cell_uv_bounds", "cell_ij_bounds"):
        for x, y in zip(getattr(p_s2, fn)(cids), getattr(r_s2, fn)(cids)):
            assert np.array_equal(x, y), fn


# -- models ----------------------------------------------------------------------

T = datetime(2026, 3, 4, 5, 6, 7, 890123, tzinfo=timezone.utc)


def models_log(core, vol, rid, scd, errors, clock):
    out = []
    v = core.Version.from_time(T)
    out += [str(v), v.to_timestamp(), v.empty, v.matches(None),
            core.Version.from_string(str(v)) == v]
    for s in ("", "zzzz", "!", "1" * 20):
        out.append(outcome(core.Version.from_string, s))
    out += [core.new_ovn_from_time(T, "some-id"),
            core.new_ovn_from_time(T.replace(microsecond=0), "some-id"),
            core.new_ovn_from_time(T, "other-id")]
    for u in ("4348c8e5-0b1c-43cf-9114-2e67a4532472", "not-a-uuid", ""):
        out.append(outcome(core.validate_uuid, u))
    for url in ("https://uss.example.com/v1", "http://uss.example.com",
                "ftp://uss.example.com", ""):
        out.append(outcome(core.validate_uss_base_url, url))
    out.append(clock.from_nanos(clock.to_nanos(T)) == T)
    out.append(clock.to_nanos(T.replace(tzinfo=None)))
    # RID time ranges (identification_service_area.go:108-140)
    for start, end, old in (
        (None, T + timedelta(hours=1), None),
        (T - timedelta(hours=1), T + timedelta(hours=1), None),
        (T, None, None),
        (T, T - timedelta(minutes=1), None),
    ):
        isa = rid.IdentificationServiceArea(id="i", owner="o",
                                            start_time=start, end_time=end)
        out.append(outcome(isa.adjust_time_range, T, old))
        out.append((isa.start_time, isa.end_time))
        sub = rid.Subscription(id="s", owner="o", start_time=start,
                               end_time=end)
        out.append(outcome(sub.adjust_time_range, T, None))
        out.append((sub.start_time, sub.end_time))
        ssub = scd.Subscription(id="s", owner="o", start_time=start,
                                end_time=end)
        out.append(outcome(ssub.adjust_time_range, T, None))
        out.append((ssub.start_time, ssub.end_time))
        for cls in (scd.Operation, scd.Constraint):
            rec = cls(id="x", owner="o", start_time=start, end_time=end)
            out.append(outcome(rec.validate_time_range))
    # extents and volumes
    poly = vol.GeoPolygon(vertices=[
        vol.LatLngPoint(a, b) for a, b in square(10.0, 20.0, 0.03)])
    for ext in (
        vol.Volume4D(vol.Volume3D(poly, 50.0, 100.0), T,
                     T + timedelta(hours=1)),
        vol.Volume4D(None, T, T),
        vol.Volume4D(vol.Volume3D(None, 1.0, 2.0), T, T),
    ):
        isa = rid.IdentificationServiceArea(id="i", owner="o")
        out.append(outcome(isa.set_extents, ext))
        out.append(outcome(lambda: isa.cells))
    v1 = vol.Volume4D(vol.Volume3D(poly, 50.0, 100.0), T,
                      T + timedelta(hours=2))
    circle = vol.GeoCircle(vol.LatLngPoint(10.05, 20.0), 1500.0)
    v2 = vol.Volume4D(vol.Volume3D(circle, 20.0, 80.0),
                      T + timedelta(hours=1), T + timedelta(hours=3))
    u = vol.union_volumes_4d([v1, v2])
    out += [u.start_time, u.end_time, u.spatial_volume.altitude_lo,
            u.spatial_volume.altitude_hi,
            outcome(u.calculate_spatial_covering),
            outcome(vol.Volume4D().calculate_spatial_covering)]
    for make in (errors.not_found, errors.bad_request, errors.already_exists,
                 errors.version_mismatch, errors.permission_denied,
                 errors.exhausted, errors.unauthenticated,
                 errors.area_too_large):
        e = make("x")
        out.append((int(e.code), e.http_status, e.message))
    e = errors.missing_ovns([])
    out.append((int(e.code), e.http_status))
    return out


def test_models_equal_reference():
    got = models_log(p_core, p_vol, p_rid, p_scd, p_errors, p_clock)
    want = models_log(r_core, r_vol, r_rid, r_scd, r_errors, r_clock)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, r_core.Version):
            g, w = str(g), str(w)
        assert g == w, k

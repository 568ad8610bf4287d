"""Level-13 cell coverings of footprints, with the reference's semantics.

A copy of the reference's `dss_tpu/geo/covering.py`.  Where the port's
native library (dss_tpu_torch.native, `covering.cc`) is built, the
single-face rect covering takes its C++ fast path, which
tests/test_torch_native.py pins equal to the Python code below cell for
cell; everything else runs the Python code.

Mirrors the behavior of the upstream DSS's pkg/geo/s2.go and
pkg/models/geo.go:

  - coverings are computed at the fixed DAR level 13 (s2.go:16-25);
  - the area limit is 2500 "km^2" computed with the reference's exact
    formula  loop_area_km2 = steradians * 510072000 / 4 * pi
    (s2.go:89-95 — note the formula multiplies rather than divides by
    pi; we reproduce it verbatim for parity);
  - if the loop exceeds the limit the vertex order is reversed once and
    retried (winding-order auto-fix, s2.go:100-110);
  - a degenerate (zero-area) loop falls back to covering the polyline
    of its vertices (s2.go:116-120);
  - circles are covered via an inscribed 20-vertex regular loop
    (pkg/models/geo.go:224-239);
  - "area" strings are 'lat0,lon0,lat1,lon1,...' (s2.go:124-166).

The covering itself is the set of level-13 cells that intersect the
region — the same set an S2 RegionCoverer with MinLevel=MaxLevel=13
produces — computed by a seeded BFS flood fill over the level-13 grid
with spherical cell/loop intersection tests.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

try:
    from dss_tpu_torch import native as _native
except Exception:  # pragma: no cover — native layer is optional
    _native = None

from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.geo.s2cell import (
    DAR_LEVEL,
    cell_corners,
    cell_id_from_point,
    cell_level,
    latlng_to_xyz,
    st_to_uv,
    uv_to_st,
    xyz_to_face_uv,
)

MAX_AREA_KM2 = 2500.0
EARTH_AREA_KM2 = 510072000.0
RADIUS_EARTH_METER = 6371010.0
# Safety valve: densest legal covering is ~MAX_AREA cells plus boundary.
_MAX_COVERING_CELLS = 100_000


def canonical_cells(cells) -> np.ndarray:
    """THE canonical covering form: sorted, deduped uint64 cell ids.

    Applied once at query ingress (RID `_area_to_cells`, SCD
    `Volume3D.calculate_covering`) and assumed by everything
    downstream — the read cache keys on the covering's bytes and the
    DAR pack path sorts per-row — so two syntactically different
    requests for the same area hit the same cache line and the same
    pack layout.  Already-canonical input (the common case: the BFS
    coverings come out sorted-unique) is returned as-is, no copy."""
    a = np.ascontiguousarray(np.asarray(cells, dtype=np.uint64).ravel())
    if len(a) > 1 and not bool(np.all(a[1:] > a[:-1])):
        return np.unique(a)
    return a


class AreaTooLargeError(Exception):
    """Requested area exceeds MAX_AREA_KM2 (maps to HTTP 413)."""


class BadAreaError(Exception):
    """Coordinates did not create a well-formed area."""


# ---------------------------------------------------------------------------
# Spherical predicates (double precision)
# ---------------------------------------------------------------------------


def _cross3(a, b):
    """Manual cross product: identical math to np.cross but without its
    ~50us call overhead (the covering's predicates run on tiny arrays
    where that overhead dominates).  Supports (..., 3) broadcasting."""
    a = np.asarray(a)
    b = np.asarray(b)
    out = np.empty(np.broadcast_shapes(a.shape, b.shape), dtype=np.float64)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    out[..., 0] = a1 * b2 - a2 * b1
    out[..., 1] = a2 * b0 - a0 * b2
    out[..., 2] = a0 * b1 - a1 * b0
    return out


def _sign(a, b, c):
    """Sign of det(a, b, c): +1 if c is left of a->b (CCW), else -1/0."""
    d = np.dot(_cross3(a, b), c)
    if d > 0:
        return 1
    if d < 0:
        return -1
    return 0


def _ordered_ccw(a, b, c, o):
    """True if (a, b, c) appear in CCW order as seen around o."""
    k = 0
    if _sign(b, o, a) >= 0:
        k += 1
    if _sign(c, o, b) >= 0:
        k += 1
    if _sign(a, o, c) > 0:
        k += 1
    return k >= 2


def _same(p, q):
    return bool(np.all(p == q))


def _edges_cross(a, b, c, d):
    """True if great-circle arcs AB and CD (each < pi) cross at an interior
    point.  Computes the great-circle intersection and checks it lies
    strictly within both arcs (robust for long arcs, unlike pure
    side-of-plane tests)."""
    n1 = _cross3(a, b)
    n2 = _cross3(c, d)
    x = _cross3(n1, n2)
    norm = np.linalg.norm(x)
    if norm < 1e-30:
        return False  # coplanar / degenerate
    x = x / norm
    dab = np.dot(a, b)
    dcd = np.dot(c, d)
    for s in (1.0, -1.0):
        p = s * x
        if (
            np.dot(p, a) > dab
            and np.dot(p, b) > dab
            and np.dot(p, c) > dcd
            and np.dot(p, d) > dcd
        ):
            return True
    return False


def _vertex_crossing(a, b, c, d):
    """S2 VertexCrossing semantics for arcs sharing an endpoint: defines a
    consistent parity so a path through a shared vertex counts once."""
    if _same(a, b) or _same(c, d):
        return False
    if _same(a, d):
        return _ordered_ccw(_ortho(a), c, b, a)
    if _same(b, c):
        return _ordered_ccw(_ortho(b), d, a, b)
    if _same(a, c):
        return _ordered_ccw(_ortho(a), d, b, a)
    if _same(b, d):
        return _ordered_ccw(_ortho(b), c, a, b)
    return False


def _edge_or_vertex_crossing(a, b, c, d):
    if _same(a, c) or _same(a, d) or _same(b, c) or _same(b, d):
        return _vertex_crossing(a, b, c, d)
    return _edges_cross(a, b, c, d)


def _ortho(p):
    """A unit vector orthogonal to p."""
    k = int(np.argmin(np.abs(p)))
    axis = np.zeros(3)
    axis[k] = 1.0
    o = _cross3(p, axis)
    return o / np.linalg.norm(o)


class Loop:
    """A closed spherical loop; the interior is on the left of the edges.

    Implements containment via edge-crossing parity from a fixed origin
    point, with the origin's own containment bootstrapped from the
    vertex-1 interior-angle test (the standard S2 construction).
    """

    def __init__(self, vertices_xyz):
        v = np.asarray(vertices_xyz, dtype=np.float64)
        if v.ndim != 2 or v.shape[-1] != 3:
            raise ValueError("vertices must be (N, 3)")
        self.v = v
        self.n = len(v)
        self._origin = np.array([-0.0099994664, 0.0025924542, 0.9999466])
        self._origin /= np.linalg.norm(self._origin)
        # the origin-containment bootstrap costs a scalar crossing walk;
        # computed lazily so area-only uses (the winding/limit checks)
        # never pay it
        self._origin_inside_cache = None

    @property
    def _origin_inside(self) -> bool:
        if self._origin_inside_cache is None:
            if self.n >= 3:
                v1_inside = _ordered_ccw(
                    _ortho(self.v[1]), self.v[0], self.v[2], self.v[1]
                )
                contains_v1 = self._contains_assuming_origin_outside(
                    self.v[1]
                )
                self._origin_inside_cache = v1_inside != contains_v1
            else:
                self._origin_inside_cache = False
        return self._origin_inside_cache

    def _crossing_parity(self, p):
        """Number of loop edges crossed by segment origin->p, mod 2
        (edge-or-vertex crossing semantics)."""
        crossings = 0
        o = self._origin
        for k in range(self.n):
            a = self.v[k]
            b = self.v[(k + 1) % self.n]
            if _edge_or_vertex_crossing(o, p, a, b):
                crossings ^= 1
        return crossings

    def _contains_assuming_origin_outside(self, p):
        return self._crossing_parity(p) == 1

    def contains(self, p):
        """True if unit point p is inside the loop interior."""
        return self._origin_inside != (self._crossing_parity(p) == 1)

    def signed_area(self):
        """Signed spherical area (steradians); positive for CCW loops."""
        if self.n < 3:
            return 0.0
        total = 0.0
        v0 = self.v[0]
        for k in range(1, self.n - 1):
            a, b, c = v0, self.v[k], self.v[k + 1]
            triple = np.dot(_cross3(a, b), c)
            denom = 1.0 + np.dot(a, b) + np.dot(b, c) + np.dot(c, a)
            total += 2.0 * math.atan2(triple, denom)
        return total

    def area(self):
        """Interior area in steradians (interior = left of edges), [0, 4pi]."""
        s = self.signed_area()
        return s if s >= 0 else 4.0 * math.pi + s


def loop_area_km2(loop: Loop) -> float:
    """The reference's loop-area formula, reproduced exactly.

    pkg/geo/s2.go:89-95:  (area_sr * 510072000) / 4 * pi
    (multiplies by pi — the reference's quirk is part of the contract:
    it determines which areas pass the 2500 'km^2' validation gate).
    """
    if loop.n == 0:
        return 0.0
    return (loop.area() * EARTH_AREA_KM2) / 4.0 * math.pi


# ---------------------------------------------------------------------------
# Cell / loop intersection
# ---------------------------------------------------------------------------


def _point_in_cell(p, face, u_lo, u_hi, v_lo, v_hi):
    """True if unit point p lies within the given face-uv rectangle."""
    pf, pu, pv = xyz_to_face_uv(p)
    if int(pf) == int(face):
        return u_lo <= pu <= u_hi and v_lo <= pv <= v_hi
    # p may project onto the cell across a face boundary only at the exact
    # edge; treat different-face points as outside (BFS neighbors cover
    # the adjacent face's cells anyway).
    return False


def _cell_intersects_loop(cell_id, loop: Loop, loop_vertex_cells) -> bool:
    """Conservative-exact test: does the level-13 cell intersect the loop?

    True iff (a) any cell corner is inside the loop, (b) any loop vertex
    lies in the cell, or (c) any loop edge crosses any cell edge.
    """
    corners = cell_corners(cell_id)  # (4, 3)
    for k in range(4):
        if loop.contains(corners[k]):
            return True
    if int(np.uint64(cell_id)) in loop_vertex_cells:
        return True
    face, u_lo, u_hi, v_lo, v_hi = s2cell.cell_uv_bounds(cell_id)
    for k in range(loop.n):
        if _point_in_cell(loop.v[k], face, u_lo, u_hi, v_lo, v_hi):
            return True
    for k in range(loop.n):
        a = loop.v[k]
        b = loop.v[(k + 1) % loop.n]
        for e in range(4):
            c = corners[e]
            d = corners[(e + 1) % 4]
            if _edges_cross(a, b, c, d):
                return True
    return False


def _segment_intersects_cell(a, b, cell_id) -> bool:
    corners = cell_corners(cell_id)
    face, u_lo, u_hi, v_lo, v_hi = s2cell.cell_uv_bounds(cell_id)
    if _point_in_cell(a, face, u_lo, u_hi, v_lo, v_hi):
        return True
    if _point_in_cell(b, face, u_lo, u_hi, v_lo, v_hi):
        return True
    for e in range(4):
        c = corners[e]
        d = corners[(e + 1) % 4]
        if _edges_cross(a, b, c, d):
            return True
    return False


# ---------------------------------------------------------------------------
# Vectorized predicates (batch over candidate cells)
# ---------------------------------------------------------------------------


def _arcs_cross_many(a, b, c, d):
    """Vectorized _edges_cross: arcs A[k]->B[k] vs C[j]->D[j] for every
    (k, j) pair -> bool (K, J).  Same math and strict inequalities as
    the scalar version (identical verdicts)."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    c = np.atleast_2d(c)
    d = np.atleast_2d(d)
    n1 = _cross3(a, b)  # (K, 3)
    n2 = _cross3(c, d)  # (J, 3)
    x = _cross3(n1[:, None, :], n2[None, :, :])  # (K, J, 3)
    norm = np.linalg.norm(x, axis=-1)
    ok = norm >= 1e-30
    with np.errstate(divide="ignore", invalid="ignore"):
        x = x / np.where(norm[..., None] == 0.0, 1.0, norm[..., None])
    dab = np.sum(a * b, axis=-1)  # (K,)
    dcd = np.sum(c * d, axis=-1)  # (J,)
    out = np.zeros(ok.shape, dtype=bool)
    for s in (1.0, -1.0):
        p = s * x  # (K, J, 3)
        out |= (
            (np.sum(p * a[:, None, :], axis=-1) > dab[:, None])
            & (np.sum(p * b[:, None, :], axis=-1) > dab[:, None])
            & (np.sum(p * c[None, :, :], axis=-1) > dcd[None, :])
            & (np.sum(p * d[None, :, :], axis=-1) > dcd[None, :])
        )
    return out & ok


def _points_in_loop(loop: Loop, pts) -> np.ndarray:
    """Vectorized Loop.contains for (P, 3) points -> bool (P,).

    Points exactly equal to a loop vertex (or the parity origin) need
    the vertex-crossing tie-break — those few fall back to the scalar
    path; everything else is one batched crossing-parity computation."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    P = len(pts)
    if P == 0:
        return np.zeros(0, dtype=bool)
    edges_a = loop.v
    edges_b = np.roll(loop.v, -1, axis=0)
    o = loop._origin
    # exact endpoint sharing -> scalar tie-break path
    shared = (
        np.all(pts[:, None, :] == loop.v[None, :, :], axis=-1).any(axis=1)
        | np.all(pts == o, axis=-1)
    )
    arcs_a = np.broadcast_to(o, pts.shape)
    cross = _arcs_cross_many(arcs_a, pts, edges_a, edges_b)  # (P, N)
    parity = (np.sum(cross, axis=1) & 1).astype(bool)
    inside = parity != loop._origin_inside
    if shared.any():
        for k in np.flatnonzero(shared):
            inside[k] = loop.contains(pts[k])
    return inside


def _cells_intersect_loop(cids, loop: Loop, loop_vertex_cells) -> np.ndarray:
    """Vectorized _cell_intersects_loop over (M,) cell ids -> bool (M,)."""
    cids = np.asarray(cids, dtype=np.uint64)
    M = len(cids)
    if M == 0:
        return np.zeros(0, dtype=bool)
    corners = s2cell.cell_corners(cids)  # (M, 4, 3)
    # (a) any corner inside the loop
    hit = _points_in_loop(loop, corners.reshape(-1, 3)).reshape(M, 4).any(axis=1)
    # (b) cell contains a loop vertex (by vertex-cell id)
    if loop_vertex_cells:
        vc = np.fromiter(loop_vertex_cells, dtype=np.uint64,
                         count=len(loop_vertex_cells))
        hit |= np.isin(cids, vc)
    # (c) any loop vertex projects inside the cell's face-uv rect
    face, u_lo, u_hi, v_lo, v_hi = s2cell.cell_uv_bounds(cids)
    pf, pu, pv = xyz_to_face_uv(loop.v)  # (N,)
    in_rect = (
        (np.asarray(face)[:, None] == pf[None, :])
        & (np.asarray(u_lo)[:, None] <= pu[None, :])
        & (pu[None, :] <= np.asarray(u_hi)[:, None])
        & (np.asarray(v_lo)[:, None] <= pv[None, :])
        & (pv[None, :] <= np.asarray(v_hi)[:, None])
    )
    hit |= in_rect.any(axis=1)
    # (d) any loop edge crosses any cell edge
    todo = ~hit
    if todo.any():
        sub = corners[todo]  # (S, 4, 3)
        ca = sub.reshape(-1, 3)  # cell edge starts
        cb = np.roll(sub, -1, axis=1).reshape(-1, 3)  # cell edge ends
        ea = loop.v
        eb = np.roll(loop.v, -1, axis=0)
        cross = _arcs_cross_many(ca, cb, ea, eb)  # (S*4, N)
        hit[todo] = cross.reshape(-1, 4, loop.n).any(axis=(1, 2))
    return hit


def _cells_intersect_segment(cids, a, b) -> np.ndarray:
    """Vectorized _segment_intersects_cell over (M,) cells."""
    cids = np.asarray(cids, dtype=np.uint64)
    M = len(cids)
    if M == 0:
        return np.zeros(0, dtype=bool)
    face, u_lo, u_hi, v_lo, v_hi = s2cell.cell_uv_bounds(cids)
    ends = np.stack([a, b])  # (2, 3)
    pf, pu, pv = xyz_to_face_uv(ends)
    in_rect = (
        (np.asarray(face)[:, None] == pf[None, :])
        & (np.asarray(u_lo)[:, None] <= pu[None, :])
        & (pu[None, :] <= np.asarray(u_hi)[:, None])
        & (np.asarray(v_lo)[:, None] <= pv[None, :])
        & (pv[None, :] <= np.asarray(v_hi)[:, None])
    )
    hit = in_rect.any(axis=1)
    todo = ~hit
    if todo.any():
        corners = s2cell.cell_corners(cids[todo])  # (S, 4, 3)
        ca = corners.reshape(-1, 3)
        cb = np.roll(corners, -1, axis=1).reshape(-1, 3)
        cross = _arcs_cross_many(ca, cb, a[None, :], b[None, :])
        hit[todo] = cross.reshape(-1, 4).any(axis=1)
    return hit


# ---------------------------------------------------------------------------
# Coverings
# ---------------------------------------------------------------------------


def _flood_fill(seeds, batch_predicate):
    """Wave BFS over the level-13 grid from seed cells: each wave of
    candidate cells is tested by ONE vectorized batch_predicate call,
    and the kept cells' 8-neighborhoods form the next wave.  Returns a
    sorted uint64 array."""
    wave = np.unique(np.asarray(list(seeds), dtype=np.uint64))
    seen = set(int(c) for c in wave)
    result = []
    n_result = 0
    while wave.size:
        keep = batch_predicate(wave)
        kept = wave[keep]
        if kept.size:
            result.append(kept)
            n_result += kept.size
            if n_result > _MAX_COVERING_CELLS:
                raise AreaTooLargeError("covering exceeds maximum cell count")
            nbrs = np.unique(
                s2cell.cell_neighbors8_many(kept).ravel()
            )
            fresh = [int(c) for c in nbrs if int(c) not in seen]
            seen.update(fresh)
            wave = np.array(fresh, dtype=np.uint64)
        else:
            wave = np.array([], dtype=np.uint64)
    if not result:
        return np.array([], dtype=np.uint64)
    return np.sort(np.concatenate(result))


def covering_polyline(points_xyz) -> np.ndarray:
    """Level-13 cells intersecting the polyline through the given points."""
    pts = np.asarray(points_xyz, dtype=np.float64)
    if len(pts) == 0:
        return np.array([], dtype=np.uint64)
    result = set()
    for k in range(max(1, len(pts) - 1)):
        a = pts[k]
        b = pts[min(k + 1, len(pts) - 1)]
        seeds = [
            cell_id_from_point(a, level=DAR_LEVEL),
            cell_id_from_point(b, level=DAR_LEVEL),
        ]
        cells = _flood_fill(
            seeds, lambda wave: _cells_intersect_segment(wave, a, b)
        )
        result.update(int(c) for c in cells)
    return np.sort(np.array(sorted(result), dtype=np.uint64))


_RECT_MAX_CELLS = 1 << 16  # rect fast-path cap; beyond it BFS is better
_RECT_CHUNK = 1 << 14  # candidate cells per predicate batch (memory)


def _loop_covering_bfs(loop: Loop, loop_vertex_cells) -> np.ndarray:
    """The wave-BFS covering (handles face wrap exactly); also the
    differential reference for the rect fast path."""
    seeds = [np.uint64(c) for c in loop_vertex_cells]
    return _flood_fill(
        seeds,
        lambda wave: _cells_intersect_loop(wave, loop, loop_vertex_cells),
    )


def _loop_covering(loop: Loop, area_km2: Optional[float] = None) -> np.ndarray:
    # callers have usually just computed the loop area for the
    # winding/limit checks — reuse it (signed_area costs ~8 numpy
    # dispatches per vertex)
    if area_km2 is None:
        area_km2 = loop_area_km2(loop)
    area_ok = area_km2 <= MAX_AREA_KM2

    # native fast path: the C++ library implements exactly the
    # single-face rect covering below (bit-identical predicates).  It
    # returns None whenever any of the fallback conditions hold, and
    # this function continues unchanged.
    if _native is not None and _native.available():
        try:
            cells = _native.loop_covering(loop.v, area_ok)
        except _native.CoveringTooLarge:
            raise AreaTooLargeError("covering exceeds maximum cell count")
        if cells is not None:
            return cells

    vertex_ids = cell_id_from_point(loop.v, level=DAR_LEVEL)
    loop_vertex_cells = {int(c) for c in np.atleast_1d(vertex_ids)}

    # Single-face fast path: every cube face is a gnomonic plane, so a
    # loop edge is a straight segment in UV and stays inside its
    # endpoints' uv bbox; st(u) is monotonic per axis, so the whole
    # boundary lies within the vertices' ij bounding rectangle.  The
    # INTERIOR is only bbox-bounded when it is the small side of the
    # boundary (<= the area gate) — a huge-interior loop (e.g. a circle
    # built around the antipode, which never passes the polygon
    # winding normalization) must take the BFS, where the cell-count
    # cap raises AreaTooLarge instead of silently under-covering.
    # One vectorized predicate pass over the rect (+1-cell touch
    # margin), chunked for bounded temporaries, replaces the wave BFS —
    # 3-4x faster for typical entity footprints.  Oversized rects
    # (legal thin diagonal slivers) stay on the BFS, which only visits
    # cells near the strip.
    faces, i_lo, j_lo, size = s2cell.cell_ij_bounds(
        np.atleast_1d(vertex_ids)
    )
    if (
        len(set(int(f) for f in np.atleast_1d(faces))) == 1
        and area_ok
    ):
        step = int(np.atleast_1d(size)[0])
        lim = 1 << s2cell.MAX_LEVEL
        imin = max(int(i_lo.min()) - step, 0)
        imax = min(int(i_lo.max()) + step, lim - step)
        jmin = max(int(j_lo.min()) - step, 0)
        jmax = min(int(j_lo.max()) + step, lim - step)
        ni = (imax - imin) // step + 1
        nj = (jmax - jmin) // step + 1
        if (
            ni * nj <= _RECT_MAX_CELLS
            and imin > 0
            and jmin > 0
            and imax < lim - step
            and jmax < lim - step
        ):
            ii = imin + np.arange(ni, dtype=np.int64) * step
            jj = jmin + np.arange(nj, dtype=np.int64) * step
            cand = s2cell.cell_parent(
                s2cell.from_face_ij(
                    int(np.atleast_1d(faces)[0]),
                    np.repeat(ii, nj) + step // 2,
                    np.tile(jj, ni) + step // 2,
                ),
                DAR_LEVEL,
            )
            kept = []
            for lo in range(0, len(cand), _RECT_CHUNK):
                chunk = cand[lo : lo + _RECT_CHUNK]
                keep = _cells_intersect_loop(
                    chunk, loop, loop_vertex_cells
                )
                kept.append(chunk[keep])
            out = np.unique(np.concatenate(kept))
            if len(out) > _MAX_COVERING_CELLS:
                raise AreaTooLargeError(
                    "covering exceeds maximum cell count"
                )
            return out

    return _loop_covering_bfs(loop, loop_vertex_cells)


def covering_from_loop_points(points_xyz) -> np.ndarray:
    """Covering of the loop through the given points, with the reference's
    winding-retry / area-limit / polyline-fallback semantics
    (pkg/geo/s2.go:97-122)."""
    # native fast path: winding retry + area gate + rect covering in
    # ONE call (same op order as the code below).  None -> run the full
    # Python path (multi-face, face-edge margin, oversized rect, no
    # library).
    if _native is not None and _native.available():
        arr = np.ascontiguousarray(points_xyz, dtype=np.float64)
        try:
            cells = _native.points_covering(arr, MAX_AREA_KM2)
            if cells is not None:
                return cells
        except _native.AreaTooLarge as e:
            raise AreaTooLargeError(
                f"area is too large ({e.area:f}km² > {MAX_AREA_KM2:f}km²)"
            )
        except _native.Degenerate:
            return covering_polyline(arr)
        except _native.CoveringTooLarge:
            raise AreaTooLargeError("covering exceeds maximum cell count")

    pts = list(np.asarray(points_xyz, dtype=np.float64))
    loop = Loop(np.asarray(pts))
    area = loop_area_km2(loop)
    if area > MAX_AREA_KM2:
        pts.reverse()
        loop = Loop(np.asarray(pts))
    area = loop_area_km2(loop)
    if area > MAX_AREA_KM2:
        raise AreaTooLargeError(
            f"area is too large ({area:f}km² > {MAX_AREA_KM2:f}km²)"
        )
    if area <= 0:
        return covering_polyline(np.asarray(pts))
    return _loop_covering(loop, area_km2=area)


def covering_polygon(vertices_latlng) -> np.ndarray:
    """Covering of a lat/lng polygon (list of (lat, lng) degrees).

    Validation per pkg/models/geo.go:252-268.
    """
    pts = []
    for lat, lng in vertices_latlng:
        if lat > 90.0 or lat < -90.0 or lng > 180.0 or lng < -180.0:
            raise BadAreaError("coordinates did not create a well formed area")
        pts.append(latlng_to_xyz(lat, lng))
    if len(pts) < 3:
        raise BadAreaError("not enough points in polygon")
    return covering_from_loop_points(np.asarray(pts))


def covering_circle(lat, lng, radius_meter) -> np.ndarray:
    """Covering of a circle via an inscribed 20-vertex regular loop
    (pkg/models/geo.go:224-239)."""
    if lat > 90.0 or lat < -90.0 or lng > 180.0 or lng < -180.0:
        raise BadAreaError("coordinates did not create a well formed area")
    if not radius_meter > 0:
        raise BadAreaError("radius must be larger than 0")
    center = latlng_to_xyz(lat, lng)
    radius_angle = radius_meter / RADIUS_EARTH_METER
    # regular loop: 20 vertices CCW around center at the given angular radius
    z = center
    x = _ortho(z)
    y = _cross3(z, x)
    y /= np.linalg.norm(y)
    cos_r = math.cos(radius_angle)
    sin_r = math.sin(radius_angle)
    pts = []
    for k in range(20):
        theta = 2.0 * math.pi * k / 20.0
        p = cos_r * z + sin_r * (math.cos(theta) * x + math.sin(theta) * y)
        pts.append(p / np.linalg.norm(p))
    loop = Loop(np.asarray(pts))
    area = loop_area_km2(loop)
    if area <= 0:
        return covering_polyline(np.asarray(pts))
    return _loop_covering(loop, area_km2=area)


_CACHE_MAX_ENTRIES = 1024
_CACHE_MAX_CELLS_PER_ENTRY = 4096  # bounds worst-case cache to ~32 MB
_area_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
_area_cache_lock = threading.Lock()


def area_to_cell_ids(area: str) -> np.ndarray:
    """Parse 'lat0,lng0,lat1,lng1,...' and return its covering
    (pkg/geo/s2.go:124-166).

    Memoized (LRU 1024, small results only): USS monitoring traffic
    polls the same operating areas over and over, and the covering is a
    pure function of the string.  Oversized coverings (> a few thousand
    cells) are never cached so distinct large areas can't pin hundreds
    of MB.  Cached arrays are returned read-only (shared across
    callers); parse/area failures are not cached."""
    with _area_cache_lock:
        hit = _area_cache.get(area)
        if hit is not None:
            _area_cache.move_to_end(area)
            return hit
    cells = _area_to_cell_ids_impl(area)
    cells.setflags(write=False)
    if len(cells) <= _CACHE_MAX_CELLS_PER_ENTRY:
        with _area_cache_lock:
            _area_cache[area] = cells
            while len(_area_cache) > _CACHE_MAX_ENTRIES:
                _area_cache.popitem(last=False)
    return cells


def _area_to_cell_ids_impl(area: str) -> np.ndarray:
    parts = area.split(",") if area else []
    if len(parts) % 2 == 1:
        raise BadAreaError("odd number of coordinates in area string")
    if len(parts) // 2 < 3:
        raise BadAreaError("not enough points in polygon")
    coords = []
    for raw in parts:
        try:
            coords.append(float(raw.strip()))
        except ValueError:
            raise BadAreaError("coordinates did not create a well formed area")
    # one vectorized conversion (scalar latlng_to_xyz per vertex costs
    # ~25 us each in numpy dispatch — this path is per-request hot)
    pts = latlng_to_xyz(coords[0::2], coords[1::2])
    return covering_from_loop_points(pts)


def validate_cell(cell_id) -> None:
    """Cells handled by the DAR must be at level 13 (pkg/geo/s2.go:50-55)."""
    lvl = int(cell_level(cell_id))
    if lvl != DAR_LEVEL:
        raise BadAreaError("cells must be at level 13 at current implementation")

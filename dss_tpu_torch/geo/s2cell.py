"""S2 cell-id math, vectorized in numpy.

A copy of the reference's `dss_tpu/geo/s2cell.py`.  The upstream DSS
delegates this to github.com/golang/geo/s2 (pkg/geo/s2.go); here it is
implemented from the public S2 geometry scheme so the package is
self-contained:

  - unit sphere <-> cube-face (u,v) via the quadratic projection,
  - (face, i, j) <-> 64-bit Hilbert-curve cell ids,
  - parents / levels / corners / centers / tokens,
  - same-level neighbor enumeration (with cross-face wrap via an
    XYZ round-trip).

The DAR stores footprints at the fixed level 13 (~1 km^2 cells;
reference pkg/geo/s2.go:16-25).  Level-13 cell ids occupy only the top
30 bits of the 64-bit id (3 face bits + 26 position bits + the lsb
marker at bit 34), so they compress losslessly to an int32 "DAR key"
(cell_to_dar_key) — the on-device representation the DAR tables
hold.
"""

from __future__ import annotations

import numpy as np

MAX_LEVEL = 30
DAR_LEVEL = 13
_LOOKUP_BITS = 4
_SWAP_MASK = 1
_INVERT_MASK = 2

# Hilbert curve traversal tables (public S2 scheme).
_POS_TO_IJ = np.array(
    [[0, 1, 3, 2], [0, 2, 3, 1], [3, 2, 0, 1], [3, 1, 0, 2]], dtype=np.int64
)
_POS_TO_ORIENTATION = np.array(
    [_SWAP_MASK, 0, 0, _INVERT_MASK | _SWAP_MASK], dtype=np.int64
)

_lookup_pos = np.zeros(1 << (2 * _LOOKUP_BITS + 2), dtype=np.int64)
_lookup_ij = np.zeros(1 << (2 * _LOOKUP_BITS + 2), dtype=np.int64)


def _init_lookup(level, i, j, orig_orientation, pos, orientation):
    if level == _LOOKUP_BITS:
        ij = (i << _LOOKUP_BITS) + j
        _lookup_pos[(ij << 2) + orig_orientation] = (pos << 2) + orientation
        _lookup_ij[(pos << 2) + orig_orientation] = (ij << 2) + orientation
        return
    level += 1
    i <<= 1
    j <<= 1
    pos <<= 2
    r = _POS_TO_IJ[orientation]
    for index in range(4):
        _init_lookup(
            level,
            i + (int(r[index]) >> 1),
            j + (int(r[index]) & 1),
            orig_orientation,
            pos + index,
            orientation ^ int(_POS_TO_ORIENTATION[index]),
        )


_init_lookup(0, 0, 0, 0, 0, 0)
_init_lookup(0, 0, 0, _SWAP_MASK, 0, _SWAP_MASK)
_init_lookup(0, 0, 0, _INVERT_MASK, 0, _INVERT_MASK)
_init_lookup(0, 0, 0, _SWAP_MASK | _INVERT_MASK, 0, _SWAP_MASK | _INVERT_MASK)


# ---------------------------------------------------------------------------
# Sphere <-> cube-face projections
# ---------------------------------------------------------------------------


def st_to_uv(s):
    """Quadratic ST->UV projection (monotonic, extends smoothly outside [0,1])."""
    s = np.asarray(s, dtype=np.float64)
    return np.where(
        s >= 0.5, (1.0 / 3.0) * (4.0 * s * s - 1.0), (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s))
    )


def uv_to_st(u):
    u = np.asarray(u, dtype=np.float64)
    return np.where(
        u >= 0.0,
        0.5 * np.sqrt(np.maximum(1.0 + 3.0 * u, 0.0)),
        1.0 - 0.5 * np.sqrt(np.maximum(1.0 - 3.0 * u, 0.0)),
    )


def latlng_to_xyz(lat_deg, lng_deg):
    """Degrees lat/lng -> unit XYZ. Broadcasts; returns (..., 3) float64."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    cos_lat = np.cos(lat)
    return np.stack(
        [cos_lat * np.cos(lng), cos_lat * np.sin(lng), np.sin(lat)], axis=-1
    )


def xyz_to_latlng(p):
    p = np.asarray(p, dtype=np.float64)
    lat = np.rad2deg(np.arctan2(p[..., 2], np.hypot(p[..., 0], p[..., 1])))
    lng = np.rad2deg(np.arctan2(p[..., 1], p[..., 0]))
    return lat, lng


def xyz_to_face_uv(p):
    """Unit XYZ -> (face, u, v)."""
    p = np.asarray(p, dtype=np.float64)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    axis = np.where(ax >= ay, np.where(ax >= az, 0, 2), np.where(ay >= az, 1, 2))
    comp = np.take_along_axis(
        np.stack([x, y, z], axis=-1), axis[..., None], axis=-1
    )[..., 0]
    face = np.where(comp >= 0, axis, axis + 3)
    u = np.empty_like(x)
    v = np.empty_like(x)
    # per-face (u, v) from xyz (standard S2 face frames)
    for f, (ufn, vfn) in enumerate(
        [
            (lambda: y / x, lambda: z / x),      # face 0 (+x)
            (lambda: -x / y, lambda: z / y),     # face 1 (+y)
            (lambda: -x / z, lambda: -y / z),    # face 2 (+z)
            (lambda: z / x, lambda: y / x),      # face 3 (-x)
            (lambda: z / y, lambda: -x / y),     # face 4 (-y)
            (lambda: -y / z, lambda: -x / z),    # face 5 (-z)
        ]
    ):
        m = face == f
        if np.any(m):
            with np.errstate(divide="ignore", invalid="ignore"):
                u = np.where(m, ufn(), u)
                v = np.where(m, vfn(), v)
    return face.astype(np.int64), u, v


def face_uv_to_xyz(face, u, v):
    """(face, u, v) -> XYZ (not normalized)."""
    face = np.asarray(face, dtype=np.int64)
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    one = np.ones(np.broadcast_shapes(face.shape, u.shape, v.shape), dtype=np.float64)
    u = np.broadcast_to(u, one.shape)
    v = np.broadcast_to(v, one.shape)
    xs = [
        (one, u, v),        # face 0
        (-u, one, v),       # face 1
        (-u, -v, one),      # face 2
        (-one, -v, -u),     # face 3
        (v, -one, -u),      # face 4
        (v, u, -one),       # face 5
    ]
    x = np.zeros_like(one)
    y = np.zeros_like(one)
    z = np.zeros_like(one)
    for f, (fx, fy, fz) in enumerate(xs):
        m = face == f
        x = np.where(m, fx, x)
        y = np.where(m, fy, y)
        z = np.where(m, fz, z)
    out = np.stack([x, y, z], axis=-1)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# (face, i, j) <-> cell id
# ---------------------------------------------------------------------------


def from_face_ij(face, i, j):
    """(face, i[30-bit], j[30-bit]) -> leaf cell id. Vectorized, uint64."""
    face = np.asarray(face, dtype=np.uint64)
    i = np.asarray(i, dtype=np.uint64)
    j = np.asarray(j, dtype=np.uint64)
    n = face << np.uint64(60)
    bits = (face & np.uint64(_SWAP_MASK)).astype(np.int64)
    mask = np.uint64((1 << _LOOKUP_BITS) - 1)
    for k in range(7, -1, -1):
        ki = ((i >> np.uint64(k * _LOOKUP_BITS)) & mask).astype(np.int64)
        kj = ((j >> np.uint64(k * _LOOKUP_BITS)) & mask).astype(np.int64)
        idx = bits + (ki << (_LOOKUP_BITS + 2)) + (kj << 2)
        bits = _lookup_pos[idx]
        n |= (bits.astype(np.uint64) >> np.uint64(2)) << np.uint64(k * 2 * _LOOKUP_BITS)
        bits = bits & (_SWAP_MASK | _INVERT_MASK)
    return n * np.uint64(2) + np.uint64(1)


def to_face_ij(cell_id):
    """Leaf-or-any cell id -> (face, i, j, orientation) of its leaf-center ij.

    For non-leaf cells, (i, j) is the leaf ij of the cell's min leaf with
    the standard S2 correction (matches S2CellId::ToFaceIJOrientation for
    the purposes of bound computation: callers mask by cell size).
    """
    cid = np.asarray(cell_id, dtype=np.uint64)
    face = (cid >> np.uint64(61)).astype(np.int64)
    bits = face & _SWAP_MASK
    i = np.zeros_like(cid)
    j = np.zeros_like(cid)
    for k in range(7, -1, -1):
        nbits = MAX_LEVEL - 7 * _LOOKUP_BITS if k == 7 else _LOOKUP_BITS
        chunk = (
            (cid >> np.uint64(k * 2 * _LOOKUP_BITS + 1))
            & np.uint64((1 << (2 * nbits)) - 1)
        ).astype(np.int64)
        idx = bits + (chunk << 2)
        bits = _lookup_ij[idx]
        i += (bits >> (_LOOKUP_BITS + 2)).astype(np.uint64) << np.uint64(k * _LOOKUP_BITS)
        j += ((bits >> 2) & ((1 << _LOOKUP_BITS) - 1)).astype(np.uint64) << np.uint64(
            k * _LOOKUP_BITS
        )
        bits = bits & (_SWAP_MASK | _INVERT_MASK)
    return face, i.astype(np.int64), j.astype(np.int64), bits


def cell_lsb(cell_id):
    cid = np.asarray(cell_id, dtype=np.uint64)
    neg = (~cid) + np.uint64(1)
    return cid & neg


def cell_level(cell_id):
    """Level of cell id(s), via position of the lsb marker bit."""
    lsb = cell_lsb(cell_id)
    # log2 of a power of two up to 2^60: float64 conversion is exact.
    tz = np.round(np.log2(lsb.astype(np.float64))).astype(np.int64)
    return MAX_LEVEL - (tz >> 1)


def cell_parent(cell_id, level):
    """Parent of cell id(s) at 'level' (must be <= current level).
    `level` may be a scalar or an array broadcastable against cell_id."""
    cid = np.asarray(cell_id, dtype=np.uint64)
    shift = (
        2 * (MAX_LEVEL - np.asarray(level, dtype=np.int64))
    ).astype(np.uint64)
    new_lsb = np.uint64(1) << shift
    neg = (~new_lsb) + np.uint64(1)  # two's complement of new_lsb
    return (cid & neg) | new_lsb


def cell_id_from_point(p, level=None):
    """Unit XYZ point(s) -> cell id at 'level' (leaf if None)."""
    face, u, v = xyz_to_face_uv(p)
    s = uv_to_st(u)
    t = uv_to_st(v)
    lim = np.int64((1 << MAX_LEVEL) - 1)
    i = np.clip(np.floor(s * (1 << MAX_LEVEL)).astype(np.int64), 0, lim)
    j = np.clip(np.floor(t * (1 << MAX_LEVEL)).astype(np.int64), 0, lim)
    cid = from_face_ij(face, i, j)
    if level is not None:
        cid = cell_parent(cid, level)
    return cid


def cell_id_from_latlng(lat_deg, lng_deg, level=None):
    return cell_id_from_point(latlng_to_xyz(lat_deg, lng_deg), level=level)


# ---------------------------------------------------------------------------
# Cell geometry
# ---------------------------------------------------------------------------


def cell_ij_bounds(cell_id):
    """(face, i_lo, j_lo, size) of the cell's ij square at leaf resolution."""
    cid = np.asarray(cell_id, dtype=np.uint64)
    level = cell_level(cid)
    size = np.int64(1) << (MAX_LEVEL - level)
    face, i, j, _ = to_face_ij(cid)
    i_lo = i & ~(size - 1)
    j_lo = j & ~(size - 1)
    return face, i_lo, j_lo, size


def cell_uv_bounds(cell_id):
    face, i_lo, j_lo, size = cell_ij_bounds(cell_id)
    scale = 1.0 / (1 << MAX_LEVEL)
    u_lo = st_to_uv(i_lo * scale)
    u_hi = st_to_uv((i_lo + size) * scale)
    v_lo = st_to_uv(j_lo * scale)
    v_hi = st_to_uv((j_lo + size) * scale)
    return face, u_lo, u_hi, v_lo, v_hi


def cell_corners(cell_id):
    """4 unit-XYZ corners in CCW order: (..., 4, 3)."""
    face, u_lo, u_hi, v_lo, v_hi = cell_uv_bounds(cell_id)
    us = np.stack([u_lo, u_hi, u_hi, u_lo], axis=-1)
    vs = np.stack([v_lo, v_lo, v_hi, v_hi], axis=-1)
    f = np.broadcast_to(np.asarray(face)[..., None], us.shape)
    return face_uv_to_xyz(f, us, vs)


def cell_center(cell_id):
    face, u_lo, u_hi, v_lo, v_hi = cell_uv_bounds(cell_id)
    return face_uv_to_xyz(face, 0.5 * (u_lo + u_hi), 0.5 * (v_lo + v_hi))


def cell_neighbors8(cell_id):
    """The (up to) 8 same-level neighbors of a single cell id.

    Cross-face wrap is handled by projecting a point just beyond the face
    boundary back onto the sphere and re-looking-up its cell, so corner
    cells naturally yield their (possibly < 8) distinct neighbors.
    """
    cid = np.uint64(cell_id)
    level = int(cell_level(cid))
    face, i_lo, j_lo, size = cell_ij_bounds(cid)
    face, i_lo, j_lo, size = int(face), int(i_lo), int(j_lo), int(size)
    lim = 1 << MAX_LEVEL
    out = []
    scale = 1.0 / lim
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            ni = i_lo + di * size
            nj = j_lo + dj * size
            if 0 <= ni < lim and 0 <= nj < lim:
                nid = cell_parent(from_face_ij(face, ni + size // 2, nj + size // 2), level)
            else:
                # step off the face: project the would-be cell center
                s = (ni + size / 2.0) * scale
                t = (nj + size / 2.0) * scale
                u = st_to_uv(s)
                v = st_to_uv(t)
                p = face_uv_to_xyz(face, u, v)
                nid = cell_id_from_point(p, level=level)
            out.append(np.uint64(nid))
    # dedup while preserving order
    seen = set()
    uniq = []
    for c in out:
        ci = int(c)
        if ci not in seen and ci != int(cid):
            seen.add(ci)
            uniq.append(c)
    return uniq


def cell_neighbors8_many(cell_ids):
    """All 8 same-level neighbors of each cell id, vectorized: (M, 8)
    uint64 (duplicates possible at face corners; callers np.unique).
    Each neighbor is produced at its input cell's own level (like the
    scalar cell_neighbors8).

    Uniform path for in-face and cross-face steps: the would-be
    neighbor's center (i, j) maps through st->uv->xyz (st_to_uv
    extrapolates monotonically beyond [0, 1], landing the point on the
    adjacent face) and back through cell_id_from_point."""
    cids = np.asarray(cell_ids, dtype=np.uint64)
    level = cell_level(cids)  # (M,)
    face, i_lo, j_lo, size = cell_ij_bounds(cids)
    scale = 1.0 / (1 << MAX_LEVEL)
    offs = np.array(
        [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
         if not (di == 0 and dj == 0)],
        dtype=np.int64,
    )  # (8, 2)
    s = (i_lo[..., None] + offs[None, :, 0] * size[..., None]
         + size[..., None] / 2.0) * scale
    t = (j_lo[..., None] + offs[None, :, 1] * size[..., None]
         + size[..., None] / 2.0) * scale
    u = st_to_uv(s)
    v = st_to_uv(t)
    f = np.broadcast_to(np.asarray(face)[..., None], u.shape)
    p = face_uv_to_xyz(f, u, v)  # (M, 8, 3)
    return cell_id_from_point(p, level=np.asarray(level)[..., None])


def cell_token(cell_id):
    """Hex token of a cell id with trailing zeros stripped (S2 convention)."""
    cid = int(np.uint64(cell_id))
    if cid == 0:
        return "X"
    return f"{cid:016x}".rstrip("0")


def cell_from_token(token):
    return np.uint64(int(token.ljust(16, "0"), 16))


# ---------------------------------------------------------------------------
# DAR keys: level-13 cells as int32
# ---------------------------------------------------------------------------

_DAR_SHIFT = 2 * (MAX_LEVEL - DAR_LEVEL)  # 34: lsb bit position at level 13


def cell_to_dar_key(cell_id):
    """Level-13 cell id(s) -> int32 DAR key (top 30 bits, lossless)."""
    cid = np.asarray(cell_id, dtype=np.uint64)
    return (cid >> np.uint64(_DAR_SHIFT)).astype(np.int32)


def dar_key_to_cell(key):
    """int32 DAR key(s) -> level-13 cell id(s)."""
    k = np.asarray(key, dtype=np.int64).astype(np.uint64)
    return k << np.uint64(_DAR_SHIFT)

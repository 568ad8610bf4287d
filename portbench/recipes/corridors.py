"""Recipe `corridors`: flight corridors over one metro region.

The region is a square of `metro_side_cells` x `metro_side_cells`
level-13 cells of S2 face `face`, its corner at level-13 cell
`metro_corner`; a cell's key is its DAR key (`gen.dar_keys`), so the
region's keys follow the Hilbert curve as the DSS's do.  An intent
covers a corridor of `cells_per_intent` edge-adjacent cells with at
most one turn: a straight run of k cells (k uniform in 1..cells) in
one of the four directions, then the rest at a right angle, placed
uniformly in the region (a corridor that would leave the region is
moved back inside).  Its altitude band is U(band_m) metres above
U(alt_lo_m), its window starts a whole number of hours in
U(start_hours) from NOW and lasts U(hours) whole hours; owner i mod
`owners`; a UUIDv4 id.

A query is a USS's search of the area of a flight it plans: a corridor
of `cells` cells drawn the same way, a `band_m` band over U(alt_lo_m),
a window of `hours` starting a whole number of hours in U(start_hours)
from NOW.
"""

from __future__ import annotations

import numpy as np

from portbench import gen

# the four unit steps on a face's (x, y) grid
STEPS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int64)


def corridor_keys(data: dict, r: np.random.Generator, m: int,
                  cells: int) -> np.ndarray:
    """m corridors of `cells` cells in the region -> their sorted DAR
    keys, i32 [m, cells]."""
    side = data["metro_side_cells"]
    k = r.integers(1, cells + 1, m)
    d1 = r.integers(0, 4, m)
    d2 = (d1 + 2 * r.integers(0, 2, m) + 1) % 4  # a right angle either way
    t = np.arange(cells)[None, :]
    first = t < k[:, None]
    # cell t: t steps along d1 while t < k, then k-1 along d1 and
    # t-k+1 along d2
    a = np.where(first, t, k[:, None] - 1)
    b = np.where(first, 0, t - k[:, None] + 1)
    xy = (a[..., None] * STEPS[d1][:, None, :]
          + b[..., None] * STEPS[d2][:, None, :])
    start = r.integers(0, side, (m, 1, 2))
    xy = xy + start
    lo = xy.min(axis=1, keepdims=True)
    hi = xy.max(axis=1, keepdims=True)
    xy = xy - np.minimum(lo, 0) - np.maximum(hi - (side - 1), 0)
    return np.sort(region_keys(data)[xy[..., 0], xy[..., 1]], axis=1)


def region_keys(data: dict) -> np.ndarray:
    """The DAR key of every cell of the region, i32 [side, side]."""
    side = data["metro_side_cells"]
    x0, y0 = data["metro_corner"]
    x, y = np.meshgrid(np.arange(side) + x0, np.arange(side) + y0,
                       indexing="ij")
    return gen.dar_keys(data["face"], x, y)


def intents(data: dict, seed: int) -> gen.Intents:
    r = gen.rng(seed, gen.DATA)
    n = data["intents"]
    keys = corridor_keys(data, r, n, data["cells_per_intent"])
    alt_lo = r.uniform(*data["alt_lo_m"], n).astype(np.float32)
    alt_hi = alt_lo + r.uniform(*data["band_m"], n).astype(np.float32)
    lo_h, hi_h = data["start_hours"]
    t0 = gen.NOW + r.integers(lo_h, hi_h + 1, n) * gen.HOUR
    d_lo, d_hi = data["hours"]
    t1 = t0 + r.integers(d_lo, d_hi + 1, n) * gen.HOUR
    owner = (np.arange(n) % data["owners"]).astype(np.int32)
    ids = gen.uuid4_ids(r, n)
    return gen.Intents(ids, keys, alt_lo, alt_hi, t0.astype(np.int64),
                       t1.astype(np.int64), owner)


def queries(data: dict, query: dict, r: np.random.Generator,
            m: int) -> gen.Queries:
    keys = corridor_keys(data, r, m, query["cells"])
    alo = r.uniform(*query["alt_lo_m"], m).astype(np.float32)
    ahi = (alo + np.float32(query["band_m"])).astype(np.float32)
    lo_h, hi_h = query["start_hours"]
    t0 = gen.NOW + r.integers(lo_h, hi_h + 1, m) * gen.HOUR
    t1 = t0 + query["hours"] * gen.HOUR
    return gen.Queries(keys, alo, ahi, t0.astype(np.int64),
                       t1.astype(np.int64))

"""The port's native (C++) host halves against its numpy paths and the
reference, bit for bit.

The cases of tests/test_native_{fastwin,hostquery,covering}.py, run on
the port: dss_tpu_torch.native (built by g++ from the port's own .cc
files into build/native/) must give exactly what the port's numpy
paths give, and what the reference's numpy paths give on the same
inputs (the reference is forced onto numpy, so the comparison never
leans on the reference's library).  Inputs are made from a seed with
numpy.  Exact: no tolerance anywhere.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.oracle import Record as RefRecord
from dss_tpu.dar.pack import pack_records as ref_pack_records
from dss_tpu.geo import covering as ref_cov
from dss_tpu.ops import fastpath as ref_fastpath
from dss_tpu.ops.fastpath import FastTable as RefFastTable

from dss_tpu_torch import native
from dss_tpu_torch.geo import covering
from dss_tpu_torch.geo.covering import (
    MAX_AREA_KM2,
    AreaTooLargeError,
    Loop,
    covering_circle,
    covering_polygon,
    loop_area_km2,
)
from dss_tpu_torch.geo.s2cell import latlng_to_xyz
from dss_tpu_torch.native import _buildlib
from dss_tpu_torch.ops import fastpath
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu_torch.ops.fastpath import BLOCK, FastTable

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ is not on PATH: the port's native library cannot be built",
)

ROOT = Path(__file__).resolve().parents[1]
HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _native_state(monkeypatch):
    """The port's library is built and enabled at the start of every
    test; the reference runs its numpy paths (fastpath and covering)."""
    assert native.ensure_built(), "g++ is present but the build failed"
    fastpath._NATIVE = None
    monkeypatch.setattr(ref_fastpath, "_NATIVE", (None,))
    monkeypatch.setattr(ref_cov, "_native", None)
    yield
    fastpath._NATIVE = None


@contextlib.contextmanager
def numpy_only():
    """Force the port's numpy paths (the way the reference's tests
    reach theirs)."""
    fastpath._NATIVE = (None,)
    try:
        yield
    finally:
        fastpath._NATIVE = None


def test_lib_is_built_from_the_ports_sources_under_build():
    so = Path(native.SO_PATH).resolve()
    assert so.parent == (ROOT / "build" / "native").resolve()
    assert so.exists() and _buildlib.so_fresh()
    sha = so.with_name(so.name + ".sha").read_text().strip()
    assert sha == _buildlib.source_digest()
    srcs = [Path(_buildlib.SRC_DIR) / n for n in _buildlib.SOURCE_NAMES]
    assert all(p.parent == ROOT / "dss_tpu_torch" / "native" for p in srcs)
    assert native.available()
    # the port's bindings hold the port's library, never the
    # reference's libdsscover.so (which the reference's own paths load)
    assert native._lib._name == native.SO_PATH
    assert "libdsscover" not in native._lib._name


def test_build_is_once_per_digest(tmp_path):
    """A second build of fresh sources is a no-op under the lock: the
    library keeps its inode (no recompile, no rename)."""
    before = os.stat(native.SO_PATH).st_ino
    assert _buildlib.build()
    assert os.stat(native.SO_PATH).st_ino == before
    # a separate build directory gets its own library, by rename
    assert _buildlib.build(_buildlib.SRC_DIR, str(tmp_path))
    assert _buildlib.so_fresh(_buildlib.SRC_DIR, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(
        [_buildlib.SO_NAME, _buildlib.DIGEST_NAME, _buildlib.LOCK_NAME]
    )


# ---------------------------------------------------------------------------
# window pack + hit decode (fastwin.cc)
# ---------------------------------------------------------------------------


def _mk_ft(rng, n_post, n_cells, hot_cells=0):
    """(port table, reference table, n_cells) over random sorted
    postings; hot_cells get runs spanning several 128-blocks (the
    multi-window case) and a tenth of the slots are tombstoned."""
    keys = rng.integers(0, n_cells, n_post).astype(np.int32)
    if hot_cells:
        hot = rng.integers(0, n_cells, hot_cells).astype(np.int32)
        keys = np.concatenate([keys, np.repeat(hot, 3 * BLOCK + 17)])
    keys.sort()
    n = len(keys)
    ents = rng.integers(0, max(n // 2, 1), n).astype(np.int32)
    n_slots = int(ents.max()) + 1 if n else 1
    alo = rng.uniform(0, 3000, n).astype(np.float32)
    args = (
        keys, ents, alo, alo + 350,
        np.full(n, NOW - HOUR, np.int64), np.full(n, NOW + HOUR, np.int64),
        np.ones(n, bool),
    )
    slot_live = np.ones(n_slots, bool)
    slot_live[rng.integers(0, n_slots, max(n_slots // 10, 1))] = False
    se = {
        "alt_lo": np.full(n_slots, -np.inf, np.float32),
        "alt_hi": np.full(n_slots, np.inf, np.float32),
        "t0": np.full(n_slots, NO_TIME_LO, np.int64),
        "t1": np.full(n_slots, NO_TIME_HI, np.int64),
        "live": slot_live,
    }
    port = FastTable(*args, slot_exact={k: v.copy() for k, v in se.items()},
                     device="cpu")
    ref = RefFastTable(*args, slot_exact={k: v.copy() for k, v in se.items()})
    return port, ref, n_cells


def _mk_queries(rng, b, w, n_cells, now_vector=False):
    """Open queries (pads -1 included); with now_vector a per-query
    `now` that puts part of the table's window behind some queries."""
    qk = rng.integers(-1, n_cells, (b, w)).astype(np.int32)
    alo = np.full(b, -np.inf, np.float32)
    ahi = np.full(b, np.inf, np.float32)
    t0 = np.full(b, NO_TIME_LO, np.int64)
    t1 = np.full(b, NO_TIME_HI, np.int64)
    now = NOW
    if now_vector:
        alo[1::3] = rng.uniform(0, 3000, len(alo[1::3])).astype(np.float32)
        ahi[1::3] = alo[1::3] + 200
        now = NOW + rng.integers(-2, 3, b).astype(np.int64) * HOUR
    return (qk, alo, ahi, t0, t1), now


def _assert_pack_equal(got, want):
    wins_n, wq_n, wb_n, nw_n = got
    wins_p, wq_p, wb_p, nw_p = want
    assert nw_n == nw_p
    if nw_n == 0:
        assert wins_n is None and wins_p is None
        return
    assert wins_n.dtype == wins_p.dtype and wins_n.shape == wins_p.shape
    np.testing.assert_array_equal(wins_n, wins_p)
    np.testing.assert_array_equal(wq_n, wq_p)
    np.testing.assert_array_equal(wb_n, wb_p)


def _pack_three_ways(port, ref, qk):
    got = port._pack_windows(qk)
    with numpy_only():
        want = port._pack_windows(qk)
    _assert_pack_equal(got, want)
    _assert_pack_equal(got, ref._pack_windows(qk))
    return got


def _same_pairs(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype == np.int64
    assert a[1].dtype == b[1].dtype == np.int64


@pytest.mark.parametrize("seed", range(5))
def test_pack_windows_parity_random(seed):
    rng = np.random.default_rng(seed)
    port, ref, n_cells = _mk_ft(rng, 4000, 700, hot_cells=3)
    qk = rng.integers(-1, n_cells, (257, 5)).astype(np.int32)
    _pack_three_ways(port, ref, qk)


def test_pack_windows_parity_large_sampled():
    """Past the 2^14 postings gate the native path uses the cached
    two-level sample index: the bracketing math is the risky part."""
    rng = np.random.default_rng(42)
    port, ref, n_cells = _mk_ft(rng, 40_000, 2_000, hot_cells=8)
    assert port.n_postings > 1 << 14
    for seed in range(3):
        rng2 = np.random.default_rng(100 + seed)
        qk = rng2.integers(-1, n_cells, (512, 8)).astype(np.int32)
        _pack_three_ways(port, ref, qk)
    assert port._hk_sample is not None and port._hk_sample0 is not None


def test_pack_windows_duplicate_heavy():
    """Sample entries full of duplicates: runs crossing sample-slice
    boundaries must still bracket correctly."""
    rng = np.random.default_rng(7)
    port, ref, n_cells = _mk_ft(rng, 30_000, 40, hot_cells=5)
    qk = rng.integers(-1, n_cells, (300, 4)).astype(np.int32)
    _pack_three_ways(port, ref, qk)


def test_pack_windows_empty_and_miss():
    rng = np.random.default_rng(3)
    port, ref, n_cells = _mk_ft(rng, 2000, 500)
    _pack_three_ways(port, ref, np.full((16, 4), -1, np.int32))
    _pack_three_ways(port, ref, np.full((16, 4), n_cells + 7, np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_fused_table_end_to_end_native_on_and_off(seed):
    """submit + collect through B1's plain version with the native pack
    and decode, with numpy forced, and the reference's FastTable: the
    same (qidx, slot) sequences.  Odd seeds use a per-query `now`."""
    rng = np.random.default_rng(seed)
    port, ref, n_cells = _mk_ft(rng, 6000, 400, hot_cells=2)
    q, now = _mk_queries(rng, 128, 6, n_cells, now_vector=bool(seed % 2))
    got = port.query_fused(*q, now=now)
    with numpy_only():
        want = port.query_fused(*q, now=now)
    _same_pairs(got, want)
    _same_pairs(got, ref.query_fused(*q, now=now))
    assert len(got[0]) > 0


def test_decode_overflow_rerun_is_identical():
    """A word buffer too small for the hits: the rerun at the 4*nw
    bound decodes the same pairs both ways."""
    rng = np.random.default_rng(5)
    port, ref, n_cells = _mk_ft(rng, 5000, 300, hot_cells=2)
    q, now = _mk_queries(rng, 96, 6, n_cells)
    got = port.query_fused(*q, now=now, max_words=8)
    with numpy_only():
        want = port.query_fused(*q, now=now, max_words=8)
    _same_pairs(got, want)
    _same_pairs(got, ref.query_fused(*q, now=now, max_words=8))


def test_decode_drops_tombstones_and_pads():
    """mark_dead after build: the native decode drops the slot exactly
    like the numpy path's post-filter."""
    rng = np.random.default_rng(11)
    port, ref, n_cells = _mk_ft(rng, 3000, 300)
    q, now = _mk_queries(rng, 64, 4, n_cells)
    base = port.query_fused(*q, now=now)
    assert len(base[1]) > 0
    victim = int(base[1][0])
    port.mark_dead(victim)
    ref.mark_dead(victim)
    got = port.query_fused(*q, now=now)
    with numpy_only():
        want = port.query_fused(*q, now=now)
    _same_pairs(got, want)
    _same_pairs(got, ref.query_fused(*q, now=now))
    assert victim not in got[1]


def test_native_wrapper_unavailable_returns_none(monkeypatch):
    """Library gone -> wrappers return None and callers fall back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert not native.available()
    assert native.pack_windows(
        np.zeros(4, np.int32), np.zeros(4, np.int32), 2, BLOCK,
        fastpath.pow2_bucket,
    ) is None
    assert native.decode_hits(
        np.zeros(1, np.int32), np.zeros(1, np.uint32),
        np.zeros(1, np.int32), np.zeros(1, np.int32), 2, BLOCK,
        np.zeros(1, np.int32), 1, np.zeros(1, np.uint8),
    ) is None
    assert native.loop_covering(np.zeros((3, 3)), True) is None
    # and the table takes its numpy paths, with the same answers
    rng = np.random.default_rng(12)
    port, ref, n_cells = _mk_ft(rng, 2000, 200)
    q, now = _mk_queries(rng, 70, 4, n_cells)
    _same_pairs(port.query_fused(*q, now=now), ref.query_fused(*q, now=now))


def test_pack_and_decode_parity_at_scale():
    """One big randomized differential with the sampled two-level index
    engaged (>2^14 postings), hot cells spanning dozens of blocks, a
    2048-query batch and tombstones mid-stream."""
    rng = np.random.default_rng(123)
    port, ref, n_cells = _mk_ft(rng, 60_000, 3_000, hot_cells=12)
    assert port.n_postings > 1 << 14
    q, now = _mk_queries(rng, 2048, 8, n_cells)
    assert _pack_three_ways(port, ref, q[0])[3] > 10_000
    base = port.query_fused(*q, now=now)
    assert len(base[1]) > 0
    for victim in np.unique(base[1])[:50]:
        port.mark_dead(int(victim))
    got = port.query_fused(*q, now=now)
    with numpy_only():
        want = port.query_fused(*q, now=now)
    _same_pairs(got, want)


# ---------------------------------------------------------------------------
# exact host scan (hostquery.cc)
# ---------------------------------------------------------------------------


def _mk_host_table(rng, n, n_cells=300):
    """(port table, reference table) from the reference's pack_records
    over seeded records with open bounds on a share of them."""
    recs = []
    for i in range(n):
        k = np.unique(rng.integers(0, n_cells, rng.integers(1, 7)))
        alo = float(rng.uniform(0, 3000))
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        recs.append(RefRecord(
            entity_id=f"e{i}", keys=k.astype(np.int32),
            alt_lo=alo if i % 3 else -np.inf,
            alt_hi=alo + 350.0 if i % 3 else np.inf,
            t_start=t0 if i % 4 else NO_TIME_LO,
            t_end=t0 + 2 * HOUR if i % 4 else NO_TIME_HI,
            owner_id=i % 5,
        ))
    return _tables_of(recs)


def _tables_of(recs):
    packed = ref_pack_records(recs, pad_postings=False)
    pe = packed.post_ent
    args = (packed.post_key, pe, packed.alt_lo[pe], packed.alt_hi[pe],
            packed.t_start[pe], packed.t_end[pe], packed.active[pe])

    def se():
        return {"alt_lo": packed.alt_lo, "alt_hi": packed.alt_hi,
                "t0": packed.t_start, "t1": packed.t_end,
                "live": packed.active.copy()}

    return (FastTable(*args, slot_exact=se(), device="cpu"),
            RefFastTable(*args, slot_exact=se()))


def _host_queries(rng, b, w=16, key_hi=320):
    qkeys = np.full((b, w), -1, np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, key_hi, rng.integers(1, w)).astype(np.int32))
        qkeys[i, : len(u)] = u
    alo = rng.uniform(-100, 3200, b).astype(np.float32)
    ahi = (alo + rng.uniform(0, 800, b)).astype(np.float32)
    alo[::3] = -np.inf
    ahi[::3] = np.inf
    ts = (NOW + rng.integers(-6, 2, b) * HOUR).astype(np.int64)
    te = ts + rng.integers(1, 8, b) * HOUR
    ts[::4] = NO_TIME_LO
    te[::4] = NO_TIME_HI
    now = (NOW + rng.integers(-3, 3, b) * HOUR).astype(np.int64)
    return (qkeys, alo, ahi, ts, te), now


def _host_three_ways(port, ref, q, now, **kw):
    """query_host_auto native, numpy and the reference's; -> the native
    answer (None = device path), all three asserted equal."""
    got = port.query_host_auto(*q, now=now, **kw)
    with numpy_only():
        want = port.query_host_auto(*q, now=now, **kw)
    ref_ans = ref.query_host_auto(*q, now=now, **kw)
    if got is None:
        assert want is None and ref_ans is None
        return None
    # the numpy scan emits pairs in postings order, the native scan in
    # (query, cell) order: the same multiset, as in the reference
    key = lambda a: sorted(zip(a[0].tolist(), a[1].tolist()))  # noqa: E731
    assert key(got) == key(want) == key(ref_ans)
    assert got[0].dtype == got[1].dtype == np.int64
    return got


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 400), (2, 1500)])
def test_native_host_query_differential(seed, n):
    """Per-query `now` vectors, open and bounded altitudes and times."""
    rng = np.random.default_rng(seed)
    port, ref = _mk_host_table(rng, n)
    hits = 0
    for _ in range(30):
        q, now = _host_queries(rng, int(rng.integers(1, 17)))
        got = _host_three_ways(port, ref, q, now)
        assert got is not None
        hits += len(got[0])
    assert hits > 0


def test_native_candidate_cap_routes_to_device():
    """Past max_candidates the native scan, the numpy gate and the
    reference all say 'device' (None); the raised chunked-route cap
    admits the same batch on every path."""
    recs = [
        RefRecord(entity_id=f"e{i}", keys=np.asarray([5], np.int32),
                  alt_lo=-np.inf, alt_hi=np.inf, t_start=NO_TIME_LO,
                  t_end=NO_TIME_HI, owner_id=0)
        for i in range(FastTable.HOST_MAX_CANDIDATES + 10)
    ]
    port, ref = _tables_of(recs)
    qkeys = np.full((1, 16), -1, np.int32)
    qkeys[0, 0] = 5
    b = np.zeros(1, np.float32)
    q = (qkeys, b - np.inf, b + np.inf, np.full(1, NO_TIME_LO, np.int64),
         np.full(1, NO_TIME_HI, np.int64))
    now = np.full(1, NOW, np.int64)
    assert _host_three_ways(port, ref, q, now) is None
    got = _host_three_ways(port, ref, q, now,
                           max_candidates=FastTable.HOST_ROUTE_MAX_CANDIDATES)
    assert len(got[0]) == len(recs)


def test_query_host_sampled_index_parity():
    """Above 2^14 postings the native scan routes lookups through the
    cached two-level sample index (_sample_index) over a
    duplicate-heavy key space."""
    rng = np.random.default_rng(77)
    port, ref = _mk_host_table(rng, 6000, n_cells=150)
    assert port.n_postings > 1 << 14
    answered = 0
    for seed in range(3):
        r = np.random.default_rng(200 + seed)
        q, now = _host_queries(r, 16, w=8, key_hi=170)
        answered += _host_three_ways(port, ref, q, now) is not None
    assert answered > 0
    assert port._hk_sample is not None and port._hk_sample0 is not None


def test_host_scan_sees_mark_dead_after_caching():
    """The cached live view shares memory with slot_exact["live"]: a
    slot tombstoned after the first native scan never comes back."""
    rng = np.random.default_rng(9)
    port, ref = _mk_host_table(rng, 600)
    q, now = _host_queries(rng, 8)
    base = _host_three_ways(port, ref, q, now)
    assert port._hostq_cols[3].base is not None
    assert np.shares_memory(port._hostq_cols[3], port.slot_exact["live"])
    victims = np.unique(base[1])[:5]
    for v in victims:
        port.mark_dead(int(v))
        ref.mark_dead(int(v))
    got = _host_three_ways(port, ref, q, now)
    assert not set(victims.tolist()) & set(got[1].tolist())


def test_chunked_host_route_native_on_and_off():
    """query_host_chunked (the forced route push's oracle takes) over
    200 rows: the same pairs native, numpy and reference."""
    rng = np.random.default_rng(21)
    port, ref = _mk_host_table(rng, 800)
    q, now = _host_queries(rng, 200)
    got = port.query_host_chunked(*q, now=now)
    with numpy_only():
        want = port.query_host_chunked(*q, now=now)
    key = lambda a: sorted(zip(a[0].tolist(), a[1].tolist()))  # noqa: E731
    assert key(got) == key(want) == key(ref.query_host_chunked(*q, now=now))


# ---------------------------------------------------------------------------
# coverings (covering.cc)
# ---------------------------------------------------------------------------


def _numpy_loop_covering(loop):
    """The port's pure-numpy covering, bypassing the native dispatch."""
    vertex_ids = covering.cell_id_from_point(loop.v, level=covering.DAR_LEVEL)
    cells = {int(c) for c in np.atleast_1d(vertex_ids)}
    return covering._loop_covering_bfs(loop, cells)


def _ref_loop_covering(loop):
    """The reference's pure-numpy covering of the same vertices."""
    rloop = ref_cov.Loop(np.asarray(loop.v))
    vertex_ids = ref_cov.cell_id_from_point(rloop.v, level=ref_cov.DAR_LEVEL)
    cells = {int(c) for c in np.atleast_1d(vertex_ids)}
    return ref_cov._loop_covering_bfs(rloop, cells)


def _rand_small_polygon(rng):
    """Random star polygon that stays simple on the sphere (min radius
    and angular gap keep every feature wider than geodesic bowing)."""
    lat0 = float(rng.uniform(-60, 60))
    lng0 = float(rng.uniform(-179, 179))
    n = int(rng.integers(3, 8))
    gaps = rng.uniform(1.0, 2.0, n)
    angles = np.cumsum(gaps) / np.sum(gaps) * 2 * np.pi
    radii = rng.uniform(0.02, 0.08, n)  # degrees
    return [(lat0 + r * np.sin(a), lng0 + r * np.cos(a))
            for a, r in zip(angles, radii)]


def _xyz(pts):
    return np.asarray([latlng_to_xyz(la, ln) for la, ln in pts])


def test_differential_random_polygons():
    rng = np.random.default_rng(7)
    checked = 0
    for _ in range(150):
        loop = Loop(_xyz(_rand_small_polygon(rng)))
        if loop_area_km2(loop) > MAX_AREA_KM2:
            loop = Loop(loop.v[::-1])
        if not (0 < loop_area_km2(loop) <= MAX_AREA_KM2):
            continue
        got = native.loop_covering(loop.v, True)
        if got is None:
            continue  # fallback condition (multi-face etc.)
        np.testing.assert_array_equal(got, _numpy_loop_covering(loop))
        if checked < 40:
            np.testing.assert_array_equal(got, _ref_loop_covering(loop))
        assert got.size > 0
        checked += 1
    assert checked > 100  # the fast path must actually engage


def test_differential_circles():
    """covering_circle (native dispatch) against the BFS over the same
    inscribed 20-gon, and against the reference's covering_circle."""
    rng = np.random.default_rng(21)
    checked = 0
    for _ in range(60):
        lat = float(rng.uniform(-65, 65))
        lng = float(rng.uniform(-179, 179))
        radius = float(rng.uniform(50, 8000))
        got = covering_circle(lat, lng, radius)
        z = covering.latlng_to_xyz(lat, lng)
        x = covering._ortho(z)
        y = covering._cross3(z, x)
        y = y / np.linalg.norm(y)
        ra = radius / covering.RADIUS_EARTH_METER
        pts = []
        for k in range(20):
            th = 2.0 * math.pi * k / 20.0
            p = math.cos(ra) * z + math.sin(ra) * (
                math.cos(th) * x + math.sin(th) * y
            )
            pts.append(p / np.linalg.norm(p))
        loop = Loop(np.asarray(pts))
        if loop_area_km2(loop) <= 0:
            continue
        np.testing.assert_array_equal(got, _numpy_loop_covering(loop))
        np.testing.assert_array_equal(
            got, ref_cov.covering_circle(lat, lng, radius)
        )
        checked += 1
    assert checked > 40


def test_multiface_falls_back():
    """A polygon straddling a face boundary returns None (BFS path), and
    the full covering still equals the reference's."""
    pts = [(0.5, 44.9), (0.5, 45.1), (0.6, 45.1), (0.6, 44.9)]
    loop = Loop(_xyz(pts))
    faces = covering.xyz_to_face_uv(loop.v)[0]
    assert len(set(int(f) for f in np.atleast_1d(faces))) > 1
    assert native.loop_covering(loop.v, True) is None
    np.testing.assert_array_equal(
        covering_polygon(pts), ref_cov.covering_polygon(pts)
    )


def test_area_gate_falls_back():
    pts = [(0.0, 0.0), (0.0, 0.05), (0.05, 0.05), (0.05, 0.0)]
    assert native.loop_covering(Loop(_xyz(pts)).v, area_ok=False) is None


def test_points_covering_full_path_differential():
    """dss_points_covering (winding retry + area gate + rect) against the
    port's Python internals and the reference's covering."""
    rng = np.random.default_rng(99)
    checked = 0
    for _ in range(80):
        pts = _rand_small_polygon(rng)
        if rng.random() < 0.5:
            pts = pts[::-1]  # CW input exercises the winding retry
        xyz = _xyz(pts)
        try:
            got = native.points_covering(xyz, MAX_AREA_KM2)
        except native.AreaTooLarge:
            got = "too_large"
        except native.Degenerate:
            got = "degenerate"
        if got is None:
            continue
        loop = Loop(xyz)
        area = loop_area_km2(loop)
        if area > MAX_AREA_KM2:
            loop = Loop(xyz[::-1])
            area = loop_area_km2(loop)
        if area > MAX_AREA_KM2:
            want = "too_large"
        elif area <= 0:
            want = "degenerate"
        else:
            want = _numpy_loop_covering(loop)
        if isinstance(want, str) or isinstance(got, str):
            assert isinstance(got, str) and got == want
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, ref_cov.covering_from_loop_points(xyz)
            )
        checked += 1
    assert checked > 50


def test_area_too_large_maps_with_the_reference_message():
    """native.AreaTooLarge -> AreaTooLargeError with the reference's
    message, in both windings."""
    pts = [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)]
    with pytest.raises(native.AreaTooLarge):
        native.points_covering(_xyz(pts), MAX_AREA_KM2)
    for p in (pts, pts[::-1]):
        with pytest.raises(AreaTooLargeError) as got:
            covering.covering_from_loop_points(_xyz(p))
        with pytest.raises(ref_cov.AreaTooLargeError) as want:
            ref_cov.covering_from_loop_points(_xyz(p))
        assert str(got.value) == str(want.value)
        assert "area is too large" in str(got.value)


def test_degenerate_maps_to_the_polyline():
    """native.Degenerate (zero area) -> the polyline covering, as the
    reference's Python path does."""
    # a repeated first vertex: every fan triangle has a zero triple
    # product, so the signed area is exactly 0
    pts = [(10.0, 10.0), (10.0, 10.0), (10.01, 10.01)]
    with pytest.raises(native.Degenerate):
        native.points_covering(_xyz(pts), MAX_AREA_KM2)
    got = covering.covering_from_loop_points(_xyz(pts))
    np.testing.assert_array_equal(got, covering.covering_polyline(_xyz(pts)))
    np.testing.assert_array_equal(
        got, ref_cov.covering_from_loop_points(_xyz(pts))
    )
    assert got.size > 0


def test_covering_too_large_maps_to_area_too_large(monkeypatch):
    """native.CoveringTooLarge (the cell cap) -> AreaTooLargeError with
    the reference's message, on both fast paths."""

    def too_large(*a, **k):
        raise native.CoveringTooLarge("covering exceeds maximum cell count")

    monkeypatch.setattr(native, "points_covering", too_large)
    monkeypatch.setattr(native, "loop_covering", too_large)
    pts = [(37.0, -122.0), (37.05, -122.0), (37.05, -122.05), (37.0, -122.05)]
    with pytest.raises(AreaTooLargeError,
                       match="covering exceeds maximum cell count"):
        covering.covering_from_loop_points(_xyz(pts))
    with pytest.raises(AreaTooLargeError,
                       match="covering exceeds maximum cell count"):
        covering._loop_covering(Loop(_xyz(pts)))


def test_polygon_end_to_end_matches_bfs_and_reference():
    pts = [(37.0, -122.0), (37.05, -122.0), (37.05, -122.05), (37.0, -122.05)]
    got = covering_polygon(pts)
    np.testing.assert_array_equal(got, _numpy_loop_covering(Loop(_xyz(pts))))
    np.testing.assert_array_equal(got, ref_cov.covering_polygon(pts))
    # and the port's own numpy dispatch, with the library switched off
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(covering, "_native", None)
        np.testing.assert_array_equal(covering_polygon(pts), got)

"""The port's mesh route against the reference, with no tolerance.

- `ops/conflict.py`: `conflict_query_batch` (with and without the owner
  filter and the delta postings) and `max_count_per_cell` against
  `dss_tpu.ops.conflict` on the same packed table;
- `parallel/sharded.py`: `shard_postings`, `weighted_boundaries`,
  `shard_of_keys` and `imbalance_factor` as arrays;
  `sharded_conflict_query_batch` (slots [Q, max_results], ovf [Q],
  shard_hits [n_sp]) and `ShardedDar.query_batch` (answers,
  `shard_hits`, `overflow_fallbacks`) over (dp, sp) in {(1,1), (1,4),
  (2,2), (1,8), (2,4)}, with and without boundaries — the reference on
  its 8 virtual CPU devices, the port on CPU positions of one device;
- the cases of tests/test_sharded.py:1-180 and
  tests/test_shard_rebalance.py:38-190 on both packages.

Inputs come from numpy with fixed seeds; both packages get the same
arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax
import jax.numpy as jnp
from dss_tpu.dar.oracle import Record as RRecord
from dss_tpu.dar.pack import pack_records as r_pack
from dss_tpu.dar.tiers import RangeLoad as RRangeLoad
from dss_tpu.ops import conflict as rc
from dss_tpu.parallel import make_mesh as r_make_mesh
from dss_tpu.parallel import sharded as rs

from dss_tpu_torch.dar.oracle import Record as PRecord
from dss_tpu_torch.dar.tiers import RangeLoad as PRangeLoad
from dss_tpu_torch.ops import conflict as pc
from dss_tpu_torch.parallel import make_mesh as p_make_mesh
from dss_tpu_torch.parallel import mesh as pmesh
from dss_tpu_torch.parallel import sharded as ps

NOW = 1_700_000_000_000_000_000  # unix ns
HOUR = 3_600_000_000_000
INT32_MAX = int(rc.INT32_MAX)
MESHES = [(1, 1), (1, 4), (2, 2), (1, 8), (2, 4)]


def _rows(seed, n, key_space=500, max_keys=12):
    """Plain tuples (entity_id, keys, alt_lo, alt_hi, t0, t1, owner)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nk = int(rng.integers(1, max_keys))
        keys = np.unique(rng.integers(0, key_space, nk).astype(np.int32))
        alo, ahi = sorted(rng.uniform(0, 3000, 2))
        if i % 7 == 0:
            alo = -np.inf
        if i % 11 == 0:
            ahi = np.inf
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        t1 = t0 + int(rng.integers(1, 8)) * HOUR
        out.append((f"e{i}", keys, float(alo), float(ahi), t0, t1,
                    int(rng.integers(0, 5))))
    return out


def _both(rows):
    return ([RRecord(*r) for r in rows], [PRecord(*r) for r in rows])


def _queries(seed, q, kw=32, key_space=500):
    rng = np.random.default_rng(seed)
    keys = np.full((q, kw), -1, np.int32)
    alo = np.full(q, -np.inf, np.float32)
    ahi = np.full(q, np.inf, np.float32)
    ts = np.full(q, rc.NO_TIME_LO, np.int64)
    te = np.full(q, rc.NO_TIME_HI, np.int64)
    for i in range(q):
        nk = int(rng.integers(1, kw))
        uniq = np.unique(rng.integers(0, key_space, nk).astype(np.int32))
        keys[i, : len(uniq)] = uniq
        if i % 2:
            a, b = sorted(rng.uniform(0, 3000, 2))
            alo[i], ahi[i] = a, b
        if i % 3:
            ts[i] = NOW - 2 * HOUR
            te[i] = NOW + 2 * HOUR
    return keys, alo, ahi, ts, te


# -- ops/conflict.py -----------------------------------------------------------


def _pad(pk, pe, sentinel):
    n = len(pk)
    size = 8
    while size < max(n, 8):
        size *= 2
    k = np.full(size, INT32_MAX, np.int32)
    e = np.full(size, sentinel, np.int32)
    k[:n], e[:n] = pk, pe
    return k, e


def _cap(pk):
    live = pk[pk != INT32_MAX]
    if not len(live):
        return 8
    cap = 8
    while cap < np.unique(live, return_counts=True)[1].max():
        cap *= 2
    return cap


def _table(with_delta, seed=3):
    """One packed entity table; base postings over the first 150 slots
    and (with_delta) delta postings over the rest, some slots dead."""
    rows = _rows(seed, 200)
    packed = r_pack([RRecord(*r) for r in rows], pad_postings=False)
    active = packed.active.copy()
    active[::9] = False
    cols = dict(alt_lo=packed.alt_lo, alt_hi=packed.alt_hi,
                t_start=packed.t_start, t_end=packed.t_end,
                active=active, owner=packed.owner)
    sent = packed.capacity
    pk, pe = packed.post_key, packed.post_ent
    in_base = pe < 150
    base = _pad(pk[in_base], pe[in_base], sent)
    if with_delta:
        delta = _pad(pk[~in_base], pe[~in_base], sent)
    else:
        delta = _pad(pk[:0], pe[:0], sent)
    return cols, base, delta


def _ref_args(cols, base, delta):
    ents = rc.EntityTable(**{k: jnp.asarray(v) for k, v in cols.items()})
    return (rc.Postings(jnp.asarray(base[0]), jnp.asarray(base[1])),
            rc.Postings(jnp.asarray(delta[0]), jnp.asarray(delta[1])), ents)


def _port_args(cols, base, delta):
    ents = pc.EntityTable(**{k: torch.from_numpy(v.copy())
                             for k, v in cols.items()})
    return (pc.Postings(*(torch.from_numpy(a) for a in base)),
            pc.Postings(*(torch.from_numpy(a) for a in delta)), ents)


@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("with_owner", [False, True])
@pytest.mark.parametrize("max_results", [4, 256])
def test_conflict_query_batch_equals_reference(with_delta, with_owner,
                                               max_results):
    cols, base, delta = _table(with_delta)
    keys, alo, ahi, ts, te = _queries(5, 24)
    owner = np.random.default_rng(6).integers(0, 5, 24).astype(np.int32)
    caps = dict(base_cap=_cap(base[0]), delta_cap=_cap(delta[0]),
                max_results=max_results)
    rb, rd, rents = _ref_args(cols, base, delta)
    want_s, want_o = rc.conflict_query_batch(
        rb, rd, rents,
        rc.QuerySpec(*(jnp.asarray(a) for a in (keys, alo, ahi, ts, te))),
        jnp.int64(NOW), jnp.asarray(owner) if with_owner else None,
        with_owner=with_owner, **caps,
    )
    pb, pd, pents = _port_args(cols, base, delta)
    got_s, got_o = pc.conflict_query_batch(
        pb, pd, pents, pc.query_spec(keys, alo, ahi, ts, te, "cpu"),
        NOW, torch.from_numpy(owner) if with_owner else None,
        with_owner=with_owner, **caps,
    )
    assert got_s.dtype == torch.int32 and got_o.dtype == torch.bool
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    if max_results == 4:
        assert got_o.any()  # the overflow flag is exercised
    # the one-query form answers as the batch's row does
    s0, o0 = pc.conflict_query(
        pb, pd, pents,
        pc.QuerySpec(torch.from_numpy(keys[3]), *(
            torch.tensor(a[3]) for a in (alo, ahi, ts, te))),
        NOW, owner_filter=int(owner[3]) if with_owner else None, **caps,
    )
    np.testing.assert_array_equal(s0.numpy(), got_s[3].numpy())
    assert bool(o0) == bool(got_o[3])


@pytest.mark.parametrize("with_delta", [False, True])
def test_max_count_per_cell_equals_reference(with_delta):
    cols, base, delta = _table(with_delta)
    caps = dict(base_cap=_cap(base[0]), delta_cap=_cap(delta[0]))
    rb, rd, rents = _ref_args(cols, base, delta)
    pb, pd, pents = _port_args(cols, base, delta)
    keys, *_ = _queries(8, 12)
    seen = set()
    for i in range(12):
        for owner in range(5):
            want = rc.max_count_per_cell(
                rb, rd, rents, jnp.asarray(keys[i]), jnp.int64(NOW),
                jnp.int32(owner), **caps)
            got = pc.max_count_per_cell(
                pb, pd, pents, torch.from_numpy(keys[i]), NOW, owner,
                **caps)
            assert int(got) == int(want), (i, owner)
            seen.add(int(got))
    assert max(seen) > 0


# -- parallel/sharded.py: the placement arrays -----------------------------------


def _postings(seed, n=2000, key_space=10_000):
    rng = np.random.default_rng(seed)
    pk = np.sort(rng.integers(0, key_space, n).astype(np.int32))
    pe = rng.integers(0, n // 4, n).astype(np.int32)
    return pk, pe


@pytest.mark.parametrize("n_sp", [1, 4, 8])
@pytest.mark.parametrize("split", ["count", "weighted", "capacity"])
def test_placement_arrays_equal_reference(n_sp, split):
    pk, pe = _postings(n_sp)
    rng = np.random.default_rng(40 + n_sp)
    padded = np.concatenate([pk, np.full(24, INT32_MAX, np.int32)])
    pe_pad = np.concatenate([pe, np.full(24, 9999, np.int32)])
    bounds = None
    if split != "count":
        w = rng.uniform(0, 5, len(pk))
        w[(pk > 4000) & (pk < 4400)] *= 50  # a hot range
        cap = (rng.uniform(0.25, 2.0, n_sp) if split == "capacity"
               else None)
        want_b = rs.weighted_boundaries(pk, w, n_sp, member_capacity=cap)
        bounds = ps.weighted_boundaries(pk, w, n_sp, member_capacity=cap)
        if want_b is None:
            assert bounds is None
        else:
            np.testing.assert_array_equal(bounds, want_b)
            assert bounds.dtype == np.int32
    for b in (None, bounds):
        wk, we = rs.shard_postings(padded, pe_pad, n_sp, 9999, boundaries=b)
        gk, ge = ps.shard_postings(padded, pe_pad, n_sp, 9999, boundaries=b)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(
            ps.shard_of_keys(pk, b, n_sp), rs.shard_of_keys(pk, b, n_sp))
        loads = np.bincount(ps.shard_of_keys(pk, b, n_sp), minlength=n_sp)
        assert ps.imbalance_factor(loads) == rs.imbalance_factor(loads)
    assert ps.imbalance_factor([]) == rs.imbalance_factor([]) == 1.0


def test_weighted_boundaries_edges_equal_reference():
    """Cold start, a single key hotter than a shard, the count cap,
    the RangeLoad weights of both packages, and the argument checks."""
    pk, _ = _postings(0)
    assert ps.weighted_boundaries(pk[:0], None, 4) is None
    assert ps.weighted_boundaries(pk, None, 1) is None
    np.testing.assert_array_equal(
        ps.weighted_boundaries(pk, np.zeros(len(pk)), 8),
        rs.weighted_boundaries(pk, np.zeros(len(pk)), 8))
    rng = np.random.default_rng(2)
    hot = np.sort(np.concatenate([
        rng.integers(0, 10_000, 1500), np.full(64, 5000)
    ]).astype(np.int32))
    rl, pl = RRangeLoad(shift=0), PRangeLoad(shift=0)
    for _ in range(50):
        rl.record(np.asarray([5000], np.int32), work=1000)
        pl.record(np.asarray([5000], np.int32), work=1000)
    np.testing.assert_array_equal(pl.weights_for(hot), rl.weights_for(hot))
    np.testing.assert_array_equal(
        ps.weighted_boundaries(hot, pl.weights_for(hot), 8),
        rs.weighted_boundaries(hot, rl.weights_for(hot), 8))
    with pytest.raises(ValueError, match="entries for"):
        ps.weighted_boundaries(pk, None, 4, member_capacity=np.ones(3))
    with pytest.raises(ValueError, match="> 0"):
        ps.weighted_boundaries(
            pk, None, 4, member_capacity=np.array([1.0, 0.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="split points"):
        ps.shard_postings(pk, pk, 4, 0, boundaries=np.zeros(2, np.int32))


# -- parallel/mesh.py --------------------------------------------------------------


def test_make_mesh_factors_and_virtual_positions():
    m = p_make_mesh(8, devices=pmesh.virtual_devices("cpu", 8))
    assert m.shape == {"dp": 2, "sp": 4} and m.devices.shape == (2, 4)
    assert m.distinct_devices() == [torch.device("cpu")]
    assert m.row_groups(1) == [(torch.device("cpu"), [0, 1, 2, 3])]
    assert pmesh._factor(8) == (2, 4) and pmesh._factor(3) == (1, 3)
    assert p_make_mesh(4, sp=4, devices=["cpu"] * 4).shape == {
        "dp": 1, "sp": 4}
    assert not pmesh.mesh_spans_processes(m)
    with pytest.raises(ValueError, match="dp\\*sp"):
        p_make_mesh(8, dp=3, sp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="positions given"):
        p_make_mesh(4, dp=1, sp=4, devices=["cpu"] * 2)
    # the process-spanning placement over one process's positions is
    # this row-major mesh, owned by process 0
    pl = pmesh.make_global_mesh(devices=pmesh.virtual_devices("cpu", 8))
    assert isinstance(pl, pmesh.MeshPlacement)
    assert pl.mesh.shape == m.shape and (pl.owner == 0).all()
    assert pl.mesh.row_groups(1) == m.row_groups(1)


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        p_make_mesh(2, dp=1, sp=2)  # devices=None lists the cards
    with pytest.raises(RuntimeError, match="is_available"):
        p_make_mesh(2, dp=1, sp=2, devices=["cuda"] * 2)


# -- parallel/sharded.py: the sharded query ------------------------------------------


def _meshes(dp, sp):
    return (r_make_mesh(dp * sp, dp=dp, sp=sp),
            p_make_mesh(dp * sp, dp=dp, sp=sp,
                        devices=pmesh.virtual_devices("cpu", dp * sp)))


BOUNDS = {4: np.asarray([60, 200, 210], np.int32),
          8: np.asarray([20, 40, 60, 80, 120, 300, 400], np.int32),
          2: np.asarray([250], np.int32)}


@pytest.mark.parametrize("split", ["count", "boundaries"])
@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_query_equals_reference(dp, sp, split):
    """slots [Q, max_results], ovf [Q] and shard_hits [n_sp] of the
    kernel-level call, then ShardedDar.query_batch's answers, its
    shard_hits and overflow_fallbacks — both with a per-shard capacity
    small enough that shards overflow."""
    b = BOUNDS.get(sp) if split == "boundaries" else None
    rrecs, precs = _both(_rows(7, 300))
    rmesh, pmesh_ = _meshes(dp, sp)
    keys, alo, ahi, ts, te = _queries(11, 32)
    now = np.full(32, NOW, np.int64)
    now[::5] = NOW + 3 * HOUR
    for mr, sr in ((512, None), (24, 6)):
        rdar = rs.ShardedDar(rrecs, rmesh, max_results=mr,
                             shard_results=sr, boundaries=b)
        pdar = ps.ShardedDar(precs, pmesh_, max_results=mr,
                             shard_results=sr, boundaries=b)
        assert pdar.cap == rdar.cap and pdar.nbytes == rdar.nbytes
        want = rs.sharded_conflict_query_batch(
            rdar.post_key, rdar.post_ent, rdar.ents,
            rc.QuerySpec(*(jnp.asarray(a) for a in (keys, alo, ahi, ts,
                                                    te))),
            jnp.asarray(now), mesh=rmesh, cap=rdar.cap,
            shard_results=rdar.shard_results, max_results=mr,
        )
        got = ps.sharded_conflict_query_batch(
            pdar.post_key, pdar.post_ent, pdar.ents,
            pc.query_spec(keys, alo, ahi, ts, te, "cpu"),
            torch.from_numpy(now), mesh=pmesh_, cap=pdar.cap,
            shard_results=pdar.shard_results, max_results=mr,
        )
        for g, w, dt in zip(got, want, (torch.int32, torch.bool,
                                        torch.int32)):
            assert g.dtype == dt
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if sr is not None:
            assert got[1].any()  # shard overflow reached the flag
        assert pdar.query_batch(keys, alo, ahi, ts, te, now=now) == (
            rdar.query_batch(keys, alo, ahi, ts, te, now=now))
        np.testing.assert_array_equal(pdar.shard_hits, rdar.shard_hits)
        assert pdar.overflow_fallbacks == rdar.overflow_fallbacks


def test_sharded_owner_filter_equals_reference():
    rrecs, precs = _both(_rows(9, 200))
    rmesh, pmesh_ = _meshes(2, 4)
    rdar = rs.ShardedDar(rrecs, rmesh, max_results=64)
    pdar = ps.ShardedDar(precs, pmesh_, max_results=64)
    keys, alo, ahi, ts, te = _queries(12, 16)
    owner = np.random.default_rng(3).integers(0, 5, 16).astype(np.int32)
    now = np.full(16, NOW, np.int64)
    want = rs.sharded_conflict_query_batch(
        rdar.post_key, rdar.post_ent, rdar.ents,
        rc.QuerySpec(*(jnp.asarray(a) for a in (keys, alo, ahi, ts, te))),
        jnp.asarray(now), jnp.asarray(owner), mesh=rmesh, cap=rdar.cap,
        shard_results=64, max_results=64, with_owner=True,
    )
    got = ps.sharded_conflict_query_batch(
        pdar.post_key, pdar.post_ent, pdar.ents,
        pc.query_spec(keys, alo, ahi, ts, te, "cpu"),
        torch.from_numpy(now), torch.from_numpy(owner), mesh=pmesh_,
        cap=pdar.cap, shard_results=64, max_results=64, with_owner=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the reference's own cases on both packages (test_sharded.py,
#    test_shard_rebalance.py:38-190) -------------------------------------------------


def _run_both(rrecs, precs, dp, sp, keys, *args, now=NOW, **kw):
    rmesh, pmesh_ = _meshes(dp, sp)
    rdar = rs.ShardedDar(rrecs, rmesh, **kw)
    pdar = ps.ShardedDar(precs, pmesh_, **kw)
    want = rdar.query_batch(keys, *args, now=now)
    got = pdar.query_batch(keys, *args, now=now)
    assert got == want
    np.testing.assert_array_equal(pdar.shard_hits, rdar.shard_hits)
    assert pdar.overflow_fallbacks == rdar.overflow_fallbacks
    return got, pdar


def _open(q):
    return (np.full(q, -np.inf, np.float32), np.full(q, np.inf, np.float32),
            np.full(q, rc.NO_TIME_LO, np.int64),
            np.full(q, rc.NO_TIME_HI, np.int64))


@pytest.mark.parametrize("case", ["overflow", "pads_to_dp", "empty_shards"])
def test_reference_cases_on_both_packages(case):
    if case == "overflow":
        # 40 entities on one hot cell overflow max_results=4
        rows = [(f"e{i}", np.array([7], np.int32), -np.inf, np.inf,
                 NOW - HOUR, NOW + HOUR, 0) for i in range(40)]
        keys = np.full((2, 4), -1, np.int32)
        keys[0, 0], keys[1, 0] = 7, 9
        got, pdar = _run_both(*_both(rows), 2, 4, keys, *_open(2),
                              max_results=4)
        assert sorted(got[0]) == list(range(40)) and got[1] == []
        assert pdar.overflow_fallbacks == 1
    elif case == "pads_to_dp":
        keys = np.full((3, 8), -1, np.int32)
        keys[:, 0] = [1, 2, 3]
        got, _ = _run_both(*_both(_rows(11, 50)), 2, 4, keys, *_open(3))
        assert len(got) == 3
    else:
        rows = [(f"e{i}", np.asarray([100 + i], np.int32), 0.0, 100.0,
                 -(2**62), 2**62, 0) for i in range(4)]
        b = np.asarray([100, 101, 102, 103, 104, 104, 104], np.int32)
        got, _ = _run_both(*_both(rows), 1, 8,
                           np.asarray([[100, 101, 102, 103]], np.int32),
                           *_open(1), now=0, max_results=16, boundaries=b)
        assert sorted(got[0]) == [0, 1, 2, 3]


def test_boundary_split_answers_equal_count_split_on_both():
    """A boundary map is a pure placement change: the port's answers
    under it equal its equal-count answers and the reference's, and the
    measured per-shard work sums alike."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(200):
        keys = np.unique(rng.integers(0, 500, 5).astype(np.int32))
        alo, ahi = sorted(rng.uniform(0, 3000, 2))
        rows.append((f"e{i}", keys, float(alo), float(ahi), -(2**62),
                     2**62, 0))
    keys = np.sort(rng.integers(0, 500, (16, 8)).astype(np.int32), axis=1)
    static, sdar = _run_both(*_both(rows), 1, 8, keys, *_open(16), now=0,
                             max_results=256)
    skewed, kdar = _run_both(*_both(rows), 1, 8, keys, *_open(16), now=0,
                             max_results=256, boundaries=BOUNDS[8])
    assert static == skewed
    assert kdar.shard_hits.sum() == sdar.shard_hits.sum()
    assert not np.array_equal(kdar.shard_hits, sdar.shard_hits)


def test_sharded_dar_on_the_cpu_runs_no_cuda():
    """Every tensor of a CPU-placed dar lies on the CPU (a cuda-placed
    one is tests/test_torch_kernel_gpu.py's)."""
    _, precs = _both(_rows(1, 30))
    pdar = ps.ShardedDar(precs, p_make_mesh(4, dp=2, sp=2,
                                            devices=["cpu"] * 4))
    for rows, t in list(pdar.post_key.parts.values()) + list(
            pdar.post_ent.parts.values()):
        assert rows == [0, 1] and t.device.type == "cpu"
    assert all(c.device.type == "cpu" for e in pdar.ents.values() for c in e)
    assert jax.devices()[0].platform == "cpu"

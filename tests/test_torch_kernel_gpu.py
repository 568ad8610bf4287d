"""The CUDA kernels against their plain PyTorch versions.

B1 (the fused window filter), B2 and B3 (the quantized window mask) and
B4 (the exact window mask), each on card tensors against its plain
version on the same tensors; masks and words must be equal exactly.
B3 and B4 also on every case of
chip_smoke.mask_cases(), on outputs handed back dirty and over 40
launches back to back, each wrapper through its own C entry.
B1's single-pass compaction is also held at the max_words boundaries,
past 4,096 tiles, over back-to-back launches and on a dirty output, and
B1 captured into a CUDA graph (ops/resident.py) against its eager
launch and plain version: at two buckets, over 50 replays that never
re-zero the scratch, with two units in flight, captured while
another thread serves cold batches, and captured with a collection due
at every allocation and a dead table's units waiting.  The store: DSSStore(storage="cuda")
with no device= puts its tables on the card, and a burst of 128 stale
store searches reaches B1 with the answers of a memory store.  The
federation: two federated cuda stores (region/federation.py) drain 128
cross-region stale searches, B1 launches on each region's store, and
every answer equals two federated stores on the CPU.  The mesh
route's kernels (ops/mesh_cuda.py: K1 mesh_query, K2 mesh_merge) against
their plain versions on every case of chip_smoke.mesh_cases(), on
outputs handed back dirty, over 40 launches back to back and over a
scratch split into several launches, each with K1 a warp an item and a
block of warps an item, refusing inputs they do not take;
K1 at the mesh headline's shape class in one launch;
K1 with a block of warps an item (the spread path) and a warp an item
against its plain version at 1 to 512 items on hits past a block's
tile, runs past the cap, delta postings, the owner filter and all-pad
rows; the spread path on dirty outputs and back to back, and chosen
only where a launch is narrow;
a cuda ShardedDar on a virtual 2x4 mesh equals the CPU one, one K1 and
one K2 launch a dp row, and its columns cross in one staged copy; a
replica
refreshes in a loop while the GraphCache captures on another thread,
with 0 capture failures; a reader on its own stream never sees a
snapshot whose copies have not finished.  The autotune sweep
(plan/autotune.py) at its full 50,000 x 20,000 fixture:
measure_device's and measure_hit_concentration's batches through B1
equal the plain version, and at every depth of measure_resident's
ladder (2, 4, 8, 16 submits before any collect) each submit replays a
captured graph whose answer equals eager B1 and the plain version.
Multihost (parallel/multihost.py): two processes sharing the card on a
global 1x4 mesh answer as one process's 1x4 mesh does, and the survivor
of a killed peer degrades with equal answers.

Needs a CUDA card (marker `gpu`); skips elsewhere.  This file imports
neither jax nor the reference package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

The card's full check, at the main path's shapes, is chip_smoke.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dss_tpu_torch.dar.pack import pack_records
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.ops import fastpath_cuda as fc
from dss_tpu_torch.ops import fused_filter as ff
from dss_tpu_torch.ops.fastpath import FastTable, pow2_bucket

HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _table(rng, n, n_cells, device):
    recs = []
    for i in range(n):
        k = np.unique(rng.integers(0, n_cells, rng.integers(1, 9)))
        alo = float(rng.uniform(0, 3000))
        t0 = NOW + int(rng.integers(-4, 4)) * HOUR
        recs.append(Record(f"e{i}", k.astype(np.int32), alo, alo + 400.0,
                           t0, t0 + 2 * HOUR, i % 7))
    p = pack_records(recs, pad_postings=False)
    pe = p.post_ent
    live = p.active[pe].copy()
    live[::17] = False  # some dead postings
    return FastTable(
        p.post_key, pe, p.alt_lo[pe], p.alt_hi[pe], p.t_start[pe],
        p.t_end[pe], live,
        slot_exact={"alt_lo": p.alt_lo, "alt_hi": p.alt_hi,
                    "t0": p.t_start, "t1": p.t_end, "live": p.active.copy()},
        device=device,
    )


def _args(ft, rng, b, w, n_cells):
    qkeys = rng.integers(0, n_cells, (b, w)).astype(np.int32)
    alo = rng.uniform(0, 3000, b).astype(np.float32)
    t0 = (NOW + rng.integers(-2, 2, b) * HOUR).astype(np.int64)
    wins, _, _, nw = ft._pack_windows(qkeys)
    dev = ft.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (
        ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1, t(wins), t(alo),
        t((alo + 300).astype(np.float32)), t(np.maximum(t0, NOW)),
        t(t0 + HOUR),
    ), nw


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,n_cells,b,w", [
    (1, 3000, 500, 200, 8),
    (2, 20000, 4000, 4096, 8),
    (3, 400, 2, 65, 3),  # two hot cells: long runs, full words
])
def test_kernel_matches_plain(cuda, seed, n, n_cells, b, w):
    rng = np.random.default_rng(seed)
    ft = _table(rng, n, n_cells, cuda)
    args, nw = _args(ft, rng, b, w, n_cells)
    for mw in (pow2_bucket(nw, lo=1 << 16), 7):  # normal and overflow
        got = ff.fused_window_filter(*args, max_words=mw)
        want = ff.fused_window_filter_torch(*args, max_words=mw)
        torch.cuda.synchronize()
        assert int(want[0]) > 0
        assert torch.equal(got, want), (seed, mw)


@pytest.mark.gpu
def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    rng = np.random.default_rng(4)
    ft = _table(rng, 500, 100, cuda)
    args, nw = _args(ft, rng, 100, 4, 100)
    before = ff.fused_window_filter.launches
    ff.fused_window_filter(*args, max_words=1 << 16)
    assert ff.fused_window_filter.launches == before + 1
    bad = list(args)
    bad[5] = bad[5].double()  # q_alo must be f32
    with pytest.raises(ValueError):
        ff.fused_window_filter(*bad, max_words=1 << 16)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero", "one", "count-1", "count",
                                  "count+1"])
def test_kernel_max_words_boundaries(cuda, case):
    """max_words around the true word count: the kept prefix, the true
    count in out[0] and the zero tail all equal the plain version's."""
    rng = np.random.default_rng(10)
    ft = _table(rng, 3000, 400, cuda)
    args, nw = _args(ft, rng, 300, 8, 400)
    n = int(ff.fused_window_filter_torch(*args, max_words=1)[0])
    assert n > 2
    mw = {"zero": 0, "one": 1, "count-1": n - 1, "count": n,
          "count+1": n + 1}[case]
    got = ff.fused_window_filter(*args, max_words=mw)
    want = ff.fused_window_filter_torch(*args, max_words=mw)
    torch.cuda.synchronize()
    assert int(want[0]) == n and got.shape == want.shape
    assert torch.equal(got, want), case


def _random_windows(rng, ft, nw, nq, device):
    """nw random windows over ft's blocks (every 7th a pad window) and
    nq random query bounds -> the kernel's arguments."""
    nb = ft.b_alo.shape[0]
    start = rng.integers(0, 128, nw)
    end = np.minimum(start + rng.integers(1, 80, nw), 128)
    meta = start | (end << 8) | (rng.integers(0, nq, nw) << 16)
    meta[::7] = 0
    blk = np.where(meta == 0, 0, rng.integers(0, nb, nw))
    wins = np.stack([blk, meta]).astype(np.int32)
    alo = rng.uniform(0, 3000, nq).astype(np.float32)
    t0 = (NOW + rng.integers(-2, 2, nq) * HOUR).astype(np.int64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1, t(wins), t(alo),
            t((alo + 300).astype(np.float32)), t(t0), t(t0 + HOUR))


@pytest.mark.gpu
def test_kernel_ragged_tiles_beyond_4096(cuda):
    """A window count off the tile multiple, with more than 4,096 tiles,
    so the look-back crosses many 32-tile windows."""
    rng = np.random.default_rng(11)
    ft = _table(rng, 20000, 4000, cuda)
    nw = 4097 * ff.TILE_WINDOWS + 37
    args = _random_windows(rng, ft, nw, 4096, cuda)
    for mw in (pow2_bucket(nw, lo=1 << 16), 4 * nw):
        got = ff.fused_window_filter(*args, max_words=mw)
        want = ff.fused_window_filter_torch(*args, max_words=mw)
        torch.cuda.synchronize()
        assert int(want[0]) > 0
        assert torch.equal(got, want), mw


@pytest.mark.gpu
def test_kernel_back_to_back_calls_reuse_epoch_and_counter(cuda):
    """Many launches on one stream with no sync between them, on inputs
    of different sizes: each launch's scratch state (tile counter,
    epoch, statuses) must be left right for the next."""
    rng = np.random.default_rng(12)
    ft = _table(rng, 20000, 4000, cuda)
    cases = [_random_windows(rng, ft, n, 512, cuda)
             for n in (64, 5000, 131072, 1, 70000)]
    mws = (7, 1 << 16, 1 << 18, 0, 40000)
    outs = [ff.fused_window_filter(*cases[i % 5], max_words=mws[i % 5])
            for i in range(60)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        want = ff.fused_window_filter_torch(*cases[i % 5],
                                            max_words=mws[i % 5])
        assert torch.equal(got, want), i


@pytest.mark.gpu
def test_kernel_writes_the_tail_of_a_dirty_output(cuda):
    """The wrapper allocates out with torch.empty: a block that the
    caching allocator hands back full of -1 must come out with its zero
    tail written by the kernel."""
    rng = np.random.default_rng(13)
    ft = _table(rng, 3000, 500, cuda)
    args, nw = _args(ft, rng, 200, 8, 500)
    mw = pow2_bucket(nw, lo=1 << 16)
    ff.fused_window_filter(*args, max_words=mw)  # scratch allocated
    torch.cuda.synchronize()
    dirty = torch.full((1 + 2 * mw,), -1, dtype=torch.int32, device=cuda)
    ptr = dirty.data_ptr()
    del dirty
    got = ff.fused_window_filter(*args, max_words=mw)
    want = ff.fused_window_filter_torch(*args, max_words=mw)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr  # the dirty block came back
    n = int(want[0])
    assert 0 < n < mw
    assert not got[1 + n: 1 + mw].any() and not got[1 + mw + n:].any()
    assert torch.equal(got, want)


def _queries(rng, b, w, n_cells):
    qkeys = rng.integers(0, n_cells, (b, w)).astype(np.int32)
    qkeys[:, -1] = -1  # a pad cell per row
    alo = rng.uniform(0, 3000, b).astype(np.float32)
    t0 = (NOW + rng.integers(-2, 2, b) * HOUR).astype(np.int64)
    return qkeys, alo, (alo + 300).astype(np.float32), t0, t0 + HOUR


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,n_cells,b,w", [
    (5, 3000, 500, 200, 8),
    (6, 20000, 4000, 4096, 8),
    (7, 400, 2, 65, 3),  # two hot cells: long runs
])
def test_window_mask_kernels_match_plain(cuda, seed, n, n_cells, b, w):
    rng = np.random.default_rng(seed)
    ft = _table(rng, n, n_cells, cuda)
    qkeys, alo, ahi, ts, te = _queries(rng, b, w, n_cells)
    # B2 on the legacy path's padded bucket (pad windows carry key -2)
    _, _, args = ft._legacy_inputs(qkeys, alo, ahi, ts, te)
    got = fc.filter_windows(ft.p3, *args)
    want = fc.filter_windows_torch(ft.p3, *args)
    torch.cuda.synchronize()
    assert want.any() and torch.equal(got, want)
    # B3 on a ragged prefix of at most 512 windows
    head = [a[:500 - 7] for a in args]
    got = fc.filter_windows_gridless(ft.p3, *head)
    torch.cuda.synchronize()
    assert torch.equal(got, want[: head[0].shape[0]])
    # B4 on the fused path's windows, qidx left in the meta word
    wins, win_q, _, nw = ft._pack_windows(qkeys)
    k = min(nw, 512)
    q = torch.from_numpy(win_q[:k].astype(np.int64)).to(cuda)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    wargs = (t(wins[0, :k]), t(wins[1, :k]), t(alo)[q], t(ahi)[q],
             t(np.maximum(ts, NOW))[q], t(te)[q])
    cols = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1)
    got = fc.fused_filter_gridless(*cols, *wargs)
    want = fc.fused_filter_mask_torch(*cols, *wargs)
    torch.cuda.synchronize()
    assert want.any() and torch.equal(got, want)
    # a window, a warp's worth and its neighbours, the reference's cap
    for k in (1, 31, 32, 33, min(nw, 512)):
        got3 = fc.filter_windows_gridless(ft.p3, *(a[:k] for a in args))
        got4 = fc.fused_filter_gridless(*cols, *(a[:k] for a in wargs))
        torch.cuda.synchronize()
        assert torch.equal(got3, fc.filter_windows_torch(
            ft.p3, *(a[:k] for a in args))), k
        assert torch.equal(got4, want[:k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.MASK_CASE_NAMES)
def test_mask_kernels_match_plain_on_every_mask_case(cuda, name):
    """B3 and B4 against their plain versions on each case of
    chip_smoke.mask_cases(), where a window whose block lies outside
    [0, NB) matches nothing."""
    a3, a4 = cs.mask_case_args(dict(cs.mask_cases())[name], cuda)
    for fn, plain, n_table, args in (
            (fc.filter_windows_gridless, fc.filter_windows_torch, 1, a3),
            (fc.fused_filter_gridless, fc.fused_filter_mask_torch, 4, a4)):
        got = fn(*args)
        want = cs.mask_plain(plain, n_table, args)
        torch.cuda.synchronize()
        assert got.shape == (args[-1].shape[0], 128)
        assert torch.equal(got, want), (name, fn.__name__)


@pytest.mark.gpu
def test_exact_mask_kernel_on_i64_edges(cuda):
    """B4's native i64 compare on times near multiples of 2^32, negative
    times and the i64 extremes, f32 bounds with infinities."""
    rng = np.random.default_rng(8)
    edges = np.asarray(
        [k * 2**32 + d for k in (-3, -1, 0, 1, 2) for d in (-2, -1, 0, 1)]
        + [-(2**62), 2**62, -(2**63), 2**63 - 1], np.int64)
    alts = np.asarray([-np.inf, -1.5, 0.0, 0.5, 2.0, np.inf], np.float32)
    nb, nw = 16, 509
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    cols = (t(rng.choice(alts, (nb, 128))), t(rng.choice(alts, (nb, 128))),
            t(rng.choice(edges, (nb, 128))), t(rng.choice(edges, (nb, 128))))
    start = rng.integers(0, 129, nw)
    end = np.where(rng.random(nw) < 0.3, 128, rng.integers(0, 129, nw))
    wargs = (t(rng.integers(0, nb, nw).astype(np.int32)),
             t((start | (end << 8)).astype(np.int32)),
             t(rng.choice(alts, nw)), t(rng.choice(alts, nw)),
             t(rng.choice(edges, nw)), t(rng.choice(edges, nw)))
    got = fc.fused_filter_gridless(*cols, *wargs)
    want = fc.fused_filter_mask_torch(*cols, *wargs)
    torch.cuda.synchronize()
    assert want.any() and not want.all()
    assert torch.equal(got, want)
    # mask_cases()' time_edges: i64 times to +-2^63 (B4), i32 bounds at
    # their extremes (B3), 512 windows
    a3, a4 = cs.mask_case_args(dict(cs.mask_cases())["time_edges"], cuda)
    want4 = cs.mask_plain(fc.fused_filter_mask_torch, 4, a4)
    want3 = cs.mask_plain(fc.filter_windows_torch, 1, a3)
    got4, got3 = fc.fused_filter_gridless(*a4), fc.filter_windows_gridless(*a3)
    torch.cuda.synchronize()
    assert want4.any() and not want4.all() and torch.equal(got4, want4)
    assert torch.equal(got3, want3)


@pytest.mark.gpu
def test_mask_kernels_count_launches_and_reject_bad_input(cuda, monkeypatch):
    rng = np.random.default_rng(9)
    ft = _table(rng, 500, 100, cuda)
    _, _, args = ft._legacy_inputs(*_queries(rng, 50, 4, 100))
    names = []
    bind = fc.cuda_build.function

    def spy(name, argtypes):
        names.append(name)
        return bind(name, argtypes)

    monkeypatch.setattr(fc.cuda_build, "function", spy)
    before = (fc.filter_windows.launches, fc.filter_windows_gridless.launches)
    fc.filter_windows(ft.p3, *args)
    fc.filter_windows_gridless(ft.p3, *(a[:64] for a in args))
    assert (fc.filter_windows.launches,
            fc.filter_windows_gridless.launches) == (before[0] + 1,
                                                     before[1] + 1)
    # B2 and B3 launch through their own entries
    assert names == ["dss_filter_windows", "dss_filter_windows_gridless"]
    monkeypatch.setattr(fc.cuda_build, "function", bind)
    # every mask case, then dirty outputs and 40 launches back to back
    tallies = (cs.TALLY["filter_windows_gridless"],
               cs.TALLY["fused_filter_gridless"])
    seen = [(t.compared, t.mismatches) for t in tallies]
    launches = (fc.filter_windows_gridless.launches,
                fc.fused_filter_gridless.launches)
    assert cs.mask_kernel_checks(cuda) == (0, 0)
    for t, (compared, mismatches) in zip(tallies, seen):
        assert t.compared > compared and t.mismatches == mismatches, t.name
    n_cases = len(cs.MASK_CASE_NAMES)
    assert (fc.filter_windows_gridless.launches - launches[0]
            + fc.fused_filter_gridless.launches - launches[1]
            == 2 * n_cases + 2 + 40)
    with pytest.raises(ValueError):  # qk must be i32
        fc.filter_windows(ft.p3, args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):  # p3 must be 16-byte aligned
        fc.filter_windows_gridless(ft.p3.reshape(-1)[1:641].reshape(1, 5, 128),
                                   *(a[:32] for a in args))


# -- B1 under CUDA graph replay (ops/resident.py) -------------------------------


def _graph_batch(ft, rng, b, w, n_cells):
    """One batch for FastTable.submit -> (submit args, its window and
    batch buckets, the kernel's padded card inputs)."""
    qkeys, alo, ahi, t0, t1 = _queries(rng, b, w, n_cells)
    wins, _, _, nw = ft._pack_windows(qkeys)
    bb = pow2_bucket(b, lo=16)

    def pad(a, dtype):
        out = np.zeros(bb, dtype)
        out[:b] = a
        return torch.from_numpy(out).to(ft.device)

    kargs = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1,
             torch.from_numpy(wins).to(ft.device), pad(alo, np.float32),
             pad(ahi, np.float32), pad(np.maximum(t0, NOW), np.int64),
             pad(t1, np.int64))
    return (qkeys, alo, ahi, t0, t1), wins.shape[1], bb, kargs


def _replayed(ft, kern, q):
    """submit through the selector -> (pinned output copy, decoded)."""
    pend = ft.submit(*q, now=NOW, kernel=kern)
    assert pend.instance is not None, "expected a captured bucket"
    pend.ready()
    out = pend.host.clone()
    return out, ft.collect(pend)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,b,w", [(21, 100, 8), (22, 1000, 8)])
def test_graph_replay_equals_eager_and_plain(cuda, seed, b, w):
    """At two (window, batch) buckets: the captured call's output equals
    an eager B1 launch and the plain version word for word; a replay
    counts in graph_replays and not in launches."""
    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(seed)
    ft = _table(rng, 20000, 4000, cuda)
    q, wb, bb, kargs = _graph_batch(ft, rng, b, w, 4000)
    mw = max_words_for(wb)
    cache = GraphCache()
    kern = ResidentKernel(cache, autocompile=False)
    assert cache.compile(ft, wb, bb, mw, instances=2)
    assert cache.captures == 2
    launches = ff.fused_window_filter.launches
    replays = ff.fused_window_filter.graph_replays
    graph_out, graph_hits = _replayed(ft, kern, q)
    assert ff.fused_window_filter.graph_replays == replays + 1
    assert ff.fused_window_filter.launches == launches
    eager = ff.fused_window_filter(*kargs, max_words=mw)
    plain = ff.fused_window_filter_torch(*kargs, max_words=mw)
    torch.cuda.synchronize()
    assert int(plain[0]) > 0
    assert torch.equal(graph_out, eager.cpu())
    assert torch.equal(graph_out, plain.cpu())
    want = ft.query_fused(*q, now=NOW)
    np.testing.assert_array_equal(graph_hits[0], want[0])
    np.testing.assert_array_equal(graph_hits[1], want[1])


@pytest.mark.gpu
def test_fifty_replays_never_rezero_the_scratch(cuda):
    """One replay unit, 50 batches of one bucket back to back: the
    unit's B1 scratch is never zeroed again (its epoch advances on the
    device) and every replay equals the plain version."""
    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(23)
    ft = _table(rng, 20000, 4000, cuda)
    batches = [_graph_batch(ft, rng, 200, 8, 4000)]
    wb, bb = batches[0][1:3]
    while len(batches) < 50:
        x = _graph_batch(ft, rng, 200, 8, 4000)
        if x[1:3] == (wb, bb):
            batches.append(x)
    mw = max_words_for(wb)
    cache = GraphCache()
    kern = ResidentKernel(cache, autocompile=False, instances=1)
    cache.compile(ft, wb, bb, mw, instances=1)
    unit = kern.lookup(ft, wb, bb, mw)
    scratch_ptr = unit.scratch.data_ptr()
    unit.release()
    for i, (q, _, _, kargs) in enumerate(batches):
        out, _ = _replayed(ft, kern, q)
        want = ff.fused_window_filter_torch(*kargs, max_words=mw)
        assert torch.equal(out, want.cpu()), i
    unit = kern.lookup(ft, wb, bb, mw)
    assert unit.scratch.data_ptr() == scratch_ptr
    assert unit.scratch[:ff.SCRATCH_HEAD].any()  # the epoch moved on
    unit.release()
    assert kern.hits == 52 and kern.busy == 0


@pytest.mark.gpu
def test_two_units_in_flight_do_not_alias(cuda):
    """Two batches of one bucket submitted before either is collected
    take two units, and each decodes its own answer."""
    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(24)
    ft = _table(rng, 20000, 4000, cuda)
    a = _graph_batch(ft, rng, 100, 8, 4000)
    while True:
        b = _graph_batch(ft, rng, 100, 8, 4000)
        if b[1:3] == a[1:3]:
            break
    cache = GraphCache()
    kern = ResidentKernel(cache, autocompile=False, instances=2)
    cache.compile(ft, a[1], a[2], max_words_for(a[1]), instances=2)
    pa = ft.submit(*a[0], now=NOW, kernel=kern)
    pb = ft.submit(*b[0], now=NOW, kernel=kern)
    assert pa.instance is not None and pb.instance is not None
    assert pa.instance is not pb.instance
    assert pa.host.data_ptr() != pb.host.data_ptr()
    got_b = ft.collect(pb)
    got_a = ft.collect(pa)
    for got, x in ((got_a, a), (got_b, b)):
        want = ft.query_fused(*x[0], now=NOW)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.gpu
def test_capture_while_another_thread_serves_cold(cuda):
    """Captures (thread-local mode) succeed while another thread runs
    cold-route batches (eager B1, allocations, pinned copies, event
    waits) on the default stream, and both sides stay exact."""
    import threading

    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(25)
    ft = _table(rng, 20000, 4000, cuda)
    cold = [_graph_batch(ft, rng, 300, 8, 4000)[0] for _ in range(4)]
    want_cold = [ft.query_fused(*q, now=NOW) for q in cold]
    q, wb, bb, kargs = _graph_batch(ft, rng, 100, 8, 4000)
    stop = threading.Event()
    errors, served = [], [0]

    def serve():
        try:
            while not stop.is_set():
                i = served[0] % len(cold)
                got = ft.query_fused(*cold[i], now=NOW)
                assert np.array_equal(got[0], want_cold[i][0])
                assert np.array_equal(got[1], want_cold[i][1])
                served[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=serve)
    th.start()
    try:
        cache = GraphCache()
        kern = ResidentKernel(cache, autocompile=False, instances=4)
        for wbi in (wb, 2 * wb):
            assert cache.compile(ft, wbi, bb, max_words_for(wbi), 4)
    finally:
        stop.set()
        th.join(60)
    assert not errors, errors
    assert served[0] > 0 and cache.captures == 8
    out, _ = _replayed(ft, kern, q)
    want = ff.fused_window_filter_torch(*kargs, max_words=max_words_for(wb))
    assert torch.equal(out, want.cpu())


@pytest.mark.gpu
def test_warm_captures_while_sixteen_threads_allocate_and_replay(cuda):
    """A warm thread captures a grid while 16 threads build replay units
    of their own buckets (pinned and card allocations, and captures)
    and replay a warmed bucket: no capture fails, and every replay
    equals the plain version."""
    import threading

    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(27)
    ft = _table(rng, 20000, 4000, cuda)
    q, wb, bb, kargs = _graph_batch(ft, rng, 100, 8, 4000)
    want = ff.fused_window_filter_torch(*kargs,
                                        max_words=max_words_for(wb)).cpu()
    cache = GraphCache()
    assert cache.compile(ft, wb, bb, max_words_for(wb), 16)
    errors, replays = [], [0]
    lock = threading.Lock()

    def worker(i):
        try:
            kern = ResidentKernel(cache, autocompile=False)
            for j in range(4):  # 3 keys of its own (window buckets below
                # the warmed and served ones), one built twice
                cache.compile(ft, 32 << (j % 3), 16 * (i + 1),
                              max_words_for(32), 2)
                out, _ = _replayed(ft, kern, q)
                assert torch.equal(out, want)
                with lock:
                    replays[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    warm = ResidentKernel(cache, autocompile=False, instances=6)
    warmer = threading.Thread(
        target=lambda: warm.warm(ft, batch_buckets=(4096, 8192),
                                 window_buckets=(1024, 4096, 16384)))
    ths = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    warmer.start()
    for th in ths:
        th.start()
    warmer.join(300)
    for th in ths:
        th.join(300)
    assert not errors, errors
    assert wb >= 256 and cache.capture_failures == 0
    assert replays[0] == 64
    assert cache.captures == 16 + 6 * 6 + 16 * 3 * 2 == cache.instances()


@pytest.mark.gpu
def test_dropped_entry_frees_its_pinned_buffers(cuda):
    """The captured graph's copies are torch copies of pinned buffers:
    when a fold drops a table, its entry's units and their pinned
    buffers are freed, and a capture and replay on the next table stay
    exact."""
    import gc

    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(26)
    cache = GraphCache()
    kern = ResidentKernel(cache, autocompile=False, instances=2)
    for n in range(2):
        ft = _table(rng, 20000, 4000, cuda)
        q, wb, bb, kargs = _graph_batch(ft, rng, 100, 8, 4000)
        assert cache.compile(ft, wb, bb, max_words_for(wb), 2)
        out, _ = _replayed(ft, kern, q)
        want = ff.fused_window_filter_torch(*kargs,
                                            max_words=max_words_for(wb))
        assert torch.equal(out, want.cpu())
        del ft, kargs
        gc.collect()
        torch.cuda.synchronize()
        assert cache.size() == 0 and cache.dropped == n + 1


@pytest.mark.gpu
def test_tables_die_while_another_thread_captures(cuda):
    """Entries of dead tables are freed (a fold's old tiers) while a
    warm thread captures on another table and a third thread launches
    B1 eagerly (pinned copies from PyTorch's host allocator): no
    capture fails, no eager call raises, and every answer is exact.
    The units' pinned buffers are registered memory, never blocks of
    the caching host allocator, and the captures run on one stream that
    no resident loop uses."""
    import gc
    import threading

    from dss_tpu_torch.ops.resident import (GraphCache, ResidentKernel,
                                            max_words_for)

    rng = np.random.default_rng(28)
    cache = GraphCache()
    warm_ft = _table(rng, 20000, 4000, cuda)
    eager_ft = _table(rng, 20000, 4000, cuda)
    eq = _graph_batch(eager_ft, rng, 100, 8, 4000)[0]
    want = eager_ft.query_fused(*eq, now=NOW)
    errors = []
    stop = threading.Event()

    def churn():  # build, replay and drop tables' entries
        try:
            kern = ResidentKernel(cache, autocompile=False, instances=2)
            for _ in range(12):
                ft = _table(rng, 5000, 2000, cuda)
                q, wb, bb, kargs = _graph_batch(ft, rng, 100, 8, 2000)
                cache.compile(ft, wb, bb, max_words_for(wb), 2)
                out, _ = _replayed(ft, kern, q)
                plain = ff.fused_window_filter_torch(
                    *kargs, max_words=max_words_for(wb))
                assert torch.equal(out, plain.cpu())
                del ft, kargs
                gc.collect()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def eager():
        try:
            while not stop.is_set():
                got = eager_ft.query_fused(*eq, now=NOW)
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    warm = ResidentKernel(cache, autocompile=False, instances=6)
    ths = [threading.Thread(target=churn),
           threading.Thread(target=lambda: warm.warm(
               warm_ft, batch_buckets=(128, 1024, 4096),
               window_buckets=(256, 1024, 4096, 16384)))]
    eth = threading.Thread(target=eager)
    eth.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    stop.set()
    eth.join(60)
    assert not errors, errors
    assert cache.capture_failures == 0
    assert cache.dropped >= 11
    unit = next(iter(cache._entries.values())).units[0]
    assert unit.host.is_pinned() and unit.h_in.is_pinned()
    # a fresh pinned allocation after all that still succeeds
    assert torch.zeros(1 << 20, dtype=torch.uint8, pin_memory=True).is_pinned()


# -- the store on the card ----------------------------------------------------


def _store_pair(rng, n, n_cells):
    """A DSSStore(storage="cuda") with no device= and a memory store,
    both holding the same n operations (FakeClocks at NOW)."""
    from dss_tpu_torch.clock import FakeClock, from_nanos
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.geo import s2cell
    from dss_tpu_torch.models import scd as scdm

    stores = [DSSStore(storage=k, clock=FakeClock(from_nanos(NOW)))
              for k in ("cuda", "memory")]
    for i in range(n):
        s = int(rng.integers(0, n_cells - 8))
        alo = float(np.float32(rng.uniform(0, 3000)))
        t0 = NOW + int(rng.integers(-4, 4)) * HOUR
        op = scdm.Operation(
            id=f"op{i}", owner=f"uss{i % 7}",
            start_time=from_nanos(t0),
            end_time=from_nanos(t0 + int(rng.integers(1, 6)) * HOUR),
            altitude_lower=alo,
            altitude_upper=float(np.float32(alo + rng.uniform(10, 600))),
            uss_base_url="https://uss.example", state="Accepted",
            cells=s2cell.dar_key_to_cell(np.arange(s, s + 8)),
        )
        for st in stores:
            st.scd.upsert_operation(op, [], key_checked=True)
    return stores


@pytest.mark.gpu
def test_store_defaults_to_the_card(cuda):
    rng = np.random.default_rng(40)
    store, mem = _store_pair(rng, 200, 400)
    try:
        assert store.storage == "cuda"
        for index, _ in store._class_indexes():
            assert index.table.device.type == "cuda"
        table = store.scd._op_index.table
        table.fold()
        fast = table._state.tiers[0].snap.fast
        assert fast.b_alo.device.type == "cuda"
    finally:
        store.close()
        mem.close()


@pytest.mark.gpu
def test_store_burst_of_stale_callers_launches_b1(cuda):
    """The reference's bulk stale drain (bench.py:1157-1186) through
    store.scd.search_operations: 128 allow_stale callers, min_batch 128,
    the op table's submit held until 80 queue; B1 launches, and every
    answer equals the memory store's."""
    import threading
    import time

    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.geo import s2cell

    rng = np.random.default_rng(41)
    store, mem = _store_pair(rng, 4000, 2000)
    try:
        index = store.scd._op_index
        index.table.fold()
        assert index.table._state.tiers
        store.configure_serving(min_batch=128, cache=False)
        co, table = index.coalescer, index.table
        submit = table.query_many_submit
        qs = []
        for i in range(128):
            s = int(rng.integers(0, 2000 - 8))
            alo = float(np.float32(rng.uniform(0, 3000)))
            t0 = NOW + int(rng.integers(-2, 2)) * HOUR
            qs.append((s2cell.dar_key_to_cell(np.arange(s, s + 8)), alo,
                       alo + 300.0, from_nanos(t0), from_nanos(t0 + HOUR)))
        got = [None] * len(qs)
        gate = threading.Event()

        def gated(*a, **kw):
            gate.wait(10.0)
            return submit(*a, **kw)

        def client(i):
            got[i] = store.scd.search_operations(*qs[i], allow_stale=True)

        ff.fused_window_filter.launches = 0
        ff.fused_window_filter.graph_replays = 0
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(qs))]
        table.query_many_submit = gated
        try:
            for th in ths:
                th.start()
            until = time.perf_counter() + 5.0
            while (co.stats()["co_queue_depth"] < 80
                   and time.perf_counter() < until):
                time.sleep(0.005)
        finally:
            del table.query_many_submit
            gate.set()
        for th in ths:
            th.join(60)
        assert (ff.fused_window_filter.launches
                + ff.fused_window_filter.graph_replays) > 0
        hits = 0
        for q, g in zip(qs, got):
            want = mem.scd.search_operations(*q)
            assert [(o.id, o.version, o.ovn) for o in g] == [
                (o.id, o.version, o.ovn) for o in want]
            hits += len(g)
        assert hits > 0
    finally:
        store.close()
        mem.close()


def _federated_stores(device, n, seed):
    """Regions a (keys < 1000) and b, each a DSSStore(storage="cuda")
    on `device` federated with the other through in-process transports,
    holding n operations of its own airspace each."""
    from dss_tpu_torch.clock import FakeClock, from_nanos
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.geo import s2cell
    from dss_tpu_torch.models import scd as scdm
    from dss_tpu_torch.region import federation as fed

    entries = [fed.RegionEntry("a"), fed.RegionEntry("b")]
    routers, stores = {}, {}

    def transport_to(name):
        def transport(method, path, payload):
            if path.endswith("/query"):
                return fed.serve_query(routers[name], payload)
            return fed.serve_sync(routers[name])
        return transport

    for local, remote, lo in (("a", "b", 800), ("b", "a", 1000)):
        routers[local] = fed.FederationRouter(
            fed.FederationMap(entries, np.array([1000], np.int32), local),
            {remote: fed.FederationPeer(remote, transport_to(remote))})
        store = DSSStore(storage="cuda", device=device,
                         clock=FakeClock(from_nanos(NOW)))
        rng = np.random.default_rng(seed + lo)
        for i in range(n):
            s = int(rng.integers(lo, lo + 200 - 8))
            alo = float(np.float32(rng.uniform(0, 3000)))
            t0 = NOW + int(rng.integers(-4, 4)) * HOUR
            store.scd.upsert_operation(scdm.Operation(
                id=f"{local}op{i}", owner=f"uss{i % 7}",
                start_time=from_nanos(t0),
                end_time=from_nanos(t0 + int(rng.integers(1, 6)) * HOUR),
                altitude_lower=alo, altitude_upper=alo + 400.0,
                uss_base_url="https://uss.example", state="Accepted",
                cells=s2cell.dar_key_to_cell(np.arange(s, s + 8)),
            ), [], key_checked=True)
        store.scd._op_index.table.fold()
        store.configure_serving(min_batch=128, cache=False)
        store.attach_federation(routers[local])
        routers[local].close()
        stores[local] = store
    return stores


@pytest.mark.gpu
def test_federated_drains_launch_b1_on_both_regions(cuda):
    """128 bounded-stale searches whose coverings span both regions,
    through region a's federated store: a's op table and then b's hold
    their submit until 80 queue, so each region drains one batch of
    more than 64 on the device route.  B1 launches on each region's
    store (counted from zero per region), and every answer equals two
    federated stores on the CPU."""
    import threading
    import time

    from dss_tpu_torch.clock import from_nanos
    from dss_tpu_torch.geo import s2cell

    rng = np.random.default_rng(42)
    qs = []
    for _ in range(128):
        s = int(rng.integers(989, 1000))
        alo = float(np.float32(rng.uniform(0, 3000)))
        t0 = NOW + int(rng.integers(-2, 2)) * HOUR
        qs.append((s2cell.dar_key_to_cell(np.arange(s, s + 12)), alo,
                   alo + 300.0, from_nanos(t0), from_nanos(t0 + HOUR)))
    card = _federated_stores(cuda, 3000, 5)
    cpu = _federated_stores("cpu", 3000, 5)
    try:
        gates, submits = {}, {}
        for k, store in card.items():
            table = store.scd._op_index.table
            gates[k] = threading.Event()
            submits[k] = table.query_many_submit

            def gated(*a, _k=k, **kw):
                gates[_k].wait(10.0)
                return submits[_k](*a, **kw)

            table.query_many_submit = gated
        got = [None] * len(qs)

        def client(i):
            got[i] = card["a"].scd.search_operations(*qs[i],
                                                     allow_stale=True)

        def queued(k, n):
            co = card[k].scd._op_index.coalescer
            until = time.perf_counter() + 5.0
            while (co.stats()["co_queue_depth"] < n
                   and time.perf_counter() < until):
                time.sleep(0.005)

        launches = {}
        ff.fused_window_filter.launches = 0
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(qs))]
        try:
            for th in ths:
                th.start()
            queued("a", 80)
            gates["a"].set()
            # every caller passes a's slice before it queues on b
            queued("b", 80)
            launches["a"] = ff.fused_window_filter.launches
            ff.fused_window_filter.launches = 0
            gates["b"].set()
            for th in ths:
                th.join(60)
            launches["b"] = ff.fused_window_filter.launches
        finally:
            for k, store in card.items():
                store.scd._op_index.table.__dict__.pop(
                    "query_many_submit", None)
                gates[k].set()
        assert launches["a"] > 0 and launches["b"] > 0, launches
        hits = 0
        for q, g in zip(qs, got):
            want = cpu["a"].scd.search_operations(*q, allow_stale=True)
            assert [(o.id, o.version, o.ovn) for o in g] == [
                (o.id, o.version, o.ovn) for o in want]
            hits += len(g)
        assert hits > 0
        for k, store in card.items():
            st = store.scd._op_index.coalescer.stats()
            assert st["co_route_device_batches"] >= 1, (k, st)
    finally:
        for store in (*card.values(), *cpu.values()):
            store.close()


@pytest.mark.gpu
def test_no_collection_inside_a_capture(cuda, monkeypatch):
    """A dead table's replay units sit in a cycle with their entry, so
    only the cyclic collector frees them, on whichever thread allocates
    next; freed on a capturing thread they invalidate its capture.  With
    a collection due at every allocation and dead units waiting, no
    collection starts while a unit captures, no capture fails, and the
    replay is exact."""
    import gc

    from dss_tpu_torch.ops import resident

    rng = np.random.default_rng(29)
    cache = resident.GraphCache()
    old = _table(rng, 5000, 2000, cuda)
    q, wb, bb, _ = _graph_batch(old, rng, 100, 8, 2000)
    ft = _table(rng, 5000, 2000, cuda)
    q, wb, bb, kargs = _graph_batch(ft, rng, 100, 8, 2000)
    mid_capture, captured = [], []

    def on_gc(phase, info):
        if phase == "start":
            mid_capture.append(torch.cuda.is_current_stream_capturing())

    call = resident._Instance._call

    def watching_call(self):
        captured.append(torch.cuda.is_current_stream_capturing())
        call(self)

    thresholds = gc.get_threshold()
    gc.disable()
    try:
        assert cache.compile(old, wb, bb, resident.max_words_for(wb), 2)
        cache._drop_token(cache._token(old))  # a fold replaced the table
        del old
        monkeypatch.setattr(resident._Instance, "_call", watching_call)
        gc.callbacks.append(on_gc)
        gc.set_threshold(1, 1, 1)
        gc.enable()
        assert cache.compile(ft, wb, bb, resident.max_words_for(wb), 2)
    finally:
        gc.set_threshold(*thresholds)
        gc.enable()
        gc.callbacks.remove(on_gc)
        monkeypatch.undo()
    assert captured.count(True) == 2  # two units captured
    assert mid_capture and not any(mid_capture), mid_capture
    assert cache.capture_failures == 0
    kern = resident.ResidentKernel(cache, autocompile=False, instances=2)
    out, _ = _replayed(ft, kern, q)
    plain = ff.fused_window_filter_torch(
        *kargs, max_words=resident.max_words_for(wb))
    assert torch.equal(out, plain.cpu())


# -- the mesh route on the card -------------------------------------------------


def _mesh_records(rng, n, n_cells, prefix="e"):
    out = []
    for i in range(n):
        k0 = int(rng.integers(0, n_cells - 8))
        alo = float(np.float32(rng.uniform(0, 3000)))
        t0 = NOW + int(rng.integers(-4, 4)) * HOUR
        out.append(Record(f"{prefix}{i}", np.arange(k0, k0 + 8, dtype=np.int32),
                          alo, float(np.float32(alo + 400.0)), t0,
                          t0 + 2 * HOUR, i % 7))
    return out


def _ents(packed, device):
    """A PackedRecords' entity columns on `device`, placed as ShardedDar
    places them (parallel/sharded.py `place`)."""
    from dss_tpu_torch.ops import conflict as pc
    from dss_tpu_torch.parallel.sharded import Staging, place

    return pc.EntityTable(*place(torch.device(device),
                                 pc.entity_columns(packed), Staging()))


def _mesh_queries(rng, q, n_cells):
    k0 = rng.integers(0, n_cells - 8, q)
    keys = (k0[:, None] + np.arange(8)).astype(np.int32)
    alo = rng.uniform(0, 3000, q).astype(np.float32)
    t0 = (NOW + rng.integers(-2, 2, q) * HOUR).astype(np.int64)
    return keys, alo, (alo + 300).astype(np.float32), t0, t0 + HOUR


@pytest.mark.gpu
def test_cuda_sharded_dar_on_a_virtual_mesh_equals_cpu(cuda):
    """A cuda ShardedDar on a virtual 2x4 mesh (eight positions on one
    card) answers as the CPU one: slots, overflow flags, shard_hits and
    overflow fallbacks; its tensors lie on the card; conflict_query_batch
    and max_count_per_cell on card tensors equal their CPU answers."""
    from dss_tpu_torch.ops import conflict as pc
    from dss_tpu_torch.parallel import ShardedDar, make_mesh
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import virtual_devices

    rng = np.random.default_rng(40)
    recs = _mesh_records(rng, 20000, 4000)
    q = _mesh_queries(rng, 512, 4000)
    cards = make_mesh(8, dp=2, sp=4, devices=virtual_devices(cuda, 8))
    cpus = make_mesh(8, dp=2, sp=4, devices=virtual_devices("cpu", 8))
    for mr, sr in ((512, None), (64, 8)):
        a = ShardedDar(recs, cards, max_results=mr, shard_results=sr)
        b = ShardedDar(recs, cpus, max_results=mr, shard_results=sr)
        rows, t = a.post_key.parts[cards.devices[0, 0]]
        assert rows == [0, 1, 2, 3] and t.is_cuda
        spec = pc.query_spec(*q, "cpu")
        now = torch.full((512,), NOW, dtype=torch.int64)
        got = ps.sharded_conflict_query_batch(
            a.post_key, a.post_ent, a.ents, spec, now, mesh=cards,
            cap=a.cap, shard_results=a.shard_results, max_results=mr)
        want = ps.sharded_conflict_query_batch(
            b.post_key, b.post_ent, b.ents, spec, now, mesh=cpus,
            cap=b.cap, shard_results=b.shard_results, max_results=mr)
        assert got[0].is_cuda
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert a.query_batch(*q, now=NOW) == b.query_batch(*q, now=NOW)
        assert np.array_equal(a.shard_hits, b.shard_hits)
        assert a.overflow_fallbacks == b.overflow_fallbacks
        if sr is not None:
            assert a.overflow_fallbacks > 0
    packed = pack_records(recs, pad_postings=False)
    post = [pc.Postings(torch.from_numpy(packed.post_key),
                        torch.from_numpy(packed.post_ent))]
    post.append(pc.Postings(post[0].post_key[:0], post[0].post_ent[:0]))
    ents = _ents(packed, "cpu")
    caps = dict(base_cap=packed.base_cap, delta_cap=8)
    dev = lambda p: pc.Postings(*(t.to(cuda) for t in p))  # noqa: E731
    cents = pc.EntityTable(*(c.to(cuda) for c in ents))
    got = pc.conflict_query_batch(dev(post[0]), dev(post[1]), cents,
                                  pc.query_spec(*q, cuda), NOW,
                                  max_results=256, **caps)
    want = pc.conflict_query_batch(post[0], post[1], ents,
                                   pc.query_spec(*q, "cpu"), NOW,
                                   max_results=256, **caps)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    keys = torch.from_numpy(q[0][0])
    assert int(pc.max_count_per_cell(
        dev(post[0]), dev(post[1]), cents, keys.to(cuda), NOW, 3, **caps
    )) == int(pc.max_count_per_cell(post[0], post[1], ents, keys, NOW, 3,
                                    **caps))


@pytest.fixture(scope="module")
def mesh_cases():
    from dss_tpu_torch.ops import mesh_cuda as mc

    if not torch.cuda.is_available():  # before cuda: this scope is wider
        pytest.skip("needs a CUDA card")
    cases = cs.mesh_cases(mc.query_tile())
    assert [n for n, _ in cases] == list(cs.MESH_CASE_NAMES)
    return dict(cases)


@pytest.fixture(params=("one_warp", "spread"))
def k1_warps(request, monkeypatch):
    """K1's width for the test, whatever a call's size: a warp an item
    (mesh_query_kernel), or SPREAD_MAX_WARPS warps an item
    (mesh_query_kernel_spread); count mode takes a warp an item at
    both."""
    from dss_tpu_torch.ops import mesh_cuda as mc

    warps = 1 if request.param == "one_warp" else mc.SPREAD_MAX_WARPS
    monkeypatch.setattr(mc, "spread_warps", lambda items, sms: warps)
    return warps


def _mesh_run(mc, c, cuda, plain=False):
    """K1 (and, after a compact K1, K2 on its shard lists) on a case's
    card tensors -> their results."""
    args, kw, mkw = cs.mesh_case_args(c, cuda)
    k1 = mc.mesh_query_torch if plain else mc.mesh_query
    k2 = mc.mesh_merge_torch if plain else mc.mesh_merge
    out = k1(*args, **kw)
    if kw["count"]:
        return (out,)
    return tuple(out) + tuple(k2(*out, **mkw))


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.MESH_CASE_NAMES)
def test_mesh_kernels_match_plain(cuda, mesh_cases, name, k1_warps):
    """K1 and K2 against their plain versions on the same card tensors,
    slot for slot, each case of chip_smoke.mesh_cases() (K*cap and
    n_sp*sr past one block's shared memory among them), with K1 a warp
    an item and a block an item, the spread counter naming the kernel
    that ran."""
    from dss_tpu_torch.ops import mesh_cuda as mc

    c = mesh_cases[name]
    before = (mc.mesh_query.launches, mc.mesh_query.spread_launches,
              mc.mesh_merge.launches)
    got = _mesh_run(mc, c, cuda)
    want = _mesh_run(mc, c, cuda, plain=True)
    torch.cuda.synchronize()
    spread = int(k1_warps > 1 and not c["count"])
    assert (mc.mesh_query.launches - before[0],
            mc.mesh_query.spread_launches - before[1],
            mc.mesh_merge.launches - before[2]) == (
                (1, 0, 0) if c["count"] else (1, spread, 1))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_mesh_kernels_on_dirty_outputs_and_back_to_back(cuda):
    """chip_smoke.mesh_kernel_checks: every case, then outputs that the
    allocator hands back full of -1 (the kernels write every pad
    themselves), then 40 launches over the cases with no sync between
    them, each equal to its plain version, with no mismatch tallied:
    once with K1 a warp an item and once a block an item, both kernels
    tallied."""
    tallies = (cs.TALLY["mesh_query"], cs.TALLY["mesh_query_spread"],
               cs.TALLY["mesh_merge"], cs.MESH_TALLY)
    before = [(t.compared, t.mismatches) for t in tallies]
    cs.mesh_kernel_checks(cuda)
    for t, (compared, mismatches) in zip(tallies, before):
        assert t.compared > compared, t.name
        assert t.mismatches == mismatches, t.name


@pytest.mark.gpu
def test_mesh_query_splits_a_scratch_past_its_limit(cuda, mesh_cases,
                                                    monkeypatch, k1_warps):
    """Hit buffers past one block's shared memory live in a global
    scratch; past SCRATCH_LIMIT bytes the batch runs as several launches
    over its items, equal to the plain version: with K1 a warp an item
    and a block an item (whose tile is larger)."""
    from dss_tpu_torch.ops import mesh_cuda as mc

    args, kw, _ = cs.mesh_case_args(mesh_cases["k1_past_shared_memory"],
                                    cuda)
    buf = args[5].keys.shape[1] * kw["cap"]
    assert buf > mc.query_tile(k1_warps)
    monkeypatch.setattr(mc, "SCRATCH_LIMIT", 3 * 4 * buf)  # 3 items
    before = (mc.mesh_query.launches, mc.mesh_query.spread_launches)
    got = mc.mesh_query(*args, **kw)
    want = mc.mesh_query_torch(*args, **kw)
    torch.cuda.synchronize()
    assert mc.mesh_query.launches - before[0] == 3  # 8 items, 3 a launch
    assert mc.mesh_query.spread_launches - before[1] == (
        3 if k1_warps > 1 else 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_mesh_query_from_threads_with_other_buffer_sizes(cuda, mesh_cases,
                                                         k1_warps):
    """Nine threads launch K1 at once with items of three buffer sizes
    (16 cells at cap 512 and at cap 256 with K1 a warp an item, at cap
    1024 and 768 with a block an item: each past that width's shared
    tile and so with global scratches of their own, and K 16 at a small
    cap, inside the tile), each on its own stream, under a short switch
    interval: every answer equals the plain version and every launch
    is counted."""
    import sys
    import threading

    from dss_tpu_torch.ops import mesh_cuda as mc

    big_args, big_kw, _ = cs.mesh_case_args(
        mesh_cases["k1_past_shared_memory"], cuda)
    small_args, small_kw, _ = cs.mesh_case_args(
        mesh_cases["random_k16_sp8"], cuda)
    # 16 cells x cap 512 and x cap 256: 32 KB and 16 KB of scratch an
    # item; a block an item holds 8,192 in its tile, so 1024 and 768
    caps = (512, 256) if k1_warps == 1 else (1024, 768)
    assert 16 * min(caps) > mc.query_tile(k1_warps)
    runs = [(big_args, dict(big_kw, cap=caps[0])),
            (big_args, dict(big_kw, cap=caps[1])), (small_args, small_kw)]
    want = [mc.mesh_query_torch(*a, **k) for a, k in runs]
    torch.cuda.synchronize()
    before = (mc.mesh_query.launches, mc.mesh_query.spread_launches)
    bad, iters = [], 25

    def work(i):
        args, kw = runs[i % 3]
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(iters):
                got = mc.mesh_query(*args, **kw)
                torch.cuda.current_stream(cuda).synchronize()
                if not all(torch.equal(g, w)
                           for g, w in zip(got, want[i % 3])):
                    bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert mc.mesh_query.launches - before[0] == 9 * iters
    assert mc.mesh_query.spread_launches - before[1] == (
        9 * iters if k1_warps > 1 else 0)


@pytest.mark.gpu
def test_mesh_query_at_the_headline_shape_is_one_launch(cuda):
    """K1 at the mesh headline's shape class (8,192 queries of 8 cells
    in a key width of 16, cap 128): its scratch of K * cap int32 an item
    stays under SCRATCH_LIMIT, so a call is one launch, equal to the
    plain version; the kernel needs no scratch up to its tile, and its
    occupancy is readable."""
    from dss_tpu_torch.ops import conflict as pc
    from dss_tpu_torch.ops import cuda_build
    from dss_tpu_torch.ops import mesh_cuda as mc

    recs, _ = cs.make_records(20_000, 2_000, cs.KPE, seed=3)
    p = pack_records(recs, pad_postings=False)
    assert p.base_cap == 128
    q = cs.make_batch(7, 8192, 2_000, cs.WIDTH)
    keys = np.full((8192, 16), -1, np.int32)
    keys[:, : cs.WIDTH] = q[0]
    spec = pc.query_spec(keys, *q[1:], cuda)
    ents = pc._u8(_ents(p, cuda))
    post = [torch.from_numpy(a).to(cuda)[None] for a in (p.post_key,
                                                         p.post_ent)]
    now = torch.full((8192,), NOW, dtype=torch.int64, device=cuda)
    kw = dict(rows=mc.pack_entity_rows(ents), cap=p.base_cap, delta_cap=0,
              max_results=512)
    args = (*post, None, None, ents, spec, now, None)
    assert 8192 * 16 * 128 * 4 <= mc.SCRATCH_LIMIT
    want = mc.mesh_query_torch(*args, **kw)
    before = mc.mesh_query.launches
    got = mc.mesh_query(*args, **kw)
    torch.cuda.synchronize()
    assert mc.mesh_query.launches - before == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fits = cuda_build.function("dss_mesh_query_fits", [ctypes.c_longlong] * 3)
    tile = mc.query_tile()
    assert (fits(tile, 0, 1), fits(tile + 1, 0, 1)) == (1, 0)
    wide = mc.query_tile(mc.SPREAD_MAX_WARPS)
    assert wide > tile and (fits(wide, 0, mc.SPREAD_MAX_WARPS),
                            fits(wide + 1, 0, mc.SPREAD_MAX_WARPS),
                            fits(wide + 1, 1, 1)) == (1, 0, 1)
    occ = mc.occupancy()
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0


# -- K1 with a block of warps an item (the spread path) --------------------

SPREAD_ITEMS = (1, 8, 64, 128, 512)
SPREAD_CASE_NAMES = ("spill_first_chunk", "spill_second_chunk",
                     "run_past_cap", "delta_own_cap", "owner_sp2",
                     "all_pad_rows")


def _same_window(n, key_of, prefix="s"):
    """n records that every open query hits, record i in cells
    key_of(i)."""
    return [Record(f"{prefix}{i}", np.asarray(key_of(i), np.int32), 0.0,
                   100.0, NOW - HOUR, NOW + HOUR, 1) for i in range(n)]


def _spread_queries(seed, nq, k, key_space, open_rows=()):
    """nq queries of up to k - 1 distinct cells in [0, key_space) (pad
    -1); rows in `open_rows` all pad with open bounds."""
    r = np.random.default_rng(seed)
    keys = np.full((nq, k), -1, np.int32)
    for i in range(nq):
        u = np.unique(r.integers(0, key_space, int(r.integers(1, k))))
        keys[i, : len(u)] = u
    alo = r.uniform(0, 3000, nq).astype(np.float32)
    ahi = (alo + 900).astype(np.float32)
    t0 = (NOW + r.integers(-3, 3, nq) * HOUR).astype(np.int64)
    t1 = t0 + 2 * HOUR
    alo[::5], ahi[::5] = -np.inf, np.inf
    for i in open_rows:
        keys[i] = -1
        alo[i], ahi[i], t0[i], t1[i] = (-np.inf, np.inf, cs.NO_TIME_LO,
                                        cs.NO_TIME_HI)
    return keys, alo, ahi, t0, t1


def _open_query(keys, k):
    rows = np.full((1, k), -1, np.int32)
    rows[0, : len(keys)] = keys
    return (rows, np.full(1, -np.inf, np.float32),
            np.full(1, np.inf, np.float32), np.full(1, cs.NO_TIME_LO),
            np.full(1, cs.NO_TIME_HI))


def _spread_cases(spread_tile):
    """The spread path's cases (numpy, from seeds), each with the most
    items it was built for; `_tiled` repeats its queries."""
    rng = np.random.default_rng(78)
    recs = []
    for i in range(400):
        keys = np.unique(rng.integers(0, 40, int(rng.integers(1, 7))))
        alo = float(np.float32(rng.uniform(0, 3000)))
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        recs.append(Record(f"r{i}", keys.astype(np.int32), alo,
                           float(np.float32(alo + 600.0)), t0,
                           t0 + int(rng.integers(1, 7)) * HOUR,
                           int(rng.integers(0, 5))))
    hot = _same_window(600, lambda i: [9], "h")  # a run of 600: cap 1024
    # 16 cells of 600 slots each: 9,600 hits past the block's tile in the
    # first chunk of 32 cells
    first = _same_window(9600, lambda i: [i // 600])
    # chunk 0: 32 cells of 100 slots (3,200 hits in the tile); chunk 1: 16
    # cells of 400 postings, each slot in two of them (6,400 hits, 3,200
    # unique), which pass the tile beside the first 3,200
    second = (_same_window(3200, lambda i: [i // 100], "a")
              + _same_window(3200, lambda i: [32 + i % 16, 32 + (i + 1) % 16],
                             "b"))
    assert 9600 > spread_tile and 3200 <= spread_tile < 3200 + 6400
    return [
        ("spill_first_chunk", cs.mesh_case(
            first, _open_query(np.arange(16), 16), r=64, dead=0)),
        ("spill_second_chunk", cs.mesh_case(
            second, _open_query(np.arange(48), 48), r=1024, dead=0)),
        ("run_past_cap", cs.mesh_case(
            hot + recs, _spread_queries(1, 24, 16, 40), r=64, cap=256)),
        ("delta_own_cap", cs.mesh_case(
            hot + recs, _spread_queries(2, 24, 16, 40),
            delta=list(range(0, 1000, 2)), delta_cap=64, r=64, cap=512)),
        ("owner_sp2", cs.mesh_case(
            recs, _spread_queries(3, 24, 32, 40), n_sp=2, r=16, merge_r=32,
            owner=np.random.default_rng(4).integers(0, 5, 24))),
        ("all_pad_rows", cs.mesh_case(
            hot + recs, _spread_queries(5, 24, 16, 40,
                                        open_rows=range(0, 24, 3)), r=64)),
    ]


def _tiled(c, items):
    """Case c with its queries repeated to items // n_sp of them (at
    least one)."""
    nq = max(1, items // c["n_sp"])
    out = dict(c)
    for k in ("keys", "qalo", "qahi", "qt0", "qt1", "now", "owner"):
        if c[k] is not None:
            out[k] = np.resize(c[k], (nq,) + c[k].shape[1:])
    return out


@pytest.fixture(scope="module")
def spread_cases():
    from dss_tpu_torch.ops import mesh_cuda as mc

    if not torch.cuda.is_available():  # before cuda: this scope is wider
        pytest.skip("needs a CUDA card")
    cases = _spread_cases(mc.query_tile(mc.SPREAD_MAX_WARPS))
    assert [n for n, _ in cases] == list(SPREAD_CASE_NAMES)
    return dict(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("items", SPREAD_ITEMS)
@pytest.mark.parametrize("name", SPREAD_CASE_NAMES)
def test_mesh_query_spread_matches_plain(cuda, spread_cases, name, items,
                                        k1_warps):
    """K1 at 1 to 512 items, and K2 on its lists, against their plain
    versions slot for slot: hits past a spread block's tile (in the
    first chunk of cells, and in the second beside the tile's), runs
    past the cap, delta postings with their own cap, the owner filter
    on two shards, query rows all pad; with K1 a block an item (as
    spread_warps chooses at these sizes) and a warp an item."""
    from dss_tpu_torch.ops import mesh_cuda as mc

    c = _tiled(spread_cases[name], items)
    wide = k1_warps
    before = (mc.mesh_query.launches, mc.mesh_query.spread_launches,
              mc.mesh_merge.launches)
    got = _mesh_run(mc, c, cuda)
    want = _mesh_run(mc, c, cuda, plain=True)
    torch.cuda.synchronize()
    assert (mc.mesh_query.launches - before[0],
            mc.mesh_query.spread_launches - before[1],
            mc.mesh_merge.launches - before[2]) == (1, int(wide > 1), 1)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g, w), (name, items)


@pytest.mark.gpu
def test_mesh_query_spread_on_dirty_outputs_and_back_to_back(cuda,
                                                            spread_cases):
    """The spread kernel writes every pad of an output the allocator
    hands back full of -1, and 40 launches over the cases at 64 items
    with no sync between them each equal the plain version."""
    from dss_tpu_torch.ops import mesh_cuda as mc

    runs = [cs.mesh_case_args(_tiled(spread_cases[n], 64), cuda)
            for n in SPREAD_CASE_NAMES]
    want = [mc.mesh_query_torch(*a, **kw) for a, kw, _ in runs]
    torch.cuda.synchronize()
    args, kw, _ = runs[4]
    dirty = torch.full((2, 32, kw["max_results"]), -1, dtype=torch.int32,
                       device=cuda)
    ptr = dirty.data_ptr()
    del dirty
    spread = mc.mesh_query.spread_launches
    got = mc.mesh_query(*args, **kw)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == ptr, "the -1 block was not handed back"
    assert all(torch.equal(g, w) for g, w in zip(got, want[4]))
    outs = [mc.mesh_query(*runs[i % len(runs)][0], **runs[i % len(runs)][1])
            for i in range(40)]
    torch.cuda.synchronize()
    assert mc.mesh_query.spread_launches - spread == 41
    for i, got in enumerate(outs):
        for g, w in zip(got, want[i % len(runs)]):
            assert torch.equal(g, w), i


@pytest.mark.gpu
def test_mesh_query_spreads_narrow_launches_only(cuda):
    """By the launch counters: at the benchmark cell's shape (64
    searches of 8 cells in a key width of 16, base_cap 1024) K1 is one
    launch, of the spread kernel; at 8,192 such searches (cap 128, the
    headline's) one launch of the one-warp kernel; count mode takes a
    warp an item at 64; launch_stats exports the spread count."""
    from dss_tpu_torch.ops import conflict as pc
    from dss_tpu_torch.ops import mesh_cuda as mc

    rng = np.random.default_rng(41)
    recs = _mesh_records(rng, 20000, 4000) + _same_window(600, lambda i: [7])
    p = pack_records(recs, pad_postings=False)
    assert p.base_cap == 1024
    q = _mesh_queries(rng, 8192, 4000)
    keys = np.full((8192, 16), -1, np.int32)
    keys[:, :8] = q[0]
    keys[::16, 7] = 7  # some searches reach the run of 600
    keys[:, :8].sort(axis=1)
    ents = pc._u8(_ents(p, cuda))
    post = [torch.from_numpy(a).to(cuda)[None] for a in (p.post_key,
                                                         p.post_ent)]
    rows = mc.pack_entity_rows(ents)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, cap, count in ((64, 1024, False), (8192, 128, False),
                          (64, 1024, True)):
        spec = pc.query_spec(keys[:n], *(a[:n] for a in q[1:]), cuda)
        now = torch.full((n,), NOW, dtype=torch.int64, device=cuda)
        args = (*post, None, None, ents, spec, now, None)
        kw = dict(rows=rows, cap=cap, delta_cap=0, max_results=512,
                  count=count)
        want = mc.mesh_query_torch(*args, **kw)
        before = (mc.mesh_query.launches, mc.mesh_query.spread_launches)
        got = mc.mesh_query(*args, **kw)
        torch.cuda.synchronize()
        spread = mc.spread_warps(n, sms) > 1 and not count
        assert spread == (n == 64 and not count)
        assert (mc.mesh_query.launches - before[0],
                mc.mesh_query.spread_launches - before[1]) == (1, int(spread))
        for g, w in zip((got,) if count else got, (want,) if count else want):
            assert torch.equal(g, w), (n, count)
    assert (mc.launch_stats()["dss_mesh_query_spread_launches"]
            == mc.mesh_query.spread_launches)
    occ = mc.occupancy()["spread"]
    assert occ["warps"] == mc.SPREAD_MAX_WARPS and occ["blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_mesh_kernels_reject_bad_input(cuda, mesh_cases):
    from dss_tpu_torch.ops import mesh_cuda as mc

    args, kw, mkw = cs.mesh_case_args(mesh_cases["random_k16_sp8"], cuda)
    pk, pe, dk, de, ents, q, now, owner = args
    with pytest.raises(ValueError, match="uint8"):  # active as bool
        mc.mesh_query(pk, pe, dk, de, ents._replace(
            active=ents.active.bool()), q, now, owner, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mc.mesh_query(pk, pe, dk, de, ents, q._replace(
            keys=q.keys.t().contiguous().t()), now, owner, **kw)
    with pytest.raises(ValueError, match="int64"):  # now as int32
        mc.mesh_query(pk, pe, dk, de, ents, q, now.int(), owner, **kw)
    with pytest.raises(ValueError, match="rows"):  # a row short
        mc.mesh_query(pk, pe, dk, de, ents, q, now, owner,
                      **dict(kw, rows=kw["rows"][1:]))
    slots, n_uni = mc.mesh_query(pk, pe, dk, de, ents, q, now, owner, **kw)
    with pytest.raises(ValueError, match="int32"):
        mc.mesh_merge(slots, n_uni.long(), **mkw)
    with pytest.raises(ValueError, match="contiguous"):
        mc.mesh_merge(slots.transpose(0, 1), n_uni, **mkw)


@pytest.mark.gpu
def test_sharded_dar_runs_the_mesh_kernels(cuda):
    """A cuda ShardedDar on a virtual 2x4 mesh at the size of the test
    above: each dp row is one K1 launch (its four positions share the
    card) and one K2 launch, the batch downloads only the kept columns,
    and the answers equal the CPU dar's; K1 and K2 on the row's own
    tensors equal their plain versions."""
    from dss_tpu_torch.ops import mesh_cuda as mc
    from dss_tpu_torch.parallel import ShardedDar, make_mesh
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import virtual_devices

    rng = np.random.default_rng(41)
    recs = _mesh_records(rng, 20000, 4000)
    q = _mesh_queries(rng, 512, 4000)
    a = ShardedDar(recs, make_mesh(8, dp=2, sp=4,
                                   devices=virtual_devices(cuda, 8)),
                   max_results=64, shard_results=16)
    b = ShardedDar(recs, make_mesh(8, dp=2, sp=4,
                                   devices=virtual_devices("cpu", 8)),
                   max_results=64, shard_results=16)
    before = (mc.mesh_query.launches, mc.mesh_merge.launches)
    assert a.query_batch(*q, now=NOW) == b.query_batch(*q, now=NOW)
    assert (mc.mesh_query.launches - before[0],
            mc.mesh_merge.launches - before[1]) == (2, 2)
    assert np.array_equal(a.shard_hits, b.shard_hits)
    assert a.overflow_fallbacks == b.overflow_fallbacks > 0
    dev = a.mesh.devices[0, 0]
    spec = ps.query_spec(np.pad(q[0], ((0, 0), (0, 8)), constant_values=-1),
                         *q[1:], dev)
    post = ps.Postings(a.post_key.rows(dev, [0, 1, 2, 3]),
                       a.post_ent.rows(dev, [0, 1, 2, 3]))
    now = torch.full((512,), NOW, dtype=torch.int64, device=dev)
    args = (post.post_key, post.post_ent, None, None, ps._u8(a.ents[dev]),
            spec, now, None)
    kw = dict(rows=a.rows[dev], cap=a.cap, delta_cap=0, max_results=16)
    got = mc.mesh_query(*args, **kw)
    want = mc.mesh_query_torch(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mkw = dict(shard_results=16, max_results=64)
    for g, w in zip(mc.mesh_merge(*got, **mkw),
                    mc.mesh_merge_torch(*got, **mkw)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_sharded_dar_uploads_in_one_staged_copy(cuda):
    """A cuda ShardedDar's shard rows and entity columns cross in one
    copy from registered host memory (parallel/sharded.py `place`): each
    is a view of one device buffer, 16-byte aligned and equal to the
    CPU dar's arrays, whether the build registers its own staging or
    two builds share one (`Staging`); the answers equal the CPU dar's."""
    from dss_tpu_torch.parallel import ShardedDar, make_mesh
    from dss_tpu_torch.parallel.mesh import virtual_devices
    from dss_tpu_torch.parallel.sharded import Staging

    rng = np.random.default_rng(43)
    recs = _mesh_records(rng, 3000, 800)
    b = ShardedDar(recs, make_mesh(2, dp=1, sp=2,
                                   devices=virtual_devices("cpu", 2)))
    staging = Staging()
    for st in (None, staging, staging):
        a = ShardedDar(recs, make_mesh(2, dp=1, sp=2,
                                       devices=virtual_devices(cuda, 2)),
                       staging=st)
        dev = a.mesh.devices[0, 0]
        got = [a.post_key.parts[dev][1], a.post_ent.parts[dev][1],
               *a.ents[dev]]
        want = [b.post_key.parts[torch.device("cpu")][1],
                b.post_ent.parts[torch.device("cpu")][1],
                *b.ents[torch.device("cpu")]]
        base = got[0].untyped_storage().data_ptr()
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)
            assert g.untyped_storage().data_ptr() == base
            assert (g.storage_offset() * g.element_size()) % 16 == 0
    q = _mesh_queries(rng, 64, 800)
    assert a.query_batch(*q, now=NOW) == b.query_batch(*q, now=NOW)


def _card_replica(cuda, tmp_path, recs, sp=4):
    from dss_tpu_torch.parallel import make_mesh
    from dss_tpu_torch.parallel.mesh import virtual_devices
    from dss_tpu_torch.parallel.replica import ShardedReplica

    wal = tmp_path / "dss.wal"
    wal.touch()
    rep = ShardedReplica(
        make_mesh(sp, dp=1, sp=sp, devices=virtual_devices(cuda, sp)),
        wal_path=str(wal), max_results=512, warm_batches=(1, 32),
    )
    with rep._mu:
        rep._records["isas"] = {r.entity_id: r for r in recs}
        rep._dirty["isas"] = True
    rep.refresh(plan=False)
    return rep


@pytest.mark.gpu
def test_replica_refreshes_while_the_graph_cache_captures(cuda, tmp_path):
    """A replica on a virtual 1x4 card mesh folds writes in a loop
    (delta refreshes and forced majors; old snapshots die on the
    refresh thread) while a warm thread captures B1 graphs on its own
    stream and a reader queries the replica: 0 capture failures, no
    error, every answer equal to the exact host answer."""
    import threading
    import time

    from dss_tpu_torch.ops.resident import GraphCache, ResidentKernel

    rng = np.random.default_rng(41)
    rep = _card_replica(cuda, tmp_path, _mesh_records(rng, 20000, 4000))
    cache = GraphCache()
    warm_ft = _table(rng, 20000, 4000, cuda)
    errors, stop = [], threading.Event()
    q = _mesh_queries(rng, 64, 4000)
    keys = list(q[0])
    published = threading.Lock()  # writes + their refresh, as one step

    def refresh():
        try:
            for i in range(16):
                with published:
                    with rep._mu:
                        for r in _mesh_records(rng, 400, 4000,
                                               prefix=f"w{i}_"):
                            rep._put("isas", r)
                        for eid in list(rep._records["isas"])[:100]:
                            rep._del("isas", eid)
                        rep._force_major["isas"] = i % 4 == 3
                    rep.refresh(plan=False)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                with published:  # one published state per check
                    got = rep.query_batch(keys, *q[1:], now=NOW, cls="isas")
                    want = rep.query_batch_host(keys, *q[1:], now=NOW,
                                                cls="isas")
                assert got == want
                time.sleep(0.002)  # let the writer take the lock
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    warm = ResidentKernel(cache, autocompile=False, instances=6)
    ths = [threading.Thread(target=refresh),
           threading.Thread(target=lambda: warm.warm(
               warm_ft, batch_buckets=(128, 1024, 4096),
               window_buckets=(256, 1024, 4096, 16384)))]
    rth = threading.Thread(target=read)
    rth.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    stop.set()
    rth.join(60)
    rep.close()
    assert not errors, errors
    assert cache.capture_failures == 0
    assert rep.stats()["replica_major_rebuilds"] >= 5
    assert rep.stats()["replica_delta_refreshes"] >= 8, rep.stats()


@pytest.mark.gpu
def test_a_reader_never_sees_unfinished_copies(cuda, tmp_path):
    """Each generation replaces every record (a major rebuild of about
    1.6M postings, copied from pageable host memory); a reader on its
    own stream queries throughout and must always see exactly one whole
    generation's ids, never a mix or a part."""
    import threading

    rng = np.random.default_rng(42)
    n, hot = 200_000, 64

    def generation(g):
        recs = _mesh_records(rng, n, 40_000, prefix=f"g{g}_")
        for r in recs:
            r.keys = r.keys + 16  # key 7 is the hot records' alone
        for i in range(hot):  # `hot` records of generation g on key 7
            recs[i] = Record(f"g{g}_hot{i}", np.asarray([7], np.int32),
                             -np.inf, np.inf, NOW - HOUR, NOW + HOUR, 0)
        return recs

    rep = _card_replica(cuda, tmp_path, generation(0))
    gens = [generation(g) for g in range(1, 7)]
    seen, bad, stop = set(), [], threading.Event()
    keys = [np.asarray([7], np.int32)]
    args = (np.asarray([-np.inf], np.float32), np.asarray([np.inf], np.float32),
            np.asarray([NOW], np.int64), np.asarray([NOW], np.int64))

    def read():
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            while not stop.is_set():
                ids = rep.query_batch(keys, *args, now=NOW, cls="isas")[0]
                prefixes = {i.split("_")[0] for i in ids}
                if len(ids) != hot or len(prefixes) != 1:
                    bad.append((len(ids), sorted(prefixes)))
                seen.update(prefixes)

    th = threading.Thread(target=read)
    th.start()
    for recs in gens:
        with rep._mu:
            rep._records["isas"] = {r.entity_id: r for r in recs}
            rep._base["isas"] = set()
            rep._delta["isas"] = {}
            rep._shadow["isas"] = set()
            rep._dirty["isas"] = True
        rep.refresh(plan=False)
    stop.set()
    th.join(60)
    rep.close()
    assert not bad, bad[:5]
    assert len(seen) >= 2, seen


# -- the autotune sweep (plan/autotune.py) ------------------------------------

SWEEP_ENTITIES, SWEEP_CELLS = 50_000, 20_000  # autotune()'s full fixture


def _pairs(res):
    qidx, slots = res
    return sorted(zip(np.asarray(qidx).tolist(), np.asarray(slots).tolist()))


@pytest.fixture(scope="module")
def sweep_tables():
    """The full sweep's fixture on the card and on the CPU (the same
    records: _fixture is seeded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dss_tpu_torch.plan import autotune as at

    card = at._fixture(SWEEP_ENTITIES, SWEEP_CELLS, device="cuda")
    host = at._fixture(SWEEP_ENTITIES, SWEEP_CELLS, device="cpu")
    yield card._state.snap.fast, host._state.snap.fast
    card.close()
    host.close()


@pytest.mark.gpu
def test_sweep_batches_through_b1_equal_the_plain_version(sweep_tables):
    """measure_hit_concentration's query_fused batch and both of
    measure_device's batch sizes launch B1 eagerly, with the plain
    version's answers; the hit concentration comes out equal."""
    from dss_tpu_torch.plan import autotune as at

    card, host = sweep_tables
    launches = ff.fused_window_filter.launches
    batches = [at._query_batch(19, 256, SWEEP_CELLS)] + [
        at._query_batch(13 + n, n, SWEEP_CELLS) for n in (128, 1024)]
    for qb in batches:
        got = card.query_fused(*qb, now=at.NOW)
        assert len(got[0]) > 0
        assert _pairs(got) == _pairs(host.query_fused(*qb, now=at.NOW))
        got = card.collect(card.submit(*qb, now=at.NOW))
        assert _pairs(got) == _pairs(host.collect(host.submit(*qb,
                                                              now=at.NOW)))
    assert ff.fused_window_filter.launches - launches == 2 * len(batches)
    assert at.measure_hit_concentration(card, SWEEP_CELLS) == (
        at.measure_hit_concentration(host, SWEEP_CELLS))


@pytest.mark.gpu
def test_resident_ladder_replays_equal_eager_b1(sweep_tables):
    """measure_resident's ladder on the card: at every depth (2, 4, 8,
    16) the batches submitted before any collect each replay a captured
    graph of the one reserved entry, and each answer equals eager B1
    and the plain version."""
    from dss_tpu_torch.ops.resident import ResidentKernel
    from dss_tpu_torch.plan import autotune as at

    card, host = sweep_tables
    depths = (2, 4, 8, 16)
    qb = at._query_batch(17, 128, SWEEP_CELLS)
    wb = max(256, card._pack_windows(qb[0])[0].shape[1])
    kern = ResidentKernel(autocompile=False, instances=max(depths))
    kern.warm(card, batch_buckets=(pow2_bucket(128, lo=16),),
              window_buckets=(wb,))
    for d in depths:
        shifted = [(qb[0], qb[1], qb[2], qb[3] + i, qb[4] + i)
                   for i in range(d)]
        replays = ff.fused_window_filter.graph_replays
        pend = [card.submit(*q, now=at.NOW, kernel=kern) for q in shifted]
        assert ff.fused_window_filter.graph_replays - replays == d
        got = [card.collect(p) for p in pend]
        for q, g in zip(shifted, got):
            assert len(g[0]) > 0
            assert _pairs(g) == _pairs(card.query_fused(*q, now=at.NOW))
            assert _pairs(g) == _pairs(host.query_fused(*q, now=at.NOW))
    assert kern.misses == 0 and kern.busy == 0
    assert kern.hits == sum(depths)


@pytest.mark.gpu
def test_two_process_mesh_on_the_card_equals_one_process(cuda, tmp_path):
    """The multihost dryrun's first legs on the card: two processes
    with two positions each on it form a global 1x4 mesh (gloo on
    host-staged shards) whose answers equal one process's 1x4 mesh on
    the card; the survivor of a killed follower degrades and answers
    equal, from its host map and then from a local mesh on the card."""
    from dss_tpu_torch.cmds.multihost_dryrun import run_dryrun

    v = run_dryrun(str(tmp_path), num_processes=2, devices_per_process=2,
                   reps=1, timeout_s=240, elastic=False, capacity=False,
                   device="cuda")
    assert v["ok"] and v["bit_identical"] and v["peerloss_ok"], v
    assert v["multi"]["placement"] == {"0": [0, 1], "1": [2, 3]}
    assert v["multi"]["device"] == "cuda"
    assert v["multi"]["stats"]["dss_multihost_gathers"] > 0
    assert v["peerloss"]["stats"]["dss_multihost_degraded"] == 1

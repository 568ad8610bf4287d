"""The CUDA kernels against their plain PyTorch versions.

B1 (the fused window filter), B2 and B3 (the quantized window mask) and
B4 (the exact window mask), each on card tensors against its plain
version on the same tensors; masks and words must be equal exactly.
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
route (ops/conflict.py's torch ops under parallel/sharded.py): a cuda
ShardedDar on a virtual 2x4 mesh equals the CPU one; a replica
refreshes in a loop while the GraphCache captures on another thread,
with 0 capture failures; a reader on its own stream never sees a
snapshot whose copies have not finished.  The autotune sweep
(plan/autotune.py) at its full 50,000 x 20,000 fixture:
measure_device's and measure_hit_concentration's batches through B1
equal the plain version, and at every depth of measure_resident's
ladder (2, 4, 8, 16 submits before any collect) each submit replays a
captured graph whose answer equals eager B1 and the plain version.

Needs a CUDA card (marker `gpu`); skips elsewhere.  This file imports
neither jax nor the reference package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

The card's full check, at the main path's shapes, is chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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


@pytest.mark.gpu
def test_mask_kernels_count_launches_and_reject_bad_input(cuda):
    rng = np.random.default_rng(9)
    ft = _table(rng, 500, 100, cuda)
    _, _, args = ft._legacy_inputs(*_queries(rng, 50, 4, 100))
    before = (fc.filter_windows.launches, fc.filter_windows_gridless.launches)
    fc.filter_windows(ft.p3, *args)
    fc.filter_windows_gridless(ft.p3, *(a[:64] for a in args))
    assert (fc.filter_windows.launches,
            fc.filter_windows_gridless.launches) == (before[0] + 1,
                                                     before[1] + 1)
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
    ents = pc.entity_table(packed, "cpu")
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

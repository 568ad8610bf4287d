"""The port's legacy quantized-mask path against the JAX reference (CPU).

`FastTable.query_batch` (both routes: the B2 kernel's plain version and
the XLA route as torch ops), `exact_filter` and the `p3` columns of the
port, built with device="cpu", against the reference `FastTable` on the
same numpy arrays, and the cases of tests/test_fastpath.py against the
oracle.  Exact: set queries and masks have no tolerance.  Also the
tables built without `slot_exact`, which have only `p3`.
"""

from __future__ import annotations

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax.numpy as jnp
from dss_tpu.dar import oracle
from dss_tpu.dar.oracle import Record
from dss_tpu.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu.ops import fastpath as ref_fastpath
from dss_tpu.ops.fastpath import FastTable as RefFastTable

from dss_tpu_torch import convert
from dss_tpu_torch.ops import fastpath as fp
from dss_tpu_torch.ops.fastpath import FastTable

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000


def _records(rng, n, key_space=400):
    recs = []
    for i in range(n):
        keys = np.unique(
            rng.integers(0, key_space, int(rng.integers(1, 10))).astype(np.int32)
        )
        alo, ahi = sorted(rng.uniform(0, 3000, 2))
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        t1 = t0 + int(rng.integers(1, 8)) * HOUR
        recs.append(Record(f"e{i}", keys, float(alo), float(ahi), t0, t1,
                           int(rng.integers(0, 5))))
    return recs


def _postings(recs):
    pk, pe = [], []
    for slot, r in enumerate(recs):
        pk.extend(int(k) for k in r.keys)
        pe.extend([slot] * len(r.keys))
    pk, pe = np.asarray(pk, np.int32), np.asarray(pe, np.int32)
    order = np.argsort(pk, kind="stable")
    return pk[order], pe[order]


def _exact_arrays(recs):
    return dict(
        records_alt_lo=np.asarray([r.alt_lo for r in recs], np.float32),
        records_alt_hi=np.asarray([r.alt_hi for r in recs], np.float32),
        records_t0=np.asarray([r.t_start for r in recs], np.int64),
        records_t1=np.asarray([r.t_end for r in recs], np.int64),
        records_live=np.ones(len(recs), bool),
    )


def _both(recs, *, slot_exact, live=None, alt_dtype=np.float32):
    """(reference, port) tables on the same arrays."""
    pk, pe = _postings(recs)
    args = (
        pk, pe,
        np.asarray([recs[s].alt_lo for s in pe], alt_dtype),
        np.asarray([recs[s].alt_hi for s in pe], alt_dtype),
        np.asarray([recs[s].t_start for s in pe], np.int64),
        np.asarray([recs[s].t_end for s in pe], np.int64),
        np.ones(len(pe), bool) if live is None else live(pe),
    )
    se = None
    if slot_exact:
        ex = _exact_arrays(recs)
        se = dict(alt_lo=ex["records_alt_lo"], alt_hi=ex["records_alt_hi"],
                  t0=ex["records_t0"], t1=ex["records_t1"],
                  live=ex["records_live"])
    ref = RefFastTable(
        *args, slot_exact=None if se is None else {k: v.copy() for k, v in se.items()}
    )
    port = FastTable(
        *args, slot_exact=None if se is None else {k: v.copy() for k, v in se.items()},
        device="cpu",
    )
    return ref, port


def _queries(rng, B=8, W=16, key_space=400):
    qkeys = np.full((B, W), -1, np.int32)
    alo = np.full(B, -np.inf, np.float32)
    ahi = np.full(B, np.inf, np.float32)
    ts = np.full(B, NO_TIME_LO, np.int64)
    te = np.full(B, NO_TIME_HI, np.int64)
    for i in range(B):
        u = np.unique(
            rng.integers(0, key_space, int(rng.integers(1, W))).astype(np.int32)
        )
        qkeys[i, : len(u)] = u
        if i % 2:
            a, b = sorted(rng.uniform(0, 3000, 2))
            alo[i], ahi[i] = a, b
        if i % 3:
            ts[i] = NOW - 2 * HOUR
            te[i] = NOW + 2 * HOUR
    return qkeys, alo, ahi, ts, te


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype


# -- p3 -------------------------------------------------------------------


@pytest.mark.parametrize("slot_exact", [True, False])
@pytest.mark.parametrize("alt_dtype", [np.float32, np.float64])
def test_p3_is_byte_identical(slot_exact, alt_dtype):
    rng = np.random.default_rng(1)
    recs = _records(rng, 300)
    # unbounded bands and times, and build-time dead postings
    recs[0] = Record("inf", recs[0].keys, -np.inf, np.inf, NO_TIME_LO,
                     NO_TIME_HI, 0)
    ref, port = _both(recs, slot_exact=slot_exact, alt_dtype=alt_dtype,
                      live=lambda pe: pe % 7 != 3)
    want = np.asarray(ref.p3)
    got = port.p3.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert port.n_blocks == ref.n_blocks
    assert (got[:, 4] == np.iinfo(np.int32).min).any()  # dead postings
    assert (got[-1] == np.iinfo(np.int32).max).all()  # pad lanes
    assert port.bitpack_w.numpy().tobytes() == np.asarray(
        ref.bitpack_w).tobytes()


def test_quantizers_match_reference():
    x = np.asarray([-np.inf, -1e12, -0.0015, -0.001, 0.0, 0.0004, 1.9999,
                    2.5e6, 1e12, np.inf])
    for name in ("mm_floor", "mm_ceil"):
        np.testing.assert_array_equal(getattr(fp, name)(x),
                                      getattr(ref_fastpath, name)(x))
    t = np.asarray([-(2**63), -(10**9) - 1, -(10**9), -1, 0, 1, 10**9,
                    10**9 + 1, NOW - 1, 2**63 - 1], np.int64)
    for name in ("sec_floor", "sec_ceil"):
        np.testing.assert_array_equal(getattr(fp, name)(t),
                                      getattr(ref_fastpath, name)(t))


# -- query_batch / exact_filter against the reference ---------------------


@pytest.mark.parametrize("seed,n,hot", [(2, 300, None), (3, 120, 7)])
def test_query_batch_matches_reference_both_routes(seed, n, hot):
    rng = np.random.default_rng(seed)
    recs = _records(rng, n)
    if hot is not None:  # a long run over several blocks
        recs += [Record(f"h{i}", np.asarray([hot], np.int32), 0.0, 100.0,
                        NOW - HOUR, NOW + HOUR, 0) for i in range(300)]
    ref, port = _both(recs, slot_exact=True)
    q = _queries(rng, B=12)
    want = ref.query_batch(*q, now=NOW)
    assert len(want[0]) > 0
    _same(ref.query_batch(*q, now=NOW, use_pallas=True, interpret=True), want)
    for use_kernel in (False, True):
        _same(port.query_batch(*q, now=NOW, use_kernel=use_kernel), want)
    ex = _exact_arrays(recs)
    ex["records_live"][::5] = False
    qkeys, alo, ahi, ts, te = q
    now_q = NOW + rng.integers(-3, 3, len(qkeys)) * HOUR
    for now in (NOW, now_q):  # a scalar and a per-query request time
        args = dict(**ex, alt_lo=alo, alt_hi=ahi, t_start=ts, t_end=te,
                    now=now)
        _same(port.exact_filter(*want, **args), ref.exact_filter(*want, **args))


def test_filter_words_match_filter_xla_across_chunks(monkeypatch):
    """The words route equals the reference's _filter_xla words, also
    when the windows span several chunks."""
    monkeypatch.setattr(fp, "PLAIN_CHUNK", 64)
    rng = np.random.default_rng(4)
    ref, port = _both(_records(rng, 400), slot_exact=False)
    q = _queries(rng, B=24)
    _, _, args = port._legacy_inputs(*q)
    assert args[0].shape[0] > 64
    got = port._filter_words(*args).numpy()
    want = np.asarray(ref._filter_xla(
        ref.p3, ref.bitpack_w, *(jnp.asarray(a.numpy()) for a in args)
    ))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_empty_batch_returns_empty_pairs():
    rng = np.random.default_rng(5)
    ref, port = _both(_records(rng, 50), slot_exact=False)
    qkeys = np.full((2, 4), -1, np.int32)
    qkeys[0, 0] = 9999  # no postings
    q = (qkeys, np.zeros(2, np.float32), np.ones(2, np.float32),
         np.zeros(2, np.int64), np.ones(2, np.int64))
    for use_kernel in (False, True):
        _same(port.query_batch(*q, now=NOW, use_kernel=use_kernel),
              ref.query_batch(*q, now=NOW))


def test_sub_unit_edges_round_outward():
    """Postings whose bounds lie within a millimetre or a second of the
    query's pass the conservative filter exactly as in the reference
    (query and table bounds both round outward), and exact_filter then
    keeps only the true overlaps."""
    qalo, qahi = 100.0003, 200.0003
    ts, te = NOW + 500_000_000, NOW + HOUR + 500_000_000
    recs = []
    for i, d in enumerate((-0.0015, -0.0009, -0.0004, 0.0, 0.0004, 0.0009,
                           0.0012)):
        # alt_lo just above/below the query's top, and alt_hi around
        # its bottom
        recs.append(Record(f"a{i}", np.asarray([5], np.int32), qahi + d,
                           qahi + 50.0, ts, te, 0))
        recs.append(Record(f"b{i}", np.asarray([5], np.int32), qalo - 50.0,
                           qalo + d, ts, te, 0))
    for i, d in enumerate((-10**9 - 1, -10**9, -1, 0, 1, 10**9 - 1, 10**9)):
        recs.append(Record(f"c{i}", np.asarray([5], np.int32), 150.0, 160.0,
                           te + d, te + HOUR, 0))
        recs.append(Record(f"d{i}", np.asarray([5], np.int32), 150.0, 160.0,
                           ts - HOUR, ts + d, 0))
    ref, port = _both(recs, slot_exact=False)
    qkeys = np.full((1, 4), -1, np.int32)
    qkeys[0, 0] = 5
    q = (qkeys, np.asarray([qalo], np.float32), np.asarray([qahi], np.float32),
         np.asarray([ts], np.int64), np.asarray([te], np.int64))
    want = ref.query_batch(*q, now=NOW)
    for use_kernel in (False, True):
        _same(port.query_batch(*q, now=NOW, use_kernel=use_kernel), want)
    args = dict(**_exact_arrays(recs), alt_lo=q[1], alt_hi=q[2],
                t_start=q[3], t_end=q[4], now=NOW)
    qidx, slots = port.exact_filter(*want, **args)
    _same((qidx, slots), ref.exact_filter(*want, **args))
    assert len(slots) < len(want[1])  # some edges passed only the filter
    expect = oracle.search(dict(enumerate(recs)), qkeys[0, :1], float(q[1][0]),
                           float(q[2][0]), ts, te, NOW)
    assert sorted(set(slots.tolist())) == sorted(expect)


# -- the cases of tests/test_fastpath.py ------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fastpath_matches_oracle(use_kernel):
    rng = np.random.default_rng(42)
    recs = _records(rng, 250)
    ref, port = _both(recs, slot_exact=False)
    qkeys, alo, ahi, ts, te = _queries(rng)
    qidx, offs = port.query_batch(qkeys, alo, ahi, ts, te, now=NOW,
                                  use_kernel=use_kernel)
    _same((qidx, offs), ref.query_batch(
        qkeys, alo, ahi, ts, te, now=NOW, use_pallas=use_kernel,
        interpret=use_kernel,
    ))
    qidx, slots = port.exact_filter(
        qidx, offs, **_exact_arrays(recs),
        alt_lo=alo, alt_hi=ahi, t_start=ts, t_end=te, now=NOW,
    )
    recs_map = dict(enumerate(recs))
    for i in range(len(qkeys)):
        want = sorted(oracle.search(
            recs_map,
            qkeys[i][qkeys[i] >= 0],
            None if alo[i] == -np.inf else float(alo[i]),
            None if ahi[i] == np.inf else float(ahi[i]),
            None if ts[i] == NO_TIME_LO else int(ts[i]),
            None if te[i] == NO_TIME_HI else int(te[i]),
            NOW,
        ))
        assert sorted(set(slots[qidx == i].tolist())) == want, i


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fastpath_hot_cell_long_run(use_kernel):
    """A run of 500 postings over 5 blocks returns every entity, on a
    table built without slot_exact."""
    n = 500
    pk = np.full(n + 10, 7, np.int32)
    pk[n:] = 9
    pe = np.arange(n + 10, dtype=np.int32)
    pe[n:] = np.arange(10)
    args = (
        pk, pe, np.zeros(n + 10, np.float32),
        np.full(n + 10, 100.0, np.float32),
        np.full(n + 10, NOW - HOUR, np.int64),
        np.full(n + 10, NOW + HOUR, np.int64), np.ones(n + 10, bool),
    )
    ref = RefFastTable(*args)
    port = FastTable(*args, device="cpu")
    qkeys = np.full((1, 16), -1, np.int32)
    qkeys[0, 0] = 7
    q = (qkeys, np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32),
         np.full(1, NO_TIME_LO, np.int64), np.full(1, NO_TIME_HI, np.int64))
    qidx, offs = port.query_batch(*q, now=NOW, use_kernel=use_kernel)
    _same((qidx, offs), ref.query_batch(*q, now=NOW, use_pallas=use_kernel,
                                        interpret=use_kernel))
    assert len(np.unique(port.host_ent[offs])) == n


def test_fastpath_tombstones_and_subsecond_edges():
    """An entity ending 1 ns before the window passes the quantized
    filter (its end rounds up to the next second) and exact_filter
    drops it; a tombstoned slot never comes back."""
    rng = np.random.default_rng(1)
    recs = _records(rng, 20)
    t_q = NOW + HOUR
    recs[0] = Record("edge", np.asarray([7], np.int32), 0.0, 100.0,
                     NOW - HOUR, t_q - 1, 0)
    ref, port = _both(recs, slot_exact=False, live=lambda pe: pe != 3)
    for key in (7, int(recs[3].keys[0])):
        qkeys = np.full((1, 16), -1, np.int32)
        qkeys[0, 0] = key
        alo = np.full(1, -np.inf, np.float32)
        ahi = np.full(1, np.inf, np.float32)
        ts = np.asarray([t_q], np.int64)
        te = np.asarray([t_q + HOUR], np.int64)
        qidx, offs = port.query_batch(qkeys, alo, ahi, ts, te, now=NOW)
        _same((qidx, offs), ref.query_batch(qkeys, alo, ahi, ts, te, now=NOW))
        if key == 7:
            assert 0 in port.host_ent[offs].tolist()  # passed the filter
        ex = _exact_arrays(recs)
        ex["records_live"][3] = False
        args = dict(**ex, alt_lo=alo, alt_hi=ahi, t_start=ts, t_end=te,
                    now=NOW)
        got = port.exact_filter(qidx, offs, **args)
        _same(got, ref.exact_filter(qidx, offs, **args))
        assert 0 not in got[1].tolist()
        assert 3 not in got[1].tolist()


# -- tables without slot_exact ------------------------------------------------


def test_table_without_slot_exact_has_only_the_legacy_path():
    rng = np.random.default_rng(6)
    recs = _records(rng, 80)
    ref, port = _both(recs, slot_exact=False)
    q = _queries(rng, B=4)
    assert port.slot_exact is None and port.b_alo is None
    for table in (ref, port):
        assert table.host_candidates(q[0]) is None
        assert table.query_host_auto(*q, now=NOW) is None
        assert table.query_host_chunked(*q, now=NOW) is None
    port.mark_dead(0)  # no exact columns: nothing to mark
    with pytest.raises(ValueError, match="no exact columns"):
        port.query_fused(*q, now=NOW)
    with pytest.raises(ValueError, match="no exact columns"):
        port.submit(*q, now=NOW)
    _same(port.query_batch(*q, now=NOW), ref.query_batch(*q, now=NOW))


@pytest.mark.parametrize("slot_exact", [True, False])
def test_convert_carries_p3(slot_exact):
    rng = np.random.default_rng(7)
    ref, _ = _both(_records(rng, 200), slot_exact=slot_exact)
    cols = (ref.b_alo, ref.b_ahi, ref.b_t0, ref.b_t1) if slot_exact else ()
    port = convert.fasttable_from_arrays(
        ref.host_key, ref.host_ent, ref.host_live, ref.slot_exact, *cols,
        p3=np.asarray(ref.p3), device="cpu",
    )
    assert port.p3.numpy().tobytes() == np.asarray(ref.p3).tobytes()
    q = _queries(rng, B=10)
    for use_kernel in (False, True):
        _same(port.query_batch(*q, now=NOW, use_kernel=use_kernel),
              ref.query_batch(*q, now=NOW))
    if slot_exact:
        _same(port.query_fused(*q, now=NOW), ref.query_fused(*q, now=NOW))
    else:
        assert port.slot_exact is None
        with pytest.raises(ValueError):
            convert.fasttable_from_arrays(
                ref.host_key, ref.host_ent, ref.host_live, None,
                np.zeros((port.n_blocks, 128), np.float32),
                p3=np.asarray(ref.p3), device="cpu",
            )

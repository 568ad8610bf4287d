"""The port's plain fused window filter against the JAX reference (CPU).

`fused_window_filter_torch` must give the flat output of the reference's
`FastTable._fused_xla` exactly (count, word positions, bits), and its
pre-compaction words must equal the Pallas `_fused_kernel` twin run in
interpret mode.  Set queries: the tolerance is zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax.numpy as jnp
from dss_tpu.dar.oracle import Record as RefRecord
from dss_tpu.dar.pack import pack_records as ref_pack_records
from dss_tpu.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu.ops.fastpath import FastTable as RefFastTable
from dss_tpu.ops.fastpath import pow2_bucket as ref_pow2_bucket
from dss_tpu.ops.fastpath_pallas import GROUP, fused_filter_pack_pallas

from dss_tpu_torch import convert
from dss_tpu_torch.ops import fused_filter as ff

HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000


def _ref_table(recs):
    packed = ref_pack_records(recs, pad_postings=False)
    pe = packed.post_ent
    return RefFastTable(
        packed.post_key, pe,
        packed.alt_lo[pe], packed.alt_hi[pe],
        packed.t_start[pe], packed.t_end[pe],
        packed.active[pe],
        slot_exact={
            "alt_lo": packed.alt_lo, "alt_hi": packed.alt_hi,
            "t0": packed.t_start, "t1": packed.t_end,
            "live": packed.active.copy(),
        },
    )


def _random_records(rng, n, n_cells=400, hot_cell=None):
    recs = []
    for i in range(n):
        k = np.unique(rng.integers(0, n_cells, rng.integers(1, 6)))
        if hot_cell is not None and i % 3 == 0:
            k = np.unique(np.append(k, hot_cell))
        alo = float(rng.uniform(0, 3000))
        t0 = NOW + int(rng.integers(-4, 4)) * HOUR
        recs.append(
            RefRecord(
                entity_id=f"e{i}",
                keys=k.astype(np.int32),
                alt_lo=alo if i % 4 else -np.inf,
                alt_hi=alo + 400.0 if i % 4 else np.inf,
                t_start=t0 if i % 5 else NO_TIME_LO,
                t_end=t0 + 2 * HOUR if i % 5 else NO_TIME_HI,
                owner_id=i % 7,
            )
        )
    return recs


def _random_queries(rng, b, w, n_cells=400):
    qkeys = np.full((b, w), -1, np.int32)
    alo = np.full(b, -np.inf, np.float32)
    ahi = np.full(b, np.inf, np.float32)
    ts = np.full(b, NO_TIME_LO, np.int64)
    te = np.full(b, NO_TIME_HI, np.int64)
    for i in range(b):
        u = np.unique(
            rng.integers(0, n_cells, rng.integers(1, w)).astype(np.int32)
        )
        qkeys[i, : len(u)] = u
        if i % 2:
            a, bb = sorted(rng.uniform(0, 3400, 2))
            alo[i], ahi[i] = a, bb
        if i % 3:
            ts[i] = NOW - 2 * HOUR
            te[i] = NOW + 2 * HOUR
    return qkeys, alo, ahi, ts, te


def _port_args(ref, wins, alo, ahi, t0_eff, te):
    t = torch.from_numpy
    return (
        t(np.array(ref.b_alo)), t(np.array(ref.b_ahi)),
        t(np.array(ref.b_t0)), t(np.array(ref.b_t1)),
        t(np.ascontiguousarray(wins)),
        t(np.asarray(alo, np.float32)), t(np.asarray(ahi, np.float32)),
        t(np.asarray(t0_eff, np.int64)), t(np.asarray(te, np.int64)),
    )


def _both(ref, qkeys, alo, ahi, ts, te, max_words=None):
    """(reference flat, port flat, wins, nw) on the same windows."""
    wins, _, _, nw = ref._pack_windows(qkeys)
    assert nw > 0
    wins = np.asarray(wins)
    mw = ref_pow2_bucket(nw, lo=1 << 16) if max_words is None else max_words
    t0_eff = np.maximum(ts, np.int64(NOW))
    want = np.asarray(
        ref._fused_xla(
            ref.b_alo, ref.b_ahi, ref.b_t0, ref.b_t1,
            jnp.asarray(wins),
            jnp.asarray(alo, jnp.float32), jnp.asarray(ahi, jnp.float32),
            jnp.asarray(t0_eff, jnp.int64), jnp.asarray(te, jnp.int64),
            max_words=mw,
        )
    )
    got = ff.fused_window_filter_torch(
        *_port_args(ref, wins, alo, ahi, t0_eff, te), max_words=mw
    ).numpy()
    return want, got, wins, nw


def _pallas_words(ref, wins, nw, alo, ahi, ts, te):
    """The Pallas twin's (nw, 4) pre-compaction words, interpret mode."""
    win_blk, meta = wins[0][:nw], wins[1][:nw]
    win_q = meta >> 16
    pad = (-nw) % GROUP
    z = np.zeros(pad, np.int32)
    t0_eff = np.maximum(ts, np.int64(NOW))
    words = fused_filter_pack_pallas(
        ref.b_alo, ref.b_ahi, ref.b_t0, ref.b_t1,
        jnp.asarray(np.concatenate([win_blk, z]), jnp.int32),
        jnp.asarray(np.concatenate([meta & 0xFFFF, z]), jnp.int32),
        jnp.asarray(np.concatenate([alo[win_q], z.astype(np.float32)])),
        jnp.asarray(np.concatenate([ahi[win_q], z.astype(np.float32)])),
        jnp.asarray(np.concatenate([t0_eff[win_q], z.astype(np.int64)])),
        jnp.asarray(np.concatenate([te[win_q], z.astype(np.int64)])),
        interpret=True,
    )
    return np.asarray(words)[:nw]


@pytest.mark.parametrize(
    "seed,n,hot", [(1, 120, None), (2, 300, 7), (3, 60, None), (4, 900, 11)]
)
def test_plain_filter_matches_reference_flat(seed, n, hot):
    rng = np.random.default_rng(seed)
    ref = _ref_table(_random_records(rng, n, hot_cell=hot))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 12, 16)
    want, got, _, _ = _both(ref, qkeys, alo, ahi, ts, te)
    assert want.dtype == got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) > 0  # the case really produced hits


def test_plain_words_match_pallas_interpret():
    # one random case: each Pallas interpret compile costs ~10 s of CPU
    rng = np.random.default_rng(2)
    ref = _ref_table(_random_records(rng, 300, hot_cell=7))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 8, 16)
    wins, _, _, nw = ref._pack_windows(qkeys)
    wins = np.asarray(wins)
    t0_eff = np.maximum(ts, np.int64(NOW))
    got = ff.filter_pack_torch(
        *_port_args(ref, wins, alo, ahi, t0_eff, te)
    ).numpy()[:nw]
    want = _pallas_words(ref, wins, nw, alo, ahi, ts, te)
    np.testing.assert_array_equal(got, want)


def _full_block_records(n=128):
    """One cell whose run fills a whole 128-lane block, all matching."""
    return [
        RefRecord(
            entity_id=f"f{i}", keys=np.asarray([5], np.int32),
            alt_lo=0.0, alt_hi=100.0,
            t_start=NOW - HOUR, t_end=NOW + HOUR, owner_id=0,
        )
        for i in range(n)
    ]


def _one_query(key, alo=-np.inf, ahi=np.inf):
    qkeys = np.full((1, 16), -1, np.int32)
    qkeys[0, 0] = key
    return (
        qkeys,
        np.asarray([alo], np.float32), np.asarray([ahi], np.float32),
        np.asarray([NO_TIME_LO], np.int64), np.asarray([NO_TIME_HI], np.int64),
    )


def test_lane31_words_keep_the_sign_bit():
    ref = _ref_table(_full_block_records())
    q = _one_query(5)
    want, got, wins, nw = _both(ref, *q)
    np.testing.assert_array_equal(got, want)
    mw = (len(got) - 1) // 2
    n = int(got[0])
    bits = got[1 + mw : 1 + mw + n]
    # every lane hits somewhere: a full word is 0xFFFFFFFF == -1 as i32
    assert n >= 1 and (bits == -1).any()
    assert (bits.view(np.uint32) & np.uint32(1 << 31)).any()
    words = _pallas_words(ref, wins, nw, *q[1:])
    t0_eff = np.maximum(q[3], np.int64(NOW))
    port_words = ff.filter_pack_torch(
        *_port_args(ref, wins, q[1], q[2], t0_eff, q[4])
    ).numpy()[:nw]
    np.testing.assert_array_equal(port_words, words)


def test_all_empty_windows_give_zero_count():
    ref = _ref_table(_full_block_records())
    # the run is there (windows exist) but no altitude overlaps
    want, got, _, nw = _both(ref, *_one_query(5, alo=500.0, ahi=900.0))
    assert nw >= 1
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == 0 and not got[1:].any()


def test_pad_windows_never_match():
    rng = np.random.default_rng(9)
    ref = _ref_table(_random_records(rng, 200))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 3, 4)
    want, got, wins, nw = _both(ref, qkeys, alo, ahi, ts, te)
    assert wins.shape[1] > nw  # the bucket holds pad windows
    assert not wins[:, nw:].any()  # blk 0, meta 0
    np.testing.assert_array_equal(got, want)
    mw = (len(got) - 1) // 2
    pos = got[1 : 1 + int(got[0])]
    assert (pos < nw * ff.WORDS).all()  # no word from a pad window
    assert (np.diff(pos) > 0).all()  # ascending positions


@pytest.mark.parametrize("max_words", [0, 1, 4, 16, "true_count"])
def test_overflow_keeps_true_count_and_prefix(max_words):
    rng = np.random.default_rng(12)
    ref = _ref_table(_random_records(rng, 400, hot_cell=3))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 12, 16)
    exact = max_words == "true_count"
    if exact:  # room for every word and not one more: no tail
        max_words = int(_both(ref, qkeys, alo, ahi, ts, te)[1][0])
    want, got, _, _ = _both(ref, qkeys, alo, ahi, ts, te, max_words=max_words)
    if exact:
        assert max_words > 0 and int(got[0]) == max_words
    else:
        assert int(got[0]) > max_words  # really overflowed
    assert len(got) == 1 + 2 * max_words
    np.testing.assert_array_equal(got, want)


def test_window_count_off_the_group_multiple():
    """A window list cut to its nw windows (no pad bucket), with nw not
    a multiple of 32: the same output as the reference."""
    rng = np.random.default_rng(13)
    ref = _ref_table(_random_records(rng, 500, hot_cell=5))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 10, 12)
    wins, _, _, nw = ref._pack_windows(qkeys)
    assert nw % 32
    wins = np.ascontiguousarray(np.asarray(wins)[:, :nw])
    t0_eff = np.maximum(ts, np.int64(NOW))
    mw = ref_pow2_bucket(nw, lo=1 << 16)
    want = np.asarray(
        ref._fused_xla(
            ref.b_alo, ref.b_ahi, ref.b_t0, ref.b_t1, jnp.asarray(wins),
            jnp.asarray(alo, jnp.float32), jnp.asarray(ahi, jnp.float32),
            jnp.asarray(t0_eff, jnp.int64), jnp.asarray(te, jnp.int64),
            max_words=mw,
        )
    )
    got = ff.fused_window_filter_torch(
        *_port_args(ref, wins, alo, ahi, t0_eff, te), max_words=mw
    ).numpy()
    assert int(got[0]) > 0
    np.testing.assert_array_equal(got, want)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(5)
    ref = _ref_table(_random_records(rng, 150))
    qkeys, alo, ahi, ts, te = _random_queries(rng, 6, 8)
    wins, _, _, nw = ref._pack_windows(qkeys)
    args = _port_args(ref, np.asarray(wins), alo, ahi,
                      np.maximum(ts, np.int64(NOW)), te)
    before = ff.fused_window_filter.launches
    a = ff.fused_window_filter(*args, max_words=1 << 16)
    b = ff.fused_window_filter_torch(*args, max_words=1 << 16)
    assert torch.equal(a, b)
    assert ff.fused_window_filter.launches == before  # no kernel launch


def test_fasttable_from_reference_columns_is_byte_identical():
    rng = np.random.default_rng(6)
    ref = _ref_table(_random_records(rng, 250))
    port = convert.fasttable_from_arrays(
        ref.host_key, ref.host_ent, ref.host_live, ref.slot_exact,
        ref.b_alo, ref.b_ahi, ref.b_t0, ref.b_t1, p3=np.asarray(ref.p3),
        device="cpu",
    )
    for name in ("p3", "b_alo", "b_ahi", "b_t0", "b_t1"):
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name

"""The port's plain window-mask versions against the JAX reference (CPU).

B2 `filter_windows_torch` against `filter_windows_pallas` (interpret
mode) and the unpacked words of `FastTable._filter_xla`; B3 (the same
plain version) against `filter_windows_gridless` (interpret mode); B4
`fused_filter_mask_torch` against `fused_filter_gridless` (interpret
mode, i64 times as split i32 planes).  Both sides get the same arrays,
made from numpy with a seed.  These are masks: the tolerance is zero.
Every interpret case keeps one shape per kernel (NB blocks, NW
windows), so each Pallas kernel compiles once per process.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax.numpy as jnp
from dss_tpu.ops.fastpath import FastTable as RefFastTable
from dss_tpu.ops.fastpath import _bitpack_weights as ref_bitpack_weights
from dss_tpu.ops.fastpath_pallas import (
    filter_windows_gridless as ref_gridless,
    filter_windows_pallas,
    fused_filter_gridless as ref_exact_gridless,
)

from dss_tpu_torch.ops import fastpath_cuda as fc
from dss_tpu_torch.ops import fused_filter as ff
from dss_tpu_torch.ops.fastpath import _bitpack_weights

NB = 8  # blocks of every case's table
NW = 128  # windows of every case (a multiple of GROUP, <= 256)
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


# -- B2 / B3: the quantized compare over p3 -------------------------------


def _p3_case(kind: str, seed: int):
    """-> (p3 (NB, 5, 128) i32, six (NW,) i32 window arrays)."""
    rng = np.random.default_rng(seed)
    p3 = rng.integers(-3, 4, (NB, 5, 128)).astype(np.int32)
    p3[:, 0] = rng.integers(0, 4, (NB, 128))  # keys >= 0, as FastTable's
    blk = rng.integers(0, NB, NW).astype(np.int32)
    qk = rng.integers(-2, 4, NW).astype(np.int32)  # -2/-1: pad keys
    bounds = [rng.integers(-3, 4, NW).astype(np.int32) for _ in range(4)]
    if kind == "sentinels":
        # dead postings end at INT32_MIN; the last blocks are pad lanes
        # (INT32_MAX in all five rows); queries reach the i32 extremes
        p3[:, 4][rng.random((NB, 128)) < 0.2] = I32_MIN
        p3[NB - 2 :, :, 64:] = I32_MAX
        for b in bounds:
            pick = rng.random(NW)
            b[pick < 0.15] = I32_MIN
            b[pick > 0.85] = I32_MAX
    elif kind == "ties":
        # each window aims at one lane with every bound equal to that
        # lane's value, then moves one bound one step, or none
        lane = rng.integers(0, 128, NW)
        rows = p3[blk, :, lane]  # (NW, 5)
        qk = rows[:, 0].copy()
        bounds = [rows[:, 2].copy(), rows[:, 1].copy(),
                  rows[:, 4].copy(), rows[:, 3].copy()]
        which = rng.integers(0, 5, NW)
        step = rng.choice([-1, 1], NW).astype(np.int32)
        for i, b in enumerate(bounds):
            b[which == i] += step[which == i]
    qalo, qahi, qt0, qt1 = bounds
    return p3, (blk, qk, qalo, qahi, qt0, qt1)


def _unpack_words16(words: np.ndarray) -> np.ndarray:
    """(NW, 8) 16-bit words -> (NW, 128) int8 lane mask."""
    w = np.asarray(words).astype(np.int64)
    bits = (w[:, :, None] >> np.arange(16)[None, None, :]) & 1
    return bits.reshape(len(w), 128).astype(np.int8)


CASES = [("random", 1), ("random", 2), ("sentinels", 3), ("ties", 4),
         ("ties", 5)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_filter_windows_plain_matches_pallas_and_xla(kind, seed):
    p3, wins = _p3_case(kind, seed)
    got = fc.filter_windows_torch(
        torch.from_numpy(p3), *map(torch.from_numpy, wins)
    ).numpy()
    assert got.dtype == np.int8 and got.shape == (NW, 128)
    jwins = [jnp.asarray(a) for a in wins]
    want = np.asarray(
        filter_windows_pallas(jnp.asarray(p3), *jwins, interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    words = RefFastTable._filter_xla(
        jnp.asarray(p3), jnp.asarray(ref_bitpack_weights()), *jwins
    )
    np.testing.assert_array_equal(got, _unpack_words16(words))
    assert got.any() and not got.all()  # the case has hits and misses


@pytest.mark.parametrize("kind,seed", CASES)
def test_gridless_plain_matches_pallas(kind, seed):
    p3, wins = _p3_case(kind, seed)
    # B3 takes any NW up to 512, not only whole groups
    wins = tuple(a[: NW - 7] for a in wins)
    got = fc.filter_windows_gridless(
        torch.from_numpy(p3), *map(torch.from_numpy, wins)
    ).numpy()
    want = np.asarray(
        ref_gridless(jnp.asarray(p3), *map(jnp.asarray, wins), interpret=True)
    )
    np.testing.assert_array_equal(got, want)


def test_pad_and_negative_keys_never_match():
    p3, (blk, qk, *rest) = _p3_case("random", 6)
    for key in (-2, -1):
        mask = fc.filter_windows_torch(
            torch.from_numpy(p3), torch.from_numpy(blk),
            torch.full((NW,), key, dtype=torch.int32),
            *map(torch.from_numpy, rest),
        )
        assert not mask.any()


def test_bitpack_weights_match_reference():
    np.testing.assert_array_equal(_bitpack_weights(), ref_bitpack_weights())


# -- B4: the exact compare as a mask --------------------------------------

_T_EDGES = np.asarray(
    [k * 2**32 + d for k in (-3, -1, 0, 1, 2) for d in (-2, -1, 0, 1)]
    + [-(2**62), 2**62, -(2**63), 2**63 - 1], np.int64
)


def _exact_case(seed: int):
    """-> (four (NB, 128) block columns, six (NW,) window arrays): times
    near multiples of 2^32, negative times and the i64 extremes, f32
    altitudes with +-inf pads, all drawn from small pools so that ties
    are common."""
    rng = np.random.default_rng(seed)
    alts = np.asarray([-np.inf, -1.5, 0.0, 0.5, 2.0, np.inf], np.float32)
    b_alo = rng.choice(alts[:-1], (NB, 128))
    b_ahi = rng.choice(alts[1:], (NB, 128))
    b_t0 = rng.choice(_T_EDGES, (NB, 128))
    b_t1 = rng.choice(_T_EDGES, (NB, 128))
    blk = rng.integers(0, NB, NW).astype(np.int32)
    start = rng.integers(0, 129, NW)
    end = np.where(rng.random(NW) < 0.3, 128, rng.integers(0, 129, NW))
    qidx = rng.integers(0, 1 << 15, NW)  # ignored: B4 reads start|end
    meta = (start | (end << 8) | (qidx << 16)).astype(np.int32)
    return (
        (b_alo, b_ahi, b_t0, b_t1),
        (blk, meta, rng.choice(alts, NW), rng.choice(alts, NW),
         rng.choice(_T_EDGES, NW), rng.choice(_T_EDGES, NW)),
    )


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_exact_mask_plain_matches_split_plane_pallas(seed):
    cols, wins = _exact_case(seed)
    wins = tuple(a[: NW - 3] for a in wins)
    got = fc.fused_filter_gridless(
        *map(torch.from_numpy, cols), *map(torch.from_numpy, wins)
    ).numpy()
    want = np.asarray(
        ref_exact_gridless(*map(jnp.asarray, cols), *map(jnp.asarray, wins),
                           interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_exact_mask_equals_unpacked_fused_words():
    """B4's plain version is B1's plain filter without the pack: on the
    same windows (bounds gathered per window) the masks agree."""
    cols, (blk, meta, alo, ahi, t0, t1) = _exact_case(14)
    q = np.arange(NW, dtype=np.int32)  # one query per window
    meta = (meta & 0xFFFF) | (q << 16)
    t = torch.from_numpy
    mask = fc.fused_filter_mask_torch(
        *map(t, cols), t(blk), t(meta), t(alo), t(ahi), t(t0), t(t1)
    ).numpy()
    words = ff.filter_pack_torch(
        *map(t, cols), t(np.stack([blk, meta])), t(alo), t(ahi), t(t0), t(t1)
    ).numpy()
    bits = (words.view(np.uint32).astype(np.int64)[:, :, None]
            >> np.arange(32)[None, None, :]) & 1
    np.testing.assert_array_equal(mask, bits.reshape(NW, 128))


# -- the wrappers on CPU tensors --------------------------------------------


def test_wrappers_take_the_plain_versions_on_cpu():
    p3, wins = _p3_case("random", 7)
    tp3, twins = torch.from_numpy(p3), [torch.from_numpy(a) for a in wins]
    cols, ewins = _exact_case(15)
    tcols = [torch.from_numpy(c) for c in cols]
    tewins = [torch.from_numpy(a) for a in ewins]
    entries = (fc.filter_windows, fc.filter_windows_gridless,
               fc.fused_filter_gridless)
    before = [e.launches for e in entries]
    assert torch.equal(fc.filter_windows(tp3, *twins),
                       fc.filter_windows_torch(tp3, *twins))
    assert torch.equal(fc.filter_windows_gridless(tp3, *twins),
                       fc.filter_windows_torch(tp3, *twins))
    assert torch.equal(fc.fused_filter_gridless(*tcols, *tewins),
                       fc.fused_filter_mask_torch(*tcols, *tewins))
    assert [e.launches for e in entries] == before  # no kernel launch


def test_wrappers_refuse_what_the_reference_refuses():
    p3, wins = _p3_case("random", 8)
    tp3 = torch.from_numpy(p3)
    with pytest.raises(ValueError, match="multiple of 32"):
        fc.filter_windows(tp3, *(torch.from_numpy(a[:NW - 1]) for a in wins))
    big = [torch.from_numpy(np.resize(a, 513)) for a in wins]
    with pytest.raises(ValueError, match="at most 512"):
        fc.filter_windows_gridless(tp3, *big)
    cols, ewins = _exact_case(16)
    with pytest.raises(ValueError, match="at most 512"):
        fc.fused_filter_gridless(
            *map(torch.from_numpy, cols),
            *(torch.from_numpy(np.resize(a, 513)) for a in ewins),
        )

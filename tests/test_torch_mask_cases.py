"""chip_smoke.mask_cases(): the edge cases that hold B3 and B4 (the
mask kernels of csrc/window_mask.cu and csrc/fused_filter.cu)
against their plain versions on the card, checked here on the CPU.

Each case must reach the edge it is named after, and the expectation
the card compares with (chip_smoke.mask_plain: the plain version, with
a window whose block lies outside [0, NB) matching nothing) must keep
the kernels' contract: such rows are empty, B4 hits only lanes of
[start, end), the wrappers on CPU tensors give the same masks where
every block is in range, and B4's mask equals the unpacked words of
B1's plain filter over the same windows.  Where every block is in
range (the reference leaves any other index undefined), the same
numpy inputs go through the reference's filter_windows_gridless and
fused_filter_gridless (interpret mode) and give the same masks: the
tolerance is zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax.numpy as jnp
from dss_tpu.ops.fastpath_pallas import (
    filter_windows_gridless as ref_gridless,
    fused_filter_gridless as ref_exact_gridless,
)
from dss_tpu_torch.ops import fastpath_cuda as fc
from dss_tpu_torch.ops import fused_filter as ff

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cases():
    return dict(cs.mask_cases())


def test_mask_cases_reach_their_edges(cases):
    assert list(cases) == list(cs.MASK_CASE_NAMES)
    for k in (1, 31, 32, 33, 512):
        assert len(cases[f"nw_{k}"]["b3"][0]) == k
    assert set(cases["one_block"]["b3"][0]) == {5}
    assert len(cases["one_block"]["b3"][0]) == cs.GRIDLESS
    blk = cases["block_-1_and_nb"]["b4"][0]
    assert {-1, cs.MASK_NB} <= set(blk.tolist())
    assert (cases["key_-2"]["b3"][1] == -2).any()
    meta = {n: cases[n]["b4"][1] for n in (
        "start_eq_end", "start_0_end_128", "range_in_one_group")}
    start = {n: m & 0xFF for n, m in meta.items()}
    end = {n: (m >> 8) & 0xFF for n, m in meta.items()}
    assert (start["start_eq_end"] == end["start_eq_end"]).all()
    assert (start["start_0_end_128"] == 0).all()
    assert (end["start_0_end_128"] == 128).all()
    assert (start["range_in_one_group"] // 4
            == (end["range_in_one_group"] - 1) // 4).all()
    edges = cases["time_edges"]
    times = np.concatenate([edges["cols"][2].ravel(),
                            edges["b4"][4], edges["b4"][5]])
    assert {cs.I64.min, cs.I64.max} <= set(times.tolist())
    assert cs.I32.min in edges["b3"][2] and cs.I32.max in edges["b3"][5]


@pytest.mark.parametrize("name", cs.MASK_CASE_NAMES)
def test_plain_masks_keep_the_kernels_contract(cases, name):
    c = cases[name]
    a3, a4 = cs.mask_case_args(c, CPU)
    want3 = cs.mask_plain(fc.filter_windows_torch, 1, a3)
    want4 = cs.mask_plain(fc.fused_filter_mask_torch, 4, a4)
    nw = len(c["b3"][0])
    assert want3.shape == want4.shape == (nw, 128)
    blk = torch.from_numpy(c["b4"][0])
    bad = (blk < 0) | (blk >= cs.MASK_NB)
    assert not want3[bad].any() and not want4[bad].any()
    meta = torch.from_numpy(c["b4"][1])
    lanes = torch.arange(128)
    inside = ((lanes[None, :] >= (meta & 0xFF)[:, None])
              & (lanes[None, :] < ((meta >> 8) & 0xFF)[:, None]))
    assert not want4[~inside].any()
    if name == "start_eq_end":
        assert not want4.any()
    if name == "key_-2":
        assert not want3[torch.from_numpy(c["b3"][1]) == -2].any()
    if not bad.any():
        # the wrappers on CPU tensors run these plain versions
        assert torch.equal(fc.filter_windows_gridless(*a3), want3)
        assert torch.equal(fc.fused_filter_gridless(*a4), want4)
        # B4 is B1's exact compare: each window its own query
        wins = torch.stack([a4[4], a4[5] & 0xFFFF
                            | (torch.arange(nw, dtype=torch.int32) << 16)])
        words = ff.filter_pack_torch(*a4[:4], wins, *a4[6:])
        assert torch.equal(cs.unpacked_words(words), want4)
    if name.startswith("nw_") or name == "one_block":
        assert want3.any() and want4.any()


IN_RANGE = tuple(n for n in cs.MASK_CASE_NAMES if n != "block_-1_and_nb")


@pytest.mark.parametrize("name", IN_RANGE)
def test_plain_masks_match_the_reference_gridless_kernels(cases, name):
    c = cases[name]
    assert ((c["b3"][0] >= 0) & (c["b3"][0] < cs.MASK_NB)).all()
    a3, a4 = cs.mask_case_args(c, CPU)
    got3 = cs.mask_plain(fc.filter_windows_torch, 1, a3).numpy()
    got4 = cs.mask_plain(fc.fused_filter_mask_torch, 4, a4).numpy()
    want3 = ref_gridless(jnp.asarray(c["p3"]), *map(jnp.asarray, c["b3"]),
                         interpret=True)
    want4 = ref_exact_gridless(*map(jnp.asarray, c["cols"]),
                               *map(jnp.asarray, c["b4"]), interpret=True)
    np.testing.assert_array_equal(got3, np.asarray(want3))
    np.testing.assert_array_equal(got4, np.asarray(want4))

"""K1's choice of block width, `ops/mesh_cuda.spread_warps`, on the CPU.

K1 takes a warp an item, or, where a call has at most
SPREAD_ITEMS_PER_SM items an SM, a block of W warps an item.  W is a
pure function of the call's item count and the card's SM count: a power
of two from 1 to SPREAD_MAX_WARPS (the CUDA source's kSpreadMax), never
larger for more items, the largest at the benchmark cell's 64 searches
on an H100's 132 SMs and 1 at the mesh headline's 8,192 queries and the
2x4 headline's 4,096, whatever the environment holds.  The kernels
themselves are held to their plain versions on the card
(tests/test_torch_kernel_gpu.py).
"""

from __future__ import annotations

import os
import re

import pytest

from dss_tpu_torch.ops import cuda_build
from dss_tpu_torch.ops import mesh_cuda as mc

H100_SMS = 132
SMS = (1, 8, 78, 114, 132, 144)
# the item counts the port launches K1 with: the skew leg's one query,
# the cell's chunk, the server's and multihost's meshes, the 2x4 and 1x1
# headlines
ITEMS = (1, 8, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("sms", SMS)
def test_spread_warps_is_a_power_of_two_that_never_grows(sms):
    last = mc.SPREAD_MAX_WARPS
    for items in range(1, 20_000, 3):
        w = mc.spread_warps(items, sms)
        assert 1 <= w <= mc.SPREAD_MAX_WARPS
        assert w & (w - 1) == 0, (items, w)
        assert w <= last, (items, w, last)
        last = w
    assert mc.spread_warps(10**9, sms) == 1


@pytest.mark.parametrize("items", ITEMS)
def test_spread_warps_spreads_up_to_its_items_an_sm(items):
    """A block an item up to SPREAD_ITEMS_PER_SM items an SM of an H100,
    a warp an item past it."""
    w = mc.spread_warps(items, H100_SMS)
    assert (w > 1) == (items <= mc.SPREAD_ITEMS_PER_SM * H100_SMS)


def test_spread_warps_at_the_cell_and_the_headlines():
    assert mc.spread_warps(64, H100_SMS) == mc.SPREAD_MAX_WARPS
    assert mc.spread_warps(1, H100_SMS) == mc.SPREAD_MAX_WARPS
    assert mc.spread_warps(128, H100_SMS) == mc.SPREAD_MAX_WARPS
    assert mc.spread_warps(8192, H100_SMS) == 1
    assert mc.spread_warps(4096, H100_SMS) == 1


def test_spread_warps_reads_nothing_from_the_environment(monkeypatch):
    want = {(i, s): mc.spread_warps(i, s) for i in ITEMS for s in SMS}

    class Refuse(dict):
        def __getitem__(self, key):
            raise AssertionError(f"spread_warps read {key!r}")

        get = __contains__ = __getitem__

    for k in ("DSS_MESH_SPREAD", "DSS_CO_MAX_BATCH", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.setenv(k, "3")
    monkeypatch.setattr(os, "environ", Refuse())
    monkeypatch.setattr(os, "getenv", Refuse().get)
    assert {(i, s): mc.spread_warps(i, s) for i in ITEMS for s in SMS} == want


def test_spread_bounds_match_the_cuda_source():
    """SPREAD_MAX_WARPS is the source's kSpreadMax, and a launch bound
    of kSpreadMax warps is a whole block (at most 1,024 threads)."""
    text = (cuda_build.CSRC / "mesh_query.cu").read_text()
    found = re.search(r"constexpr int kSpreadMax = (\d+);", text)
    assert int(found.group(1)) == mc.SPREAD_MAX_WARPS
    assert 32 * mc.SPREAD_MAX_WARPS <= 1024


def test_launch_stats_export_the_spread_launches(monkeypatch):
    monkeypatch.setattr(mc.mesh_query, "spread_launches", 7)
    stats = mc.launch_stats()
    assert stats["dss_mesh_query_spread_launches"] == 7
    assert stats["dss_mesh_query_launches"] == mc.mesh_query.launches

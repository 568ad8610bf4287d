"""K1's entity rows (`ops/mesh_cuda.pack_entity_rows`) on the CPU.

Each row is 32 B: alt_lo and alt_hi (f32 bits), t_start and t_end (i64,
low word first), owner and active widened to a word.  Decoding the rows
must give the columns back bit for bit: +-inf altitudes, the NO_TIME_*
sentinels, the inactive sentinel row, owner -1, `active` as bool and as
uint8, and a table of no records.  A ShardedDar builds the rows once per
device beside its columns, and its `nbytes` (what crosses from the host)
stays the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.oracle import Record as RRecord
from dss_tpu.parallel import make_mesh as r_make_mesh
from dss_tpu.parallel import sharded as rs

from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.pack import pack_records
from dss_tpu_torch.ops import conflict as pc
from dss_tpu_torch.ops import mesh_cuda as mc
from dss_tpu_torch.parallel import make_mesh
from dss_tpu_torch.parallel import sharded as ps
from dss_tpu_torch.parallel.mesh import virtual_devices

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000


def _records(seed, n, record=Record):
    """n records over 300 cells: every 5th with open altitudes, every
    7th with open times, owners from -1 to 4."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = np.unique(rng.integers(0, 300, int(rng.integers(1, 6))))
        alo = float(np.float32(rng.uniform(-500, 3000)))
        ahi = float(np.float32(alo + rng.uniform(0, 900)))
        if i % 5 == 0:
            alo, ahi = -np.inf, np.inf
        t0 = NOW + int(rng.integers(-5, 5)) * HOUR
        t1 = t0 + int(rng.integers(0, 7)) * HOUR
        if i % 7 == 0:
            t0, t1 = int(pc.NO_TIME_LO), int(pc.NO_TIME_HI)
        out.append(record(f"r{i}", keys.astype(np.int32), alo, ahi, t0, t1,
                          int(rng.integers(-1, 5))))
    return out


def _decode(rows):
    """The columns back from rows [N+1, 8]: (alt_lo, alt_hi, t_start,
    t_end, owner, active word)."""
    assert rows.dtype == torch.int32 and rows.shape[1] == 8
    assert rows.is_contiguous()
    return (rows[:, 0].contiguous().view(torch.float32),
            rows[:, 1].contiguous().view(torch.float32),
            rows[:, 2:4].contiguous().view(torch.int64)[:, 0],
            rows[:, 4:6].contiguous().view(torch.int64)[:, 0],
            rows[:, 6], rows[:, 7])


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    width = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
    dt = width[a.element_size()]
    return torch.equal(a.contiguous().view(dt), b.contiguous().view(dt))


@pytest.mark.parametrize("n", [0, 1, 37, 400])
@pytest.mark.parametrize("active_dtype", [torch.bool, torch.uint8])
def test_rows_decode_to_the_columns_bit_for_bit(n, active_dtype):
    ents = pc.EntityTable(*ps.place(torch.device("cpu"), pc.entity_columns(
        pack_records(_records(n, n))), ps.Staging()))
    ents = ents._replace(active=ents.active.to(active_dtype))
    rows = mc.pack_entity_rows(ents)
    assert rows.shape == (ents.alt_lo.shape[0], 8)
    alo, ahi, t0, t1, owner, active = _decode(rows)
    for got, want in ((alo, ents.alt_lo), (ahi, ents.alt_hi),
                      (t0, ents.t_start), (t1, ents.t_end),
                      (owner, ents.owner)):
        assert _bits_equal(got, want)
    assert torch.equal(active.to(active_dtype), ents.active)
    assert set(active.tolist()) <= {0, 1}
    # the sentinel row: inactive, inverted altitudes and times, owner -1
    s = ents.alt_lo.shape[0] - 1
    assert (active[s], owner[s]) == (0, -1)
    assert (alo[s], ahi[s]) == (np.inf, -np.inf)
    assert (t0[s], t1[s]) == (int(pc.NO_TIME_HI), int(pc.NO_TIME_LO))
    if n:
        opened = ents.alt_lo == -np.inf
        assert opened.any() and torch.equal(ahi[opened],
                                            ents.alt_hi[opened])
        assert (t0 == int(pc.NO_TIME_LO)).any()
        assert (t1 == int(pc.NO_TIME_HI)).any()
        assert (owner == -1).any()


def test_rows_keep_uint8_values_and_extreme_bits():
    """Any uint8 `active` value survives, and the rows keep every bit of
    the times (both words, negatives) and of odd floats (-0.0, NaN)."""
    n1 = 6
    ents = pc.EntityTable(
        alt_lo=torch.tensor([-0.0, np.nan, -np.inf, 1e-45, 3e38, 0.5],
                            dtype=torch.float32),
        alt_hi=torch.tensor([0.0, np.inf, -1.0, 2.0, -3e38, 7.25],
                            dtype=torch.float32),
        t_start=torch.tensor([-(2**63), 2**63 - 1, -1, 0, 2**32, -(2**32)],
                             dtype=torch.int64),
        t_end=torch.tensor([2**62, -(2**62), 1, 2**31, -(2**31), 12345],
                           dtype=torch.int64),
        active=torch.tensor([0, 1, 2, 127, 128, 255], dtype=torch.uint8),
        owner=torch.tensor([-1, 0, 2**31 - 1, -(2**31), 7, -7],
                           dtype=torch.int32),
    )
    rows = mc.pack_entity_rows(ents)
    assert rows.shape == (n1, 8)
    alo, ahi, t0, t1, owner, active = _decode(rows)
    for got, want in ((alo, ents.alt_lo), (ahi, ents.alt_hi),
                      (t0, ents.t_start), (t1, ents.t_end),
                      (owner, ents.owner)):
        assert _bits_equal(got, want)
    assert torch.equal(active, ents.active.to(torch.int32))


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 4)])
def test_sharded_dar_builds_rows_and_keeps_nbytes(dp, sp):
    """ShardedDar holds one row table per distinct device, equal to the
    packed columns, and its nbytes equals the reference's (the rows are
    built on the device and never cross from the host)."""
    recs = _records(3, 300)
    rrecs = _records(3, 300, record=RRecord)
    mesh = make_mesh(dp * sp, dp=dp, sp=sp,
                     devices=virtual_devices("cpu", dp * sp))
    dar = ps.ShardedDar(recs, mesh)
    rdar = rs.ShardedDar(rrecs, r_make_mesh(dp * sp, dp=dp, sp=sp))
    assert dar.nbytes == rdar.nbytes
    assert list(dar.rows) == mesh.distinct_devices() == list(dar.ents)
    for dev, rows in dar.rows.items():
        assert torch.equal(rows, mc.pack_entity_rows(dar.ents[dev]))

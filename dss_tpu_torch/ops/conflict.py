"""Batched 4D-volume conflict/search queries over a packed DAR table.

The port of the reference's `dss_tpu/ops/conflict.py`: the DAR
sentinels every storage module shares, and the module's two XLA
functions, `conflict_query_batch` and `max_count_per_cell`.  Both run on
K1, the hand-written kernel of `ops/mesh_cuda.py`
(`csrc/mesh_query.cu`), which the mesh route (`parallel/sharded.py`)
runs per shard too: on CUDA tensors it launches the kernel, on CPU
tensors it runs its plain PyTorch version.  K1 reads the entity columns
as 32 B rows (`mesh_cuda.pack_entity_rows`), which these two functions
pack on every call: neither is on a serving path, and the mesh route
packs them once per snapshot.

Table layout (struct-of-arrays):

  EntityTable — one row per entity *slot*: alt_lo/alt_hi f32[N+1],
    t_start/t_end i64[N+1] (unix ns), active bool[N+1], owner i32[N+1].
    Row N is an inactive sentinel that all invalid gathers point to.

  Postings — post_key int32[P] sorted ascending (level-13 DAR keys,
    padding INT32_MAX) and post_ent int32[P] (slot per posting, padding
    points at the sentinel).  A leading shard axis ([S, P], each row
    sorted) runs S postings ranges in one pass.

Query algorithm (the reference's vmap as one kernel over the batch):
  1. each query cell's postings run, bounded by two binary searches,
  2. up to `cap` candidate slots per query cell,
  3. the altitude/time overlap + active + ends>=now test with the SQL's
     COALESCE semantics (missing bound = pass, encoded as +-inf
     altitudes and sentinel times),
  4. the unique hits, ascending, compacted to max_results with their
     exact count (or, for max_count_per_cell, the per-cell counts).

Every answer is bit-identical to the reference's (tests/
test_torch_sharded.py, tests/test_torch_mesh_kernels.py).  Each
function counts its calls on a CUDA device in `.launches` (the smoke
sets the counts to 0 before the mesh phase and reads them after); a
call on CPU tensors counts nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dss_tpu_torch.ops.mesh_cuda import (
    INT32_MAX,
    mesh_query,
    pack_entity_rows,
)

# Sentinel times for "no bound" (comfortably beyond any real timestamp).
NO_TIME_LO = np.int64(-(2**62))
NO_TIME_HI = np.int64(2**62)
NO_OWNER = np.int32(-1)


class EntityTable(NamedTuple):
    alt_lo: torch.Tensor  # f32[N+1], -inf when unbounded
    alt_hi: torch.Tensor  # f32[N+1], +inf when unbounded
    t_start: torch.Tensor  # i64[N+1]
    t_end: torch.Tensor  # i64[N+1]
    active: torch.Tensor  # bool[N+1]
    owner: torch.Tensor  # i32[N+1]


class Postings(NamedTuple):
    post_key: torch.Tensor  # int32[P] (or [S, P]), sorted, pad INT32_MAX
    post_ent: torch.Tensor  # int32[P] (or [S, P]), pad = sentinel slot


class QuerySpec(NamedTuple):
    """A batch of 4D queries: keys [Q, K] (pad -1), the rest [Q]."""

    keys: torch.Tensor  # int32[Q, K], pad -1
    alt_lo: torch.Tensor  # f32[Q], -inf if unbounded
    alt_hi: torch.Tensor  # f32[Q], +inf if unbounded
    t_start: torch.Tensor  # i64[Q], NO_TIME_LO if unbounded
    t_end: torch.Tensor  # i64[Q], NO_TIME_HI if unbounded


def entity_columns(packed) -> list:
    """The host columns of a `dar.pack.PackedRecords`, in EntityTable's
    order (`parallel/sharded.py` `place` puts them on a device)."""
    return [packed.alt_lo, packed.alt_hi, packed.t_start, packed.t_end,
            packed.active, packed.owner]


def query_spec(keys, alt_lo, alt_hi, t_start, t_end, device) -> QuerySpec:
    """Host arrays -> a QuerySpec of tensors on `device`."""
    return QuerySpec(
        keys=_tensor(keys, np.int32, device),
        alt_lo=_tensor(alt_lo, np.float32, device),
        alt_hi=_tensor(alt_hi, np.float32, device),
        t_start=_tensor(t_start, np.int64, device),
        t_end=_tensor(t_end, np.int64, device),
    )


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _u8(ents: EntityTable) -> EntityTable:
    """The columns as K1 takes them: `active` viewed as uint8."""
    if ents.active.dtype == torch.uint8:
        return ents
    return ents._replace(active=ents.active.view(torch.uint8))


def conflict_query_batch(
    base: Postings,
    delta: Postings,
    ents: EntityTable,
    q: QuerySpec,
    now,
    owner_filter=None,
    *,
    base_cap: int,
    delta_cap: int,
    max_results: int,
    with_owner: bool = False,
):
    """Batched query against base + delta postings: QuerySpec fields
    carry a leading batch axis Q; `now` is one visibility time for the
    batch; `owner_filter` [Q] applies when `with_owner`.  Returns
    (slots int32[Q, max_results] padded with INT32_MAX, overflowed
    bool[Q])."""
    nq = q.keys.shape[0]
    if q.keys.is_cuda:
        conflict_query_batch.launches += 1
    dev = q.keys.device
    row = [t.reshape(1, -1) for t in (*base, *delta)]
    slots, n_unique = mesh_query(
        *row, _u8(ents), q,
        torch.full((nq,), int(now), dtype=torch.int64, device=dev),
        torch.as_tensor(owner_filter, dtype=torch.int32, device=dev)
        if with_owner else None,
        rows=pack_entity_rows(ents),
        cap=base_cap, delta_cap=delta_cap, max_results=max_results)
    return slots[0], n_unique[0] > max_results


conflict_query_batch.launches = 0


def conflict_query(
    base: Postings,
    delta: Postings,
    ents: EntityTable,
    q: QuerySpec,
    now,
    *,
    base_cap: int,
    delta_cap: int,
    max_results: int,
    owner_filter=None,
):
    """One query (keys [K], scalar bounds) against base + delta
    postings; returns (slots int32[max_results] padded with INT32_MAX,
    overflowed bool)."""
    one = QuerySpec(q.keys.reshape(1, -1),
                    *(torch.as_tensor(f).reshape(1) for f in q[1:]))
    owner = (None if owner_filter is None
             else torch.as_tensor(owner_filter).reshape(1))
    slots, ovf = conflict_query_batch(
        base, delta, ents, one, now, owner,
        base_cap=base_cap, delta_cap=delta_cap, max_results=max_results,
        with_owner=owner_filter is not None,
    )
    return slots[0], ovf[0]


def max_count_per_cell(
    base: Postings,
    delta: Postings,
    ents: EntityTable,
    keys,
    now,
    owner_filter,
    *,
    base_cap: int,
    delta_cap: int,
) -> torch.Tensor:
    """Max, over the query cells `keys` [K], of the number of live
    entities owned by `owner_filter` in that cell (the DSS0030 quota
    metric; pkg/rid/cockroach/subscriptions.go:86-116, COUNT per cell
    GROUP BY cell, MAX over cells)."""
    dev = keys.device
    if keys.is_cuda:
        max_count_per_cell.launches += 1

    def one(value, dtype):
        return torch.full((1,), value, dtype=dtype, device=dev)

    q = QuerySpec(
        keys=keys.reshape(1, -1),
        alt_lo=one(-np.inf, torch.float32),
        alt_hi=one(np.inf, torch.float32),
        t_start=one(int(NO_TIME_LO), torch.int64),
        t_end=one(int(NO_TIME_HI), torch.int64),
    )
    row = [t.reshape(1, -1) for t in (*base, *delta)]
    counts = mesh_query(
        *row, _u8(ents), q, one(int(now), torch.int64),
        one(int(owner_filter), torch.int32), rows=pack_entity_rows(ents),
        cap=base_cap, delta_cap=delta_cap, max_results=0, count=True)
    return counts[0, 0]


max_count_per_cell.launches = 0

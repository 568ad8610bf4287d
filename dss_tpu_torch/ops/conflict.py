"""Batched 4D-volume conflict/search queries over a packed DAR table.

The port of the reference's `dss_tpu/ops/conflict.py`: the DAR
sentinels every storage module shares, and the three XLA functions of
that module written as torch ops (`conflict_query_batch`,
`max_count_per_cell`, and the candidate -> test -> compaction steps the
mesh route, `parallel/sharded.py`, runs per shard).  They are not
Pallas kernels in the reference, so they stay torch ops here; their
device time on the card is recorded by `chip_smoke.py`'s mesh phase.

Table layout (struct-of-arrays):

  EntityTable — one row per entity *slot*: alt_lo/alt_hi f32[N+1],
    t_start/t_end i64[N+1] (unix ns), active bool[N+1], owner i32[N+1].
    Row N is an inactive sentinel that all invalid gathers point to.

  Postings — post_key int32[P] sorted ascending (level-13 DAR keys,
    padding INT32_MAX) and post_ent int32[P] (slot per posting, padding
    points at the sentinel).  A leading shard axis ([S, P], each row
    sorted) runs S postings ranges in one pass.

Query algorithm (the reference's vmap written out as a batch axis):
  1. two torch.searchsorted over the [Q, K] query keys bound each query
     cell's postings run,
  2. a gather of up to `cap` candidate slots per query cell,
     [Q, K, cap],
  3. the altitude/time overlap + active + ends>=now test with the SQL's
     COALESCE semantics (missing bound = pass, encoded as +-inf
     altitudes and sentinel times),
  4. a sort along the last axis, `keep = vals != prev`, a cumsum, and a
     scatter into max_results + 1 columns whose last column is a sink.

Every answer is bit-identical to the reference's (tests/
test_torch_sharded.py).  Each function counts its calls on a CUDA
device in `.launches` (the smoke sets the counts to 0 before the mesh
phase and reads them after); a call on CPU tensors counts nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT32_MAX = np.int32(2**31 - 1)
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


def entity_table(packed, device) -> EntityTable:
    """The entity columns of a `dar.pack.PackedRecords` on `device`
    (pageable host copies: no pinned block of PyTorch's caching host
    allocator is involved)."""
    return EntityTable(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (packed.alt_lo, packed.alt_hi, packed.t_start,
                  packed.t_end, packed.active, packed.owner)
    ))


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


def _candidates(post: Postings, ents: EntityTable, keys, cap: int):
    """(ent, cand_valid) of shape [*S, Q, K, cap]: candidate slots per
    query cell (`S` is the postings' optional leading shard axis)."""
    n_sentinel = ents.alt_lo.shape[0] - 1
    pk, pe = post.post_key, post.post_ent
    p = pk.shape[-1]
    lead = tuple(pk.shape[:-1])
    shape = lead + tuple(keys.shape)
    flat = keys.reshape(-1)
    if lead:
        flat = flat.expand(*lead, flat.numel()).contiguous()
    valid_q = (keys >= 0).expand(shape)
    offs = torch.arange(cap, dtype=torch.int64, device=keys.device)
    if p == 0:
        cand_valid = torch.zeros(shape + (cap,), dtype=torch.bool,
                                 device=keys.device)
        ent = torch.full(shape + (cap,), n_sentinel, dtype=torch.int32,
                         device=keys.device)
        return ent, cand_valid
    lo = torch.searchsorted(pk, flat, side="left").reshape(shape)
    hi = torch.searchsorted(pk, flat, side="right").reshape(shape)
    cnt = hi - lo
    idx = (lo.unsqueeze(-1) + offs).clamp_(0, p - 1)
    cand_valid = (offs < cnt.unsqueeze(-1)) & valid_q.unsqueeze(-1)
    if lead:
        got = torch.gather(pe, -1, idx.reshape(*lead, -1)).reshape(idx.shape)
    else:
        got = pe[idx]
    ent = torch.where(cand_valid, got, torch.full_like(got, n_sentinel))
    return ent, cand_valid


def _col(col: torch.Tensor, ent: torch.Tensor) -> torch.Tensor:
    return torch.index_select(col, 0, ent.reshape(-1)).reshape(ent.shape)


def _attr_test(ents: EntityTable, ent, q, now, owner_filter):
    """The 4D test of the slots `ent`; `q`'s fields, `now` and
    `owner_filter` broadcast against `ent`."""
    t_end = _col(ents.t_end, ent)
    hit = (
        _col(ents.active, ent)
        & (_col(ents.alt_hi, ent) >= q.alt_lo)
        & (_col(ents.alt_lo, ent) <= q.alt_hi)
        & (t_end >= q.t_start)
        & (_col(ents.t_start, ent) <= q.t_end)
        & (t_end >= now)
    )
    if owner_filter is not None:
        hit &= _col(ents.owner, ent) == owner_filter
    return hit


def _compact_unique(ent, hit, max_results: int):
    """Sort candidate slots along the last axis, drop duplicates/misses,
    compact to int32[..., max_results] (pad INT32_MAX); also return the
    unique-hit count [...]."""
    big = torch.full_like(ent, int(INT32_MAX))
    vals = torch.sort(torch.where(hit, ent, big), dim=-1).values
    prev = torch.cat(
        [torch.full_like(vals[..., :1], -1), vals[..., :-1]], dim=-1
    )
    keep = (vals != prev) & (vals != int(INT32_MAX))
    pos = torch.cumsum(keep, dim=-1) - 1
    n_unique = keep.sum(dim=-1)
    scatter_pos = torch.where(
        keep & (pos < max_results), pos, torch.full_like(pos, max_results)
    )
    out = torch.zeros(
        vals.shape[:-1] + (max_results + 1,), dtype=torch.int32,
        device=vals.device,
    ).scatter_(-1, scatter_pos, vals)[..., :max_results]
    live = torch.arange(max_results, device=vals.device) < torch.clamp(
        n_unique, max=max_results
    ).unsqueeze(-1)
    out = torch.where(live, out, torch.full_like(out, int(INT32_MAX)))
    return out, n_unique


def _per_query(x):
    """A per-query [Q] field as [Q, 1], to broadcast over candidates."""
    return x.unsqueeze(-1) if x.dim() else x


def _bcast(q: QuerySpec) -> QuerySpec:
    return QuerySpec(q.keys, *(_per_query(f) for f in q[1:]))


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
    nq, k = q.keys.shape
    if q.keys.is_cuda:
        conflict_query_batch.launches += 1
    ent_b, val_b = _candidates(base, ents, q.keys, base_cap)
    ent_d, val_d = _candidates(delta, ents, q.keys, delta_cap)
    ent = torch.cat([ent_b.reshape(nq, -1), ent_d.reshape(nq, -1)], dim=1)
    valid = torch.cat(
        [val_b.reshape(nq, -1), val_d.reshape(nq, -1)], dim=1
    )
    now_t = torch.as_tensor(now, dtype=torch.int64, device=ent.device)
    owner = _per_query(owner_filter) if with_owner else None
    hit = valid & _attr_test(ents, ent, _bcast(q), now_t, owner)
    slots, n_unique = _compact_unique(ent, hit, max_results)
    return slots, n_unique > max_results


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
    q = QuerySpec(
        keys=keys,
        alt_lo=torch.tensor(-np.inf, dtype=torch.float32, device=dev),
        alt_hi=torch.tensor(np.inf, dtype=torch.float32, device=dev),
        t_start=torch.tensor(int(NO_TIME_LO), dtype=torch.int64, device=dev),
        t_end=torch.tensor(int(NO_TIME_HI), dtype=torch.int64, device=dev),
    )
    now_t = torch.as_tensor(now, dtype=torch.int64, device=dev)
    owner = torch.as_tensor(owner_filter, dtype=torch.int32, device=dev)
    ent_b, val_b = _candidates(base, ents, keys, base_cap)
    ent_d, val_d = _candidates(delta, ents, keys, delta_cap)
    hit_b = val_b & _attr_test(ents, ent_b, q, now_t, owner)
    hit_d = val_d & _attr_test(ents, ent_d, q, now_t, owner)
    per_cell = hit_b.sum(dim=1) + hit_d.sum(dim=1)
    return per_cell.max()


max_count_per_cell.launches = 0

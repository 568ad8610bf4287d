"""The mesh route's two kernels: K1 `mesh_query` and K2 `mesh_merge`.

The reference runs its conflict query as an XLA device program:
`dss_tpu/ops/conflict.py` `_candidates` -> `_attr_test` ->
`_compact_unique` (:78-131) under `conflict_query_batch` and
`max_count_per_cell`, and per shard under `shard_map` in
`dss_tpu/parallel/sharded.py` (`_local_query`, then the "sp" merge of
`step`).  The port runs the same work as two hand-written Hopper
kernels in `dss_tpu_torch/csrc/mesh_query.cu` (built by
`ops/cuda_build.py`, bound with ctypes):

  mesh_query  K1: for each (shard row, query) the candidate slots of
              every query cell (base postings, and a delta with its own
              cap), the 4D test, and the unique hits compacted to
              max_results with the exact unique count; or, with
              count=True, the max over the query's cells of the per-cell
              hit counts (max_count_per_cell)
  mesh_merge  K2: one dp row's shard lists merged, deduplicated and
              compacted to max_results, the overflow flags, the shard
              hits summed over the queries, each query's kept count and
              the batch's largest

On CUDA tensors each launches its kernel or raises; on CPU tensors it
runs the plain PyTorch version beside it (`mesh_query_torch`,
`mesh_merge_torch`: the torch ops the port ran before the kernels,
written after the reference's steps).  Each wrapper counts its kernel
launches in `.launches`.  K1 takes a warp an item, or, where a call has
at most SPREAD_ITEMS_PER_SM items an SM, a block of `spread_warps(items,
SMs)` warps an item; `mesh_query.spread_launches` counts those
launches.  K1 reads each entity as one 32 B row of `pack_entity_rows`,
which the caller builds and hands over as `rows=`
(`parallel/sharded.ShardedDar` builds them once per snapshot).  The
kernels' bound on the card and their design are in the CUDA source's
header.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from dss_tpu_torch.ops import cuda_build
from dss_tpu_torch.ops.fused_filter import _check

INT32_MAX = np.int32(2**31 - 1)
# bytes of global hit buffers one K1 launch may take; a batch whose
# buffers need more runs as several launches over its items
SCRATCH_LIMIT = 1 << 28
# K1 takes a block of SPREAD_MAX_WARPS warps an item (csrc/mesh_query.cu
# kSpreadMax) while a call has at most this many items an SM, a warp an
# item past it (measured on an H100 by mesh_device_time.py --shape
# search64; the CUDA source's header)
SPREAD_ITEMS_PER_SM = 8
SPREAD_MAX_WARPS = 16

_QUERY_ARGTYPES = (
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
)
_MERGE_ARGTYPES = (
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
)
# whether a launch's buffers fit in a block's shared memory: the layout
# is the CUDA source's alone
_FITS_ARGTYPES = [ctypes.c_longlong] * 2
_QUERY_FITS_ARGTYPES = [ctypes.c_longlong] * 3
# replica readers query from several threads: the counts are bumped
# under this lock, so no increment is lost
_COUNT_LOCK = threading.Lock()


def pack_entity_rows(ents) -> torch.Tensor:
    """The entity columns (alt_lo/alt_hi f32, t_start/t_end i64, active
    bool or uint8, owner i32, each [N+1]) as K1 reads them: int32 [N+1,
    8], one 32 B row a slot on the columns' device, holding the bits of
    alt_lo, alt_hi, t_start (low word first), t_end, owner, and active
    (0 or 1, or the uint8 value) widened to a word."""
    i32 = torch.int32
    return torch.cat([
        ents.alt_lo.contiguous().view(i32)[:, None],
        ents.alt_hi.contiguous().view(i32)[:, None],
        ents.t_start.contiguous().view(i32).view(-1, 2),
        ents.t_end.contiguous().view(i32).view(-1, 2),
        ents.owner.to(i32)[:, None],
        ents.active.to(i32)[:, None],
    ], dim=1)


# -- the plain versions -------------------------------------------------------


def _candidates(pk, pe, n_sentinel: int, keys, cap: int):
    """(ent, cand_valid) of shape [*S, Q, K, cap]: candidate slots per
    query cell of the sorted postings pk/pe [*S, P] (`S` an optional
    leading shard axis)."""
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


def _attr_test(ents, ent, q, now, owner_filter):
    """The 4D test of the slots `ent`; `q`'s fields, `now` and
    `owner_filter` broadcast against `ent`.  `ents.active` may be bool
    or uint8."""
    t_end = _col(ents.t_end, ent)
    hit = (
        (_col(ents.active, ent) != 0)
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
    unique-hit count [...] (int64)."""
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


class _Fields:
    """The per-query fields of a query spec, reshaped to broadcast."""

    def __init__(self, q, shape):
        self.alt_lo, self.alt_hi, self.t_start, self.t_end = (
            f.reshape(shape) for f in q[1:5])


def mesh_query_torch(post_key, post_ent, delta_key, delta_ent, ents, q, now,
                     owner=None, *, cap, delta_cap, max_results,
                     count=False, rows=None):
    """K1's plain version; the arguments and results of `mesh_query`
    (it reads the columns, not `rows`)."""
    n_sentinel = ents.alt_lo.shape[0] - 1
    keys = q.keys
    s, (nq, k) = post_key.shape[0], keys.shape
    if delta_key is None:
        delta_key = post_key[:, :0]
        delta_ent = post_ent[:, :0]
    ent_b, val_b = _candidates(post_key, post_ent, n_sentinel, keys, cap)
    ent_d, val_d = _candidates(delta_key, delta_ent, n_sentinel, keys,
                               delta_cap)
    if count:
        shape = (nq, 1, 1)
        args = (_Fields(q, shape), now.reshape(shape),
                None if owner is None else owner.reshape(shape))
        per_cell = ((val_b & _attr_test(ents, ent_b, *args)).sum(dim=-1)
                    + (val_d & _attr_test(ents, ent_d, *args)).sum(dim=-1))
        if k == 0:
            return torch.zeros((s, nq), dtype=torch.int32, device=keys.device)
        return per_cell.amax(dim=-1).to(torch.int32)
    ent = torch.cat([ent_b.reshape(s, nq, -1), ent_d.reshape(s, nq, -1)],
                    dim=-1)
    valid = torch.cat([val_b.reshape(s, nq, -1), val_d.reshape(s, nq, -1)],
                      dim=-1)
    shape = (nq, 1)
    hit = valid & _attr_test(
        ents, ent, _Fields(q, shape), now.reshape(shape),
        None if owner is None else owner.reshape(shape))
    slots, n_unique = _compact_unique(ent, hit, max_results)
    return slots, n_unique.to(torch.int32)


def mesh_merge_torch(slots, n_uni, *, shard_results, max_results):
    """K2's plain version (the reference's "sp" merge of one dp row);
    the arguments and results of `mesh_merge`."""
    n_sp, qloc = n_uni.shape
    merged = slots.permute(1, 0, 2).reshape(qloc, -1)
    out, n_unique = _compact_unique(
        merged, merged != int(INT32_MAX), max_results
    )
    ovf = (n_uni > shard_results).any(dim=0) | (n_unique > max_results)
    kept = torch.clamp(n_unique, max=max_results).to(torch.int32)
    acc = torch.zeros(n_sp + 1, dtype=torch.int32, device=slots.device)
    acc[:n_sp] = n_uni.sum(dim=1).to(torch.int32)
    if qloc:
        acc[n_sp] = kept.max()
    return out, ovf, kept, acc


# -- the wrappers -------------------------------------------------------------


def _launch(fn, name, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def spread_warps(items: int, sms: int) -> int:
    """The warps of K1's block for each of a call's `items` on a card of
    `sms` SMs: SPREAD_MAX_WARPS up to SPREAD_ITEMS_PER_SM items an SM,
    else 1 (a warp an item, four items a block)."""
    return SPREAD_MAX_WARPS if items <= SPREAD_ITEMS_PER_SM * sms else 1


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mesh_query(post_key, post_ent, delta_key, delta_ent, ents, q, now,
               owner=None, *, rows, cap, delta_cap, max_results,
               count=False):
    """K1.  `post_key`/`post_ent` int32 [S, P], each row sorted (pad
    INT32_MAX / the sentinel slot); `delta_key`/`delta_ent` int32 [S, Pd]
    or None; `ents` the entity columns (alt_lo/alt_hi f32, t_start/t_end
    i64, active uint8, owner i32, each [N+1], row N the inactive
    sentinel); `q` a QuerySpec (keys int32 [Q, K] padded with -1,
    alt_lo/alt_hi f32 [Q], t_start/t_end i64 [Q]); `now` i64 [Q];
    `owner` int32 [Q] filters by owner, None does not; `rows` the
    columns' `pack_entity_rows` on their device.  Each
    query cell contributes min(run, cap) base and min(run, delta_cap)
    delta candidates.  -> (slots int32 [S, Q, max_results] ascending,
    padded with INT32_MAX, n_unique int32 [S, Q]), or with count=True
    the max per-cell hit count int32 [S, Q] (base + delta, no dedup)."""
    keys = q.keys
    dev = keys.device
    if dev.type == "cpu":
        return mesh_query_torch(
            post_key, post_ent, delta_key, delta_ent, ents, q, now, owner,
            cap=cap, delta_cap=delta_cap, max_results=max_results,
            count=count)
    if dev.type != "cuda":
        raise ValueError(f"mesh_query: unsupported device {dev}")
    _check(keys, "keys", torch.int32, 2, dev)
    nq, k = keys.shape
    _check(post_key, "post_key", torch.int32, 2, dev)
    _check(post_ent, "post_ent", torch.int32, 2, dev)
    if post_ent.shape != post_key.shape:
        raise ValueError("post_ent must have post_key's shape")
    s, p = post_key.shape
    if delta_key is None:
        pd = 0
    else:
        _check(delta_key, "delta_key", torch.int32, 2, dev)
        _check(delta_ent, "delta_ent", torch.int32, 2, dev)
        if (delta_ent.shape != delta_key.shape
                or delta_key.shape[0] != s):
            raise ValueError("delta postings must be [S, Pd] like post_key")
        pd = delta_key.shape[1]
    cols = (("alt_lo", torch.float32), ("alt_hi", torch.float32),
            ("t_start", torch.int64), ("t_end", torch.int64),
            ("active", torch.uint8), ("owner", torch.int32))
    n1 = ents.alt_lo.shape[0]
    for (name, dtype), t in zip(cols, ents):
        _check(t, name, dtype, 1, dev)
        if t.shape[0] != n1:
            raise ValueError(f"{name} has {t.shape[0]} rows, want {n1}")
    fields = (("alt_lo", q.alt_lo, torch.float32),
              ("alt_hi", q.alt_hi, torch.float32),
              ("t_start", q.t_start, torch.int64),
              ("t_end", q.t_end, torch.int64), ("now", now, torch.int64))
    if owner is not None:
        fields += (("owner", owner, torch.int32),)
    for name, t, dtype in fields:
        _check(t, f"query {name}", dtype, 1, dev)
        if t.shape[0] != nq:
            raise ValueError(f"query {name} has {t.shape[0]} rows, want {nq}")
    _check(rows, "rows", torch.int32, 2, dev)
    if tuple(rows.shape) != (n1, 8) or rows.data_ptr() % 32:
        raise ValueError(f"rows must be 32 B aligned [{n1}, 8]")
    buf = 0 if count else k * (cap + (delta_cap if pd else 0))
    if (max(p, pd, n1, buf) >= 1 << 30
            or min(cap, delta_cap, max_results) < 0):
        raise ValueError("postings or caps out of the kernel's range")
    slots = None if count else torch.empty(
        (s, nq, max_results), dtype=torch.int32, device=dev)
    out = torch.empty((s, nq), dtype=torch.int32, device=dev)
    items = s * nq
    if items == 0:
        return out if count else (slots, out)
    fn = cuda_build.function("dss_mesh_query", _QUERY_ARGTYPES)
    warps = 1 if count else spread_warps(items, _sms(
        torch.cuda.current_device() if dev.index is None else dev.index))
    fits = cuda_build.function("dss_mesh_query_fits", _QUERY_FITS_ARGTYPES)
    in_smem = bool(fits(buf, int(count), warps))
    step = items if in_smem else max(1, SCRATCH_LIMIT // (4 * buf))
    scratch = None
    if not in_smem:
        scratch = torch.empty(min(step, items) * buf, dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for item0 in range(0, items, step):
            _launch(fn, "mesh_query",
                    post_key.data_ptr(), post_ent.data_ptr(), p, cap,
                    _ptr(delta_key), _ptr(delta_ent), pd, delta_cap,
                    rows.data_ptr(), keys.data_ptr(), k,
                    *(t.data_ptr() for t in q[1:5]), now.data_ptr(),
                    _ptr(owner), s, nq, max_results, int(count), buf,
                    _ptr(scratch), item0, min(step, items - item0), warps,
                    _ptr(slots), out.data_ptr(), stream)
            with _COUNT_LOCK:
                mesh_query.launches += 1
                mesh_query.spread_launches += warps > 1
    return out if count else (slots, out)


def mesh_merge(slots, n_uni, *, shard_results, max_results):
    """K2.  One dp row's gathered shards: `slots` int32 [n_sp, Q, sr]
    (each row's min(n_uni, sr) values first, ascending and unique, then
    INT32_MAX, as K1 writes them) and `n_uni` int32 [n_sp, Q] ->
    (slots int32 [Q, max_results] ascending, padded with INT32_MAX,
    overflowed bool [Q], kept int32 [Q] = min(n_unique, max_results),
    acc int32 [n_sp + 1]: each shard's n_uni summed over the queries,
    then the largest kept count)."""
    dev = slots.device
    if dev.type == "cpu":
        return mesh_merge_torch(slots, n_uni, shard_results=shard_results,
                                max_results=max_results)
    if dev.type != "cuda":
        raise ValueError(f"mesh_merge: unsupported device {dev}")
    _check(slots, "slots", torch.int32, 3, dev)
    _check(n_uni, "n_uni", torch.int32, 2, dev)
    n_sp, nq, sr = slots.shape
    if tuple(n_uni.shape) != (n_sp, nq) or sr != shard_results:
        raise ValueError(
            f"slots {tuple(slots.shape)} and n_uni {tuple(n_uni.shape)} "
            f"do not match n_sp, Q and shard_results={shard_results}")
    if max_results < 0 or n_sp * sr >= 1 << 30:
        raise ValueError("merge shapes out of the kernel's range")
    out = torch.empty((nq, max_results), dtype=torch.int32, device=dev)
    ovf = torch.empty(nq, dtype=torch.bool, device=dev)
    kept = torch.empty(nq, dtype=torch.int32, device=dev)
    acc = torch.zeros(n_sp + 1, dtype=torch.int32, device=dev)
    if nq == 0:
        return out, ovf, kept, acc
    scratch = None
    fits = cuda_build.function("dss_mesh_merge_fits", _FITS_ARGTYPES)
    if not fits(n_sp, sr):
        scratch = torch.empty(nq * 2 * n_sp * sr, dtype=torch.int32,
                              device=dev)
    fn = cuda_build.function("dss_mesh_merge", _MERGE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, "mesh_merge", slots.data_ptr(), n_uni.data_ptr(), n_sp,
                nq, sr, max_results, _ptr(scratch), out.data_ptr(),
                ovf.data_ptr(), kept.data_ptr(), acc.data_ptr(), stream)
    with _COUNT_LOCK:
        mesh_merge.launches += 1
    return out, ovf, kept, acc


def query_tile(warps: int = 1) -> int:
    """The int32 hits K1 holds in shared memory at `warps` warps an
    item (a warp's tile, or a spread block's), as the built kernel has
    it: an item with more moves them to its slice of a global
    scratch."""
    return cuda_build.function("dss_mesh_query_tile",
                               [ctypes.c_int])(warps)


def occupancy() -> dict:
    """K1 on this card: the blocks of 128 threads an SM holds at once,
    the registers a thread and the local memory a thread (spills and
    stack) of the built kernel; under "spread" the same of the spread
    kernel at its largest block (`warps`)."""
    out = (ctypes.c_int * 7)()
    _launch(cuda_build.function("dss_mesh_query_occupancy",
                                [ctypes.c_void_p]),
            "mesh_query occupancy", ctypes.addressof(out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2],
            "spread": {"warps": out[6], "blocks_per_sm": out[3],
                       "registers": out[4], "local_bytes": out[5]}}


def launch_stats() -> dict:
    """The kernels' launch counts in this process, as gauges (the
    server's /metrics carries them beside a mesh replica's); K1's
    launches with a block an item are also counted apart."""
    return {"dss_mesh_query_launches": mesh_query.launches,
            "dss_mesh_query_spread_launches": mesh_query.spread_launches,
            "dss_mesh_merge_launches": mesh_merge.launches}


mesh_query.launches = 0
mesh_query.spread_launches = 0
mesh_merge.launches = 0

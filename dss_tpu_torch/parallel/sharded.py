"""Sharded DAR conflict queries over a ("dp", "sp") mesh.

The port of the reference's `dss_tpu/parallel/sharded.py`, which
replaces CRDB's range layer for the read path
(implementation_details.md:11-42 — ranges shard the cell keyspace, any
node proxies to the right range):

  - the globally-sorted postings array is split into `sp` contiguous
    cell-key ranges (equal postings counts, or a load-weighted
    boundary map);
  - each position runs the single-device candidate gather + 4D test
    against its range and compacts its hits to a fixed width (K1,
    `ops/mesh_cuda.mesh_query`);
  - per-shard results are merged — the SQL DISTINCT across ranges (K2,
    `ops/mesh_cuda.mesh_merge`);
  - the query batch itself is split over "dp".

The reference's `shard_map` is a loop over the mesh here: each dp row
runs its sp shards grouped by device (the shards of one device stacked
[n, Ps] and answered in one launch of K1), the reference's
`all_gather` over "sp" is a `torch.stack` on the row's first device
(none when one device holds the whole row), K2 merges the row there,
and the reference's `psum` over "dp" is a sum.
`ShardedDar.query_batch` downloads only the columns that some query of
the batch kept.  The EntityTable is replicated, one copy per distinct
device, and beside it the same columns as K1's 32 B entity rows
(`ops/mesh_cuda.pack_entity_rows`), built once per snapshot.  Outputs
are bit-identical to the reference's for every mesh shape and boundary
split (tests/test_torch_sharded.py, tests/test_torch_mesh_kernels.py).

On a mesh that spans processes (parallel/multihost.py) each process
holds and answers only its own shard columns, and the "sp" all_gather
crosses processes: the local shard results are staged to the host in
one copy and gathered over the mesh's torch.distributed group (gloo);
every process then merges the whole answer (tests/test_torch_multihost.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dss_tpu_torch.dar import oracle
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.pack import pack_records
from dss_tpu_torch.obs import trace as _trace
from dss_tpu_torch.ops.conflict import (
    INT32_MAX,
    NO_TIME_HI,
    NO_TIME_LO,
    EntityTable,
    Postings,
    QuerySpec,
    _u8,
    entity_columns,
    query_spec,
)
from dss_tpu_torch.ops.mesh_cuda import (
    mesh_merge,
    mesh_query,
    pack_entity_rows,
)
from dss_tpu_torch.ops.resident import locked_host
from dss_tpu_torch.parallel.mesh import Mesh, mesh_spans_processes


def shard_postings(
    post_key: np.ndarray,
    post_ent: np.ndarray,
    n_sp: int,
    sentinel_slot: int,
    boundaries: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split sorted postings into n_sp contiguous ranges.

    Returns ([n_sp, Ps] keys, [n_sp, Ps] slots), each row sorted, padded
    with INT32_MAX / sentinel.  Without `boundaries` the split is by
    equal postings *count* — balanced by storage, the cold-start
    fallback.  With `boundaries` (n_sp-1 sorted int32 DAR-key split
    points, usually from `weighted_boundaries`) shard i takes the key
    range [boundaries[i-1], boundaries[i]) — the load-weighted
    placement the rebalancer publishes, applicable to ANY postings
    array over the same key space (base and delta tiers share one
    boundary map).  Contiguity keeps each row sorted so per-shard
    searchsorted still works.
    """
    live = post_key != INT32_MAX
    pk = np.asarray(post_key)[live]
    pe = np.asarray(post_ent)[live]
    n = len(pk)
    if boundaries is None:
        ps = max((n + n_sp - 1) // n_sp, 8)
        lohi = [
            (i * ps, min((i + 1) * ps, n)) if i * ps < n else (n, n)
            for i in range(n_sp)
        ]
    else:
        b = np.asarray(boundaries, np.int32)
        if len(b) != n_sp - 1:
            raise ValueError(
                f"boundaries has {len(b)} split points for {n_sp} shards"
            )
        cuts = [0] + [int(c) for c in np.searchsorted(pk, b)] + [n]
        lohi = [(cuts[i], cuts[i + 1]) for i in range(n_sp)]
        ps = max(max((hi - lo) for lo, hi in lohi), 8)
    keys = np.full((n_sp, ps), INT32_MAX, np.int32)
    ents = np.full((n_sp, ps), sentinel_slot, np.int32)
    for i, (lo, hi) in enumerate(lohi):
        if hi > lo:
            keys[i, : hi - lo] = pk[lo:hi]
            ents[i, : hi - lo] = pe[lo:hi]
    return keys, ents


def weighted_boundaries(
    post_key: np.ndarray,
    weights: Optional[np.ndarray],
    n_sp: int,
    member_capacity: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Key-space split points equalizing predicted *query work* per
    shard (placement driven by measured cost, not storage count).

    `weights` is per-posting measured load (RangeLoad.weights_for);
    every posting additionally carries one unit of count baseline, so
    zero measured load (cold start) reproduces the equal-count split
    and cold ranges still spread by storage.  Returns n_sp-1 sorted
    int32 DAR keys, or None when there is nothing to split.  Split
    points snap to key values (a single key's postings never straddle
    shards), so a single cell hotter than a whole shard ends up alone
    in its shard.  Per-shard posting counts are capped at 4x the
    equal-count mean (the postings array is rectangular, padded to the
    LARGEST shard; indivisible single-key runs excepted).

    `member_capacity` (optional, length n_sp) weighs each shard's
    TARGET work by its host's serving capacity: a slow host gets a
    proportionally lighter key run.  None or a uniform vector
    reproduces the equal-target split bit-identically.
    """
    pk = np.asarray(post_key, np.int32).ravel()
    pk = pk[pk != INT32_MAX]
    n = len(pk)
    if n == 0 or n_sp <= 1:
        return None
    if member_capacity is None:
        cap = np.ones(n_sp, np.float64)
    else:
        cap = np.asarray(member_capacity, np.float64).ravel()
        if len(cap) != n_sp:
            raise ValueError(
                f"member_capacity has {len(cap)} entries for "
                f"{n_sp} shards"
            )
        if not np.all(cap > 0):
            raise ValueError("member_capacity entries must be > 0")
    w = np.ones(n, np.float64)
    if weights is not None:
        lw = np.asarray(weights, np.float64).ravel()
        tot = lw.sum()
        if tot > 0:
            # normalize measured load to the same mass as the count
            # baseline, then let it dominate: a shard's predicted work
            # is mostly its query load, tempered by storage so empty-
            # load ranges still split by count
            w += lw * (n / tot) * 8.0
    # greedy fill at KEY-RUN granularity (a key's postings never
    # straddle shards), re-targeting the remaining weight over the
    # remaining shards after each cut
    uk, starts = np.unique(pk, return_index=True)
    run_w = np.add.reduceat(w, starts)
    run_n = np.diff(np.append(starts, n))
    # cap any one shard's posting COUNT at 4x the mean (a single key
    # run larger than the cap is indivisible and allowed through)
    count_cap = max(4 * ((n + n_sp - 1) // n_sp), 8)
    bounds: list = []
    rem_w = float(run_w.sum())
    rem_sh = n_sp
    acc = 0.0
    acc_n = 0
    consumed = 0  # postings in already-closed shards

    def fits_after_cut(extra: int) -> bool:
        # a cut is only legal when the postings left over still fit in
        # the remaining shards under the cap
        return (n - (consumed + extra)) <= (rem_sh - 1) * count_cap

    def next_target() -> float:
        # the shard being filled is bounds-index len(bounds); its
        # target is its capacity's share of the remaining weight
        s = len(bounds)
        return rem_w * float(cap[s]) / float(cap[s:].sum())

    for i in range(len(uk)):
        if len(bounds) == n_sp - 1:
            break
        target = next_target()
        if (
            acc > 0
            and (
                (run_w[i] >= target and acc + run_w[i] > 1.5 * target)
                or acc_n + int(run_n[i]) > count_cap
            )
            and fits_after_cut(acc_n)
        ):
            # the next run would overfill the shard (by weight, or by
            # the count cap): cut BEFORE it so the accumulated cold
            # mass isn't welded to the hot run
            bounds.append(int(uk[i]))
            consumed += acc_n
            rem_w -= acc
            rem_sh -= 1
            acc = 0.0
            acc_n = 0
            if len(bounds) == n_sp - 1:
                break
            target = next_target()
        acc += float(run_w[i])
        acc_n += int(run_n[i])
        if acc >= target and i + 1 < len(uk) and fits_after_cut(acc_n):
            bounds.append(int(uk[i + 1]))
            consumed += acc_n
            rem_w -= acc
            rem_sh -= 1
            acc = 0.0
            acc_n = 0
    while len(bounds) < n_sp - 1:
        # out of keys: remaining shards are empty (legal — duplicate
        # boundaries yield zero-width ranges)
        bounds.append(bounds[-1] if bounds else int(uk[-1]))
    return np.asarray(bounds, np.int32)


def shard_of_keys(
    keys: np.ndarray, boundaries: Optional[np.ndarray], n_sp: int
) -> np.ndarray:
    """Shard index for each key under a boundary map (None = cannot be
    answered without the postings array; used for move accounting and
    predicted-load-per-shard summaries)."""
    k = np.asarray(keys, np.int32).ravel()
    if boundaries is None or not len(k):
        return np.zeros(len(k), np.int32)
    return np.searchsorted(
        np.asarray(boundaries, np.int32), k, side="right"
    ).astype(np.int32)


def imbalance_factor(loads) -> float:
    """max/mean over per-shard loads — 1.0 is perfectly balanced; the
    rebalance trigger compares this against DSS_SHARD_REBALANCE_RATIO."""
    arr = np.asarray(loads, np.float64).ravel()
    if not len(arr) or arr.sum() <= 0:
        return 1.0
    return float(arr.max() / arr.mean())


class Staging:
    """A page-locked host buffer that uploads go through (`place`),
    grown to the largest upload so far and registered once: registered
    host memory (`ops/resident.py` `locked_host`), outside PyTorch's
    caching host allocator.  It stays page-locked until the Staging is
    garbage.  One upload at a time (a replica builds its dars under its
    refresh lock)."""

    def __init__(self):
        self._host: Optional[torch.Tensor] = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self._host is None or self._host.numel() < nbytes:
            self._host = None  # unregistered once garbage
            self._host = locked_host(nbytes)
        return self._host[:nbytes]


def place(dev: torch.device, arrays: Sequence[np.ndarray],
          staging: Staging) -> list:
    """Host arrays -> tensors on `dev`.  On a card they cross in one
    copy, from `staging`'s page-locked buffer into one device buffer
    that each tensor views (16-byte aligned); the copy is complete when
    this returns."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if dev.type != "cuda":
        return [torch.from_numpy(a).to(dev) for a in arrays]
    offs, end = [], 0
    for a in arrays:
        end += -end % 16
        offs.append(end)
        end += a.nbytes
    end = max(end, 16)
    host = staging.take(end)
    staged = host.numpy()
    for a, o in zip(arrays, offs):
        staged[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = torch.empty(end, dtype=torch.uint8, device=dev)
    buf.copy_(host)
    return [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def held_shards(mesh: Mesh, dev: torch.device) -> List[int]:
    """The shards (sp columns) whose positions `dev` holds."""
    return sorted({
        s for (d, s), pd in np.ndenumerate(mesh.devices) if pd == dev
    })


class ShardRows:
    """A [n_sp, ...] host array placed on a mesh: each distinct device
    holds, stacked, the rows (shards) its positions need — the
    reference's P("sp", None) layout.  `parts`: {device: (its shards
    (`held_shards`), the [S, ...] tensor of their rows (`place`))}."""

    def __init__(
        self, parts: Dict[torch.device, Tuple[List[int], torch.Tensor]]
    ):
        self.parts = parts

    def rows(self, dev: torch.device, shards: Sequence[int]) -> torch.Tensor:
        held, t = self.parts[dev]
        if list(shards) == held:
            return t
        idx = torch.tensor([held.index(s) for s in shards], device=dev)
        return t.index_select(0, idx)


def sync_devices(mesh: Mesh) -> None:
    """Wait for this thread's queued work (the host->device copies of a
    build) on every card of the mesh, so that a snapshot published after
    it is complete for readers on any stream."""
    for dev in mesh.distinct_devices():
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _local_query(
    post: Postings,  # [S, Ps] rows of S shards
    ents: EntityTable,
    q: QuerySpec,
    now,  # [Q] int64 per-query visibility time
    owner,
    *,
    cap: int,
    shard_results: int,
    with_owner: bool,
    rows: torch.Tensor,  # ents' pack_entity_rows
):
    """One device's shards on K1: candidates from each local postings
    range, 4D test, compact to shard_results.  Returns (slots [S, Q,
    sr], n_unique [S, Q] int32)."""
    return mesh_query(
        post.post_key, post.post_ent, None, None, _u8(ents), q, now,
        owner if with_owner else None, rows=rows,
        cap=cap, delta_cap=0, max_results=shard_results,
    )


def _row_shards(post_key, post_ent, ents, q, now, owner, mesh, d, qloc,
                *, cap, shard_results, with_owner, rows):
    """dp row `d`'s sp columns on this process -> [(device, columns,
    slots [S, Qloc, sr], n_unique [S, Qloc])], one entry per device
    group of the row."""
    part = slice(d * qloc, (d + 1) * qloc)
    out = []
    for dev, shards in mesh.row_groups(d):
        qq = QuerySpec(*(f[part].to(dev) for f in q))
        slots_s, n_uni = _local_query(
            Postings(post_key.rows(dev, shards),
                     post_ent.rows(dev, shards)),
            ents[dev],
            qq,
            now[part].to(dev),
            owner[part].to(dev) if with_owner else None,
            cap=cap,
            shard_results=shard_results,
            with_owner=with_owner,
            rows=rows[dev],
        )
        out.append((dev, list(shards), slots_s, n_uni))
    return out


def _by_column(groups) -> dict:
    """{column: (slots [Qloc, sr], n_unique [Qloc])} of a row's groups."""
    return {s: (slots[j], n_uni[j]) for _, shards, slots, n_uni in groups
            for j, s in enumerate(shards)}


def _row_columns(groups, n_sp: int, dev):
    """The reference's all_gather over "sp": a row's shard results as
    ([n_sp, Qloc, sr], [n_sp, Qloc]) on `dev`.  One group that holds
    every column in order on `dev` is taken as it is, with no copy."""
    if len(groups) == 1:
        gdev, shards, slots, n_uni = groups[0]
        if gdev == dev and shards == list(range(n_sp)):
            return slots, n_uni
    cols = _by_column(groups)
    return (torch.stack([cols[s][0].to(dev) for s in range(n_sp)]),
            torch.stack([cols[s][1].to(dev) for s in range(n_sp)]))


def _merge_row(slots, n_uni, *, shard_results, max_results):
    """The merge of one dp row's gathered shards on K2 (slots [n_sp,
    Qloc, sr], n_unique [n_sp, Qloc]) -> (slots [Qloc, max_results],
    overflowed [Qloc], kept [Qloc], acc [n_sp + 1] int32: shard_hits,
    then the row's widest kept count): the SQL DISTINCT across ranges,
    in sp column order."""
    return mesh_merge(slots.contiguous(),
                      n_uni.to(torch.int32).contiguous(),
                      shard_results=shard_results, max_results=max_results)


def _gather_columns(mesh: Mesh, local, qloc: int, sr: int, t0: float):
    """The reference's "sp" all_gather across processes: this
    process's columns of every dp row, staged to the host in ONE
    explicit copy, gathered from every process of the mesh over its
    group (gloo), laid out in sp column order.  -> [dp, n_sp, Qloc,
    sr + 1] int32 on this process's first device: each shard's slots,
    its unique-hit count in the last lane.  A process owns whole
    columns (make_global_mesh's column-blocked layout), so the
    reference's "dp" psum of the hits is local to each process."""
    import torch.distributed as dist

    dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    procs = mesh.processes()
    cols = {p: [j for j in range(n_sp) if int(mesh.owner[0, j]) == p]
            for p in procs}
    width = max(len(c) for c in cols.values())
    dev0 = mesh.distinct_devices()[0]
    block = torch.full((dp, width, qloc, sr + 1), int(INT32_MAX),
                       dtype=torch.int32, device=dev0)
    for d in range(dp):
        row = _by_column(local[d])
        for k, s in enumerate(cols[mesh.process_index]):
            slots, n_uni = row[s]
            block[d, k, :, :sr] = slots.to(dev0)
            block[d, k, :, sr] = n_uni.to(dev0, torch.int32)
    host = block.cpu()  # the one device->host copy of this collective
    t1 = time.perf_counter()
    out = torch.empty((len(procs) * dp,) + tuple(host.shape[1:]),
                      dtype=torch.int32)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or (
        dist.all_gather_into_tensor)
    gather(out, host, group=mesh.group)
    t2 = time.perf_counter()
    out = out.reshape(len(procs), dp, width, qloc, sr + 1)
    full = torch.cat(
        [out[i, :, : len(cols[p])] for i, p in enumerate(procs)], dim=1
    )
    seam = mesh.seam
    seam.gathers += 1
    seam.sent_bytes += host.numel() * host.element_size()
    seam.received_bytes += out.numel() * out.element_size()
    seam.local_ms += (t1 - t0) * 1e3
    seam.gather_ms += (t2 - t1) * 1e3
    return full.to(dev0)


def sharded_conflict_query_batch(
    post_key: ShardRows,  # [n_sp, Ps] int32, rows sorted, pad INT32_MAX
    post_ent: ShardRows,  # [n_sp, Ps] int32
    ents: Dict[torch.device, EntityTable],  # replicated
    q: QuerySpec,  # leading batch axis Q, Q % dp == 0
    now,  # [Q] int64 per-query visibility time
    owner=None,  # [Q] int32 when with_owner
    *,
    mesh: Mesh,
    cap: int,
    shard_results: int,
    max_results: int,
    with_owner: bool = False,
    replicate_out: bool = False,
):
    """Batched sharded query.  Returns (slots [Q, max_results] padded
    with INT32_MAX, overflowed [Q] bool, shard_hits [n_sp] int32 —
    per-shard unique candidate hits summed over the batch, the
    measured per-shard work the skew-aware rebalancer consumes), whole,
    on this process's first device of the mesh.

    On a mesh that spans processes every process of it makes this call
    in lockstep with the same inputs; each answers its own shards, and
    the gathered shards are merged on every process, so each holds the
    whole answer (the reference's replicate_out=True, which such a
    mesh requires).  The merged values are bit-identical to the
    single-process path: the gather only changes where the shards were
    answered, never the merge.  K1's entity rows are packed from `ents`
    on every call (ShardedDar keeps them built)."""
    slots, ovf, acc = _sharded_query(
        post_key, post_ent, ents, q, now, owner, mesh=mesh, cap=cap,
        shard_results=shard_results, max_results=max_results,
        with_owner=with_owner, replicate_out=replicate_out,
        rows={dev: pack_entity_rows(e) for dev, e in ents.items()})
    return slots, ovf, acc[: mesh.shape["sp"]]


def _sharded_query(post_key, post_ent, ents, q, now, owner, *, mesh, cap,
                   shard_results, max_results, with_owner, replicate_out,
                   rows):
    """sharded_conflict_query_batch's body, with `rows` each device's
    `pack_entity_rows` of `ents` -> (slots, overflowed, acc int32
    [n_sp + 1]: shard_hits, then the widest kept row of the batch, so
    that a caller downloads only the used columns)."""
    dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    spans = mesh_spans_processes(mesh)
    if spans and not replicate_out:
        raise ValueError(
            "a mesh that spans processes answers with replicate_out=True"
        )
    nq = q.keys.shape[0]
    if nq % dp:
        raise ValueError(f"batch {nq} is not a multiple of dp={dp}")
    qloc = nq // dp
    if any(dev.type == "cuda" for dev in mesh.distinct_devices()):
        sharded_conflict_query_batch.launches += 1
    t0 = time.perf_counter()
    now = torch.as_tensor(now, dtype=torch.int64)
    if with_owner:
        owner = torch.as_tensor(owner, dtype=torch.int32)
    local = [
        _row_shards(post_key, post_ent, ents, q, now, owner, mesh, d, qloc,
                    cap=cap, shard_results=shard_results,
                    with_owner=with_owner, rows=rows)
        for d in range(dp)
    ]
    merge = {"shard_results": shard_results, "max_results": max_results}
    outs, ovfs, accs = [], [], []
    if spans:
        full = _gather_columns(mesh, local, qloc, shard_results, t0)
        for d in range(dp):
            out, ovf, _, acc = _merge_row(full[d, :, :, :shard_results],
                                          full[d, :, :, shard_results],
                                          **merge)
            outs.append(out)
            ovfs.append(ovf)
            accs.append(acc)
    else:
        out_dev = mesh.devices[0, 0]
        for d in range(dp):
            out, ovf, _, acc = _merge_row(
                *_row_columns(local[d], n_sp, mesh.devices[d, 0]), **merge)
            outs.append(out.to(out_dev))
            ovfs.append(ovf.to(out_dev))
            accs.append(acc.to(out_dev))
    if dp == 1:
        return outs[0], ovfs[0], accs[0]
    # the reference's psum over "dp"; the widest row of any dp row
    acc = torch.stack(accs)
    acc = torch.cat([acc[:, :n_sp].sum(dim=0, dtype=torch.int32),
                     acc[:, n_sp:].amax(dim=0)])
    return torch.cat(outs), torch.cat(ovfs), acc


sharded_conflict_query_batch.launches = 0  # calls on a card


def _phase(name: str, tier: Optional[str]):
    """One phase span of `ShardedDar.query_batch` (obs/trace.py; the
    shared no-op when tracing is off here), with the replica tier the
    dar serves as its attribute when one is named."""
    if tier is None:
        return _trace.span(name)
    return _trace.span(name, tier=tier)


class ShardedDar:
    """A read-only sharded snapshot of a DAR entity class.

    Built from host Records (e.g. a DarTable's authoritative state or a
    WAL replay); holds device tensors laid out for the mesh.  This is
    the multi-device read replica — writes go through the single-device
    DarTable / WAL and periodically refresh this snapshot, mirroring
    the reference's CRDB-as-source-of-truth split (SURVEY.md §7).
    """

    def __init__(
        self,
        records: List[Record],
        mesh: Mesh,
        *,
        max_results: int = 512,
        shard_results: Optional[int] = None,
        boundaries: Optional[np.ndarray] = None,
        staging: Optional[Staging] = None,
    ):
        """`staging`: the page-locked buffer the upload goes through
        (`place`; a replica passes one for all its folds), else one
        of this build's own."""
        self.mesh = mesh
        self.n_sp = mesh.shape["sp"]
        self.dp = mesh.shape["dp"]
        # process-spanning mesh: each process materializes only its
        # own shard rows, and query outputs replicate to every process
        self.multihost = mesh_spans_processes(mesh)
        self.max_results = max_results
        self.shard_results = shard_results or max_results
        self.records = {slot: r for slot, r in enumerate(records)}
        # host-scan fallbacks (observability), under _hits_mu
        self.overflow_fallbacks = 0
        # key-space split map this dar was built under (None = legacy
        # equal-count); kept for move accounting across rebuilds
        self.boundaries = (
            None if boundaries is None
            else np.asarray(boundaries, np.int32)
        )
        # measured per-shard unique-hit work, accumulated across
        # query batches (the rebalancer's measured-imbalance input);
        # locked, with overflow_fallbacks — concurrent snapshot readers
        # must not lose updates
        self.shard_hits = np.zeros(self.n_sp, np.int64)
        self._hits_mu = threading.Lock()

        # with tracing on, `dar.pack` covers the host's packing and
        # `dar.upload` the copies to the cards, until they are complete
        with _trace.span("dar.pack"):
            packed = pack_records(records, pad_postings=False)
            skey, sent = shard_postings(
                packed.post_key,
                packed.post_ent,
                self.n_sp,
                packed.capacity,
                boundaries=self.boundaries,
            )
        self.cap = packed.base_cap
        # host->device bytes this snapshot materializes (refresh
        # traffic accounting): this process's shard rows and the
        # replicated entity columns (per host on a process-spanning
        # mesh; the whole mesh's on one process, as in the reference)
        held = sorted({s for (_, s), dev in np.ndenumerate(mesh.devices)
                       if dev is not None})
        self.nbytes = int(
            skey[held].nbytes
            + sent[held].nbytes
            + sum(np.asarray(a).nbytes for a in entity_columns(packed))
        )
        with _trace.span("dar.upload"):
            # each device's shard rows of the postings and the entity
            # columns (the reference's P("sp", None) and P() layouts),
            # in one transfer a device
            staging = staging or Staging()
            keys, ents, self.ents = {}, {}, {}
            for dev in mesh.distinct_devices():
                rows = held_shards(mesh, dev)
                t = place(dev, [skey[rows], sent[rows],
                                *entity_columns(packed)], staging)
                keys[dev], ents[dev] = (rows, t[0]), (rows, t[1])
                self.ents[dev] = EntityTable(*t[2:])
            self.post_key = ShardRows(keys)
            self.post_ent = ShardRows(ents)
            # K1's entity rows beside the columns (not in nbytes, which
            # counts what crosses from the host)
            self.rows = {dev: pack_entity_rows(e)
                         for dev, e in self.ents.items()}
            # the copies are complete before anyone can see this dar
            sync_devices(mesh)

    def query_batch(
        self,
        keys_batch: np.ndarray,  # [Q, K] int32 DAR keys, pad -1
        alt_lo: np.ndarray,  # [Q] f32
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # [Q] i64
        t_end: np.ndarray,
        *,
        now,  # int scalar or [Q] i64 per-query visibility time
        tier: Optional[str] = None,
    ):
        """Run a batch of queries; returns list-of-lists of entity slots.

        With tracing on, four flat spans cover the call, in order:
        `mesh.pad` (the buckets and the query fields), `mesh.launch`
        (their host->device copies, K1 and K2 enqueued), `mesh.wait`
        (the host waits on the card, then the device->host copies) and
        `mesh.decode` (the slot lists; `queries`, `hits` and
        `overflow_fallbacks` as attributes).  `tier` tags each span
        with the replica tier this dar serves."""
        with _phase("mesh.pad", tier):
            qn = keys_batch.shape[0]
            now_arr = np.broadcast_to(
                np.asarray(now, np.int64), (qn,)
            ).copy()
            # the reference's key-width bucket (pow2 from 16) and batch
            # bucket (pow2 from 16, dp-aligned): equal shapes, equal pads
            kw = 16
            while kw < keys_batch.shape[1]:
                kw *= 2
            if kw != keys_batch.shape[1]:
                keys_batch = np.concatenate(
                    [
                        keys_batch,
                        np.full(
                            (qn, kw - keys_batch.shape[1]), -1, np.int32
                        ),
                    ],
                    axis=1,
                )
            bucket = 16
            while bucket < qn:
                bucket *= 2
            if bucket % self.dp:
                bucket = ((bucket + self.dp - 1) // self.dp) * self.dp
            pad = bucket - qn
            if pad:
                keys_batch = np.concatenate(
                    [keys_batch,
                     np.full((pad, keys_batch.shape[1]), -1, np.int32)]
                )
                alt_lo = np.concatenate(
                    [alt_lo, np.full(pad, -np.inf, np.float32)])
                alt_hi = np.concatenate(
                    [alt_hi, np.full(pad, np.inf, np.float32)])
                t_start = np.concatenate([t_start, np.full(pad, NO_TIME_LO)])
                t_end = np.concatenate([t_end, np.full(pad, NO_TIME_HI)])
                now_arr = np.concatenate(
                    [now_arr, np.zeros(pad, np.int64)]
                )
            # pageable host tensors; each dp row's slice goes to its
            # devices
            spec = query_spec(keys_batch, alt_lo, alt_hi, t_start, t_end,
                              "cpu")
        with _phase("mesh.launch", tier):
            slots, ovf, acc = _sharded_query(
                self.post_key,
                self.post_ent,
                self.ents,
                spec,
                torch.from_numpy(now_arr),
                None,
                mesh=self.mesh,
                cap=self.cap,
                shard_results=self.shard_results,
                max_results=self.max_results,
                with_owner=False,
                replicate_out=self.multihost,
                rows=self.rows,
            )
        with _phase("mesh.wait", tier):
            # one small copy (shard_hits, then the widest kept row),
            # then only the columns any query of the batch kept
            acc = acc.cpu().numpy()
            slots = slots[:qn, : int(acc[self.n_sp])].cpu().numpy()
            ovf = ovf[:qn].cpu().numpy()
        with _phase("mesh.decode", tier) as sp:
            out = []
            fallbacks = 0
            for i in range(qn):
                if ovf[i]:
                    # result wider than max_results: exact host fallback
                    # for this query (counted — a hot cell silently
                    # degrading to the slow path must be observable)
                    fallbacks += 1
                    out.append(
                        oracle.search(
                            self.records,
                            keys_batch[i][keys_batch[i] >= 0],
                            None
                            if alt_lo[i] == -np.inf
                            else float(alt_lo[i]),
                            None if alt_hi[i] == np.inf
                            else float(alt_hi[i]),
                            None if t_start[i] == NO_TIME_LO
                            else int(t_start[i]),
                            None if t_end[i] == NO_TIME_HI
                            else int(t_end[i]),
                            int(now_arr[i]),
                        )
                    )
                else:
                    row = slots[i]
                    out.append([int(s) for s in row[row != INT32_MAX]])
            with self._hits_mu:
                self.shard_hits += acc[: self.n_sp].astype(np.int64)
                self.overflow_fallbacks += fallbacks
            if sp.span_id is not None:
                sp.set(queries=qn, hits=sum(map(len, out)),
                       overflow_fallbacks=fallbacks)
        return out

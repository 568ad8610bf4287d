"""The mesh route's kernels, K1 `mesh_query` and K2 `mesh_merge`
(`ops/mesh_cuda.py`), on the CPU against the reference, with no
tolerance (a set query).

On CPU tensors each wrapper runs its plain version.  Every case of the
smoke's fixed list (`chip_smoke.mesh_cases()`: n_sp 1, 2 and 8, K 16 and
32, shard_results below max_results, P = 0 with all-pad keys and with a
delta, n_unique at R-1, R and R+1 for K1 and for K2, one slot in several
query cells and in both base and delta, the owner filter on and off,
`now` past t_end, the count mode, K*cap and n_sp*sr past one block's
shared memory) is held against the reference's own steps
(`dss_tpu.ops.conflict` `_candidates` -> `_attr_test` ->
`_compact_unique`, and the "sp" merge of `sharded_conflict_query_batch`),
and through the three routed functions against
`dss_tpu.ops.conflict.conflict_query_batch`, `max_count_per_cell` and
`dss_tpu.parallel.sharded_conflict_query_batch` on the conftest's
virtual CPU devices (no Pallas is involved).  The card-only parts of the
list, outputs handed back dirty and 40 launches back to back, are
tests/test_torch_kernel_gpu.py's.  Inputs come from numpy with fixed
seeds.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax
import jax.numpy as jnp
from dss_tpu.ops import conflict as rc
from dss_tpu.parallel import make_mesh as r_make_mesh
from dss_tpu.parallel import sharded as rs

import chip_smoke as cs
from dss_tpu_torch.ops import conflict as pc
from dss_tpu_torch.ops import cuda_build
from dss_tpu_torch.ops import mesh_cuda as mc
from dss_tpu_torch.parallel import make_mesh as p_make_mesh
from dss_tpu_torch.parallel import mesh as pmesh
from dss_tpu_torch.parallel import sharded as ps

INT32_MAX = int(rc.INT32_MAX)


def _kernel_tile():
    """K1's shared tile as csrc/mesh_query.cu defines it (on the card
    the smoke and the card tests ask the built kernel)."""
    text = (cuda_build.CSRC / "mesh_query.cu").read_text()
    return int(re.search(r"constexpr int kTile = (\d+);", text).group(1))


@pytest.fixture(scope="module")
def cases():
    built = cs.mesh_cases(_kernel_tile())
    assert [n for n, _ in built] == list(cs.MESH_CASE_NAMES)
    return dict(built)


def _rows_or_pad(k, e, s, sentinel):
    """[S, P] postings for the reference, P >= 1: an empty source is one
    INT32_MAX pad a row, which no query key reaches."""
    if k is None or k.shape[1] == 0:
        return (np.full((s, 1), INT32_MAX, np.int32),
                np.full((s, 1), sentinel, np.int32))
    return k, e


def _ref_ents(c):
    alo, ahi, t0, t1, active, owner = c["ents"]
    return rc.EntityTable(alt_lo=jnp.asarray(alo), alt_hi=jnp.asarray(ahi),
                          t_start=jnp.asarray(t0), t_end=jnp.asarray(t1),
                          active=jnp.asarray(active.astype(bool)),
                          owner=jnp.asarray(owner))


def _ref_k1(c):
    """The reference's steps per (shard row, query): (slots [S, Q, r],
    n_unique [S, Q]), or the max per-cell count [S, Q] in count mode."""
    ents = _ref_ents(c)
    sent = len(c["ents"][0]) - 1
    s = c["pk"].shape[0]
    pk, pe = _rows_or_pad(c["pk"], c["pe"], s, sent)
    dk, de = _rows_or_pad(c["dk"], c["de"], s, sent)
    cap, dcap, r, count = c["cap"], c["delta_cap"], c["r"], c["count"]
    with_owner = c["owner"] is not None

    def one(pk, pe, dk, de, keys, alo, ahi, ts, te, nw, ow):
        q = rc.QuerySpec(keys, alo, ahi, ts, te)
        ow = ow if with_owner else None
        eb, vb = rc._candidates(rc.Postings(pk, pe), ents, keys, cap)
        ed, vd = rc._candidates(rc.Postings(dk, de), ents, keys, dcap)
        if count:
            hb = vb & rc._attr_test(ents, eb, q, nw, ow)
            hd = vd & rc._attr_test(ents, ed, q, nw, ow)
            return jnp.max(jnp.sum(hb, axis=1) + jnp.sum(hd, axis=1))
        ent = jnp.concatenate([eb.ravel(), ed.ravel()])
        valid = jnp.concatenate([vb.ravel(), vd.ravel()])
        hit = valid & rc._attr_test(ents, ent, q, nw, ow)
        return rc._compact_unique(ent, hit, r)

    per_q = jax.vmap(one, in_axes=(None,) * 4 + (0,) * 7)
    per_s = jax.vmap(per_q, in_axes=(0,) * 4 + (None,) * 7)
    nq = len(c["keys"])
    owner = c["owner"] if with_owner else np.zeros(nq, np.int32)
    return jax.jit(per_s)(
        *(jnp.asarray(a) for a in (pk, pe, dk, de, c["keys"], c["qalo"],
                                   c["qahi"], c["qt0"], c["qt1"], c["now"],
                                   owner)))


def _ref_k2(slots, n_uni, sr, r):
    """The reference's "sp" merge of one dp row -> (slots [Q, r],
    overflowed [Q], kept [Q], shard hits [n_sp], the widest kept)."""
    merged = jnp.moveaxis(slots, 0, 1).reshape(slots.shape[1], -1)
    out, n_unique = jax.vmap(
        lambda m: rc._compact_unique(m, m != INT32_MAX, r))(merged)
    ovf = jnp.any(n_uni > sr, axis=0) | (n_unique > r)
    kept = jnp.minimum(n_unique, r)
    return (out, ovf, kept, jnp.sum(n_uni, axis=1).astype(jnp.int32),
            jnp.max(kept) if kept.size else 0)


def _shard_rows(mesh, arr):
    """`arr` [n_sp, ...] on `mesh` as ShardedDar places its postings."""
    staging = ps.Staging()
    return ps.ShardRows({
        dev: (ps.held_shards(mesh, dev),
              ps.place(dev, [arr[ps.held_shards(mesh, dev)]], staging)[0])
        for dev in mesh.distinct_devices()
    })


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", cs.MESH_CASE_NAMES)
def test_mesh_kernels_and_routes_equal_reference(cases, name):
    c = cases[name]
    args, kw, mkw = cs.mesh_case_args(c, torch.device("cpu"))
    before = (mc.mesh_query.launches, mc.mesh_merge.launches)
    want = _ref_k1(c)
    got = mc.mesh_query(*args, **kw)
    if c["count"]:
        _same(got.numpy(), want, "K1 count mode")
        assert got.dtype == torch.int32
    else:
        slots, n_uni = got
        assert slots.dtype == n_uni.dtype == torch.int32
        _same(slots.numpy(), want[0], "K1 slots")
        _same(n_uni.numpy(), want[1], "K1 n_unique")
        out, ovf, kept, acc = mc.mesh_merge(slots, n_uni, **mkw)
        r_out, r_ovf, r_kept, r_hits, r_width = _ref_k2(
            want[0], want[1], c["r"], c["merge_r"])
        assert out.dtype == kept.dtype == acc.dtype == torch.int32
        assert ovf.dtype == torch.bool
        _same(out.numpy(), r_out, "K2 slots")
        _same(ovf.numpy(), r_ovf, "K2 overflow")
        _same(kept.numpy(), r_kept, "K2 kept")
        _same(acc.numpy(), np.append(np.asarray(r_hits), r_width), "K2 acc")
    assert (mc.mesh_query.launches, mc.mesh_merge.launches) == before
    _routes_equal_reference(c)


def _routes_equal_reference(c):
    """The routed functions on the case: conflict_query_batch (or, in
    count mode, max_count_per_cell per query) on one shard row with the
    delta, and, without a delta, sharded_conflict_query_batch over the
    case's n_sp shards (dp 2 where the batch and the 8 devices allow)."""
    s = c["pk"].shape[0]
    sent = len(c["ents"][0]) - 1
    ents_p = pc.EntityTable(*(torch.from_numpy(
        a.astype(bool) if i == 4 else a) for i, a in enumerate(c["ents"])))
    ents_r = _ref_ents(c)
    owner = c["owner"]
    if s == 1:
        pk, pe = _rows_or_pad(c["pk"], c["pe"], 1, sent)
        dk, de = _rows_or_pad(c["dk"], c["de"], 1, sent)
        rb, rd = rc.Postings(jnp.asarray(pk[0]), jnp.asarray(pe[0])), \
            rc.Postings(jnp.asarray(dk[0]), jnp.asarray(de[0]))
        pb = pc.Postings(torch.from_numpy(c["pk"][0]),
                         torch.from_numpy(c["pe"][0]))
        pd = (pc.Postings(torch.from_numpy(c["dk"][0]),
                          torch.from_numpy(c["de"][0]))
              if c["dk"] is not None else pc.Postings(pb[0][:0], pb[1][:0]))
        caps = dict(base_cap=c["cap"], delta_cap=c["delta_cap"])
        now = int(c["now"][0])
        if c["count"]:
            for i in range(len(c["keys"])):
                want = rc.max_count_per_cell(
                    rb, rd, ents_r, jnp.asarray(c["keys"][i]),
                    jnp.int64(now), jnp.int32(owner[i]), **caps)
                got = pc.max_count_per_cell(
                    pb, pd, ents_p, torch.from_numpy(c["keys"][i]), now,
                    int(owner[i]), **caps)
                assert int(got) == int(want), i
            return
        fields = ("keys", "qalo", "qahi", "qt0", "qt1")
        want = rc.conflict_query_batch(
            rb, rd, ents_r, rc.QuerySpec(*(jnp.asarray(c[f])
                                           for f in fields)),
            jnp.int64(now), None if owner is None else jnp.asarray(owner),
            with_owner=owner is not None, max_results=c["r"], **caps)
        got = pc.conflict_query_batch(
            pb, pd, ents_p, pc.query_spec(*(c[f] for f in fields), "cpu"),
            now, None if owner is None else torch.from_numpy(owner),
            with_owner=owner is not None, max_results=c["r"], **caps)
        for g, w in zip(got, want):
            _same(g.numpy(), w, "conflict_query_batch")
    if c["dk"] is not None or c["count"]:
        return
    nq = len(c["keys"])
    dp = 2 if nq % 2 == 0 and 2 * s <= 8 else 1
    rmesh = r_make_mesh(dp * s, dp=dp, sp=s)
    pmesh_ = p_make_mesh(dp * s, dp=dp, sp=s,
                         devices=pmesh.virtual_devices("cpu", dp * s))
    pk, pe = _rows_or_pad(c["pk"], c["pe"], s, sent)
    fields = ("keys", "qalo", "qahi", "qt0", "qt1")
    kw = dict(cap=c["cap"], shard_results=c["r"], max_results=c["merge_r"],
              with_owner=owner is not None)
    want = rs.sharded_conflict_query_batch(
        jnp.asarray(pk), jnp.asarray(pe), ents_r,
        rc.QuerySpec(*(jnp.asarray(c[f]) for f in fields)),
        jnp.asarray(c["now"]), None if owner is None else jnp.asarray(owner),
        mesh=rmesh, **kw)
    got = ps.sharded_conflict_query_batch(
        _shard_rows(pmesh_, c["pk"]), _shard_rows(pmesh_, c["pe"]),
        {d: ents_p for d in pmesh_.distinct_devices()},
        pc.query_spec(*(c[f] for f in fields), "cpu"),
        torch.from_numpy(c["now"]),
        None if owner is None else torch.from_numpy(owner),
        mesh=pmesh_, **kw)
    for g, w, dt in zip(got, want, (torch.int32, torch.bool, torch.int32)):
        assert g.dtype == dt
        _same(g.numpy(), w, "sharded_conflict_query_batch")


def test_cpu_tensors_count_no_launch_and_never_build(cases, monkeypatch):
    """On CPU tensors the wrappers and the routed functions run the
    plain versions: no launch is counted and the kernel library is
    never built or bound."""

    def refuse(*a, **k):
        raise AssertionError("a CPU call reached cuda_build")

    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "function", refuse)
    counts = (mc.mesh_query.launches, mc.mesh_merge.launches,
              pc.conflict_query_batch.launches,
              pc.max_count_per_cell.launches,
              ps.sharded_conflict_query_batch.launches)
    for name in ("random_k16_sp8", "count_mode", "slot_in_cells_and_delta"):
        c = cases[name]
        args, kw, mkw = cs.mesh_case_args(c, torch.device("cpu"))
        got = mc.mesh_query(*args, **kw)
        if not kw["count"]:
            mc.mesh_merge(*got, **mkw)
        _routes_equal_reference(c)
    assert (mc.mesh_query.launches, mc.mesh_merge.launches,
            pc.conflict_query_batch.launches,
            pc.max_count_per_cell.launches,
            ps.sharded_conflict_query_batch.launches) == counts


def test_wrappers_refuse_a_device_other_than_the_cpu_or_a_card(cases):
    """The plain versions serve CPU tensors only: any other device that
    is not a card is refused, not run."""
    c = cases["random_k16_sp8"]
    args, kw, mkw = cs.mesh_case_args(c, torch.device("cpu"))
    slots, n_uni = mc.mesh_query(*args, **kw)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mc.mesh_query(*args[:5], args[5]._replace(
            keys=args[5].keys.to(meta)), *args[6:], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        mc.mesh_merge(slots.to(meta), n_uni.to(meta), **mkw)

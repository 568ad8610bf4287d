"""The port's multi-host mesh (parallel/multihost.py, cmds/multihost_dryrun)
against the reference, with no tolerance.

- Copies of the reference's in-process cases (tests/test_multihost.py:
  placement accounting, the config's flag/env fallbacks, the command
  codec, the replicated-output query path, the replica's query
  refactor, the gauge names), each on the port; the placement over
  virtual CPU positions and over a made-up three-process position list
  (the column-blocked layout, the loud ValueError).
- The command codec across the packages: byte-identical encodings, and
  each package decodes the other's.
- Two processes over gloo: a global 2x4 mesh (4 CPU positions each)
  answers as a one-process 2x4 mesh does; and the port's whole dryrun
  on the CPU (`run_dryrun(device="cpu")`: the single-process leg, the
  two-process mesh, peer loss, elastic join/leave, capacity weights),
  whose two-process answers equal the reference's in-process
  single-process `ShardedReplica` at 1x4 (JAX on conftest.py's virtual
  CPU devices) on the same fixture WAL, keys and `now`.
- The default device (`cuda`) raises without a card, in `initialize`
  and in `run_dryrun`, before any process starts.

Every child process has its own deadline and is killed past it (90 s
a dryrun leg; the whole dryrun takes about 40 s here).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
import jax
from dss_tpu.parallel import multihost as rmh

from dss_tpu_torch.parallel import mesh as pmesh
from dss_tpu_torch.parallel import multihost as pmh
from dss_tpu_torch.parallel.mesh import (
    GlobalDevice,
    make_global_mesh,
    mesh_spans_processes,
)
from dss_tpu_torch.parallel.multihost import (
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    MULTIHOST_METRICS,
    MultihostConfig,
    _decode_cmd,
    _encode_cmd,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the reference's in-process cases, on the port ----------------------------------


def test_global_mesh_placement_accounting():
    devs = pmesh.virtual_devices("cpu", 8)
    pl = make_global_mesh(devices=devs)
    # single-process defaults to the classic factoring
    assert pl.dp * pl.sp == len(devs)
    assert pl.num_processes == 1
    assert pl.sp_by_process == {0: tuple(range(pl.sp))}
    assert pl.addressable_sp == tuple(range(pl.sp))
    assert pl.owner.shape == (pl.dp, pl.sp)
    assert (pl.owner == 0).all()
    assert not mesh_spans_processes(pl.mesh)

    pl2 = make_global_mesh(dp=2, sp=4, devices=devs)
    assert pl2.mesh.shape == {"dp": 2, "sp": 4}
    assert "p0:sp[0, 1, 2, 3]" in pl2.describe()


def test_global_mesh_spans_processes_column_blocked():
    """Three processes with two positions each, seen from process 0
    (no runtime joined: its devices given) and from process 1 (the
    joined runtime's list): whole contiguous column blocks in process
    order, a device only on the viewer's own positions; `processes=`
    restricts the mesh; a dp that does not divide a host's positions
    fails loudly."""
    cpu = torch.device("cpu")

    def world(me):
        return [GlobalDevice(p, i, cpu if p == me else None)
                for p in (2, 0, 1) for i in range(2)]

    pl = make_global_mesh(devices=world(0))  # dp=1 across hosts
    assert (pl.dp, pl.sp) == (1, 6)
    assert pl.sp_by_process == {0: (0, 1), 1: (2, 3), 2: (4, 5)}
    assert pl.describe() == "p0:sp[0, 1] p1:sp[2, 3] p2:sp[4, 5]"
    assert pl.process_index == 0 and pl.addressable_sp == (0, 1)
    assert mesh_spans_processes(pl.mesh)
    assert pl.mesh.row_groups(0) == [(cpu, [0, 1])]
    with pytest.raises(ValueError, match="a device where process 1"):
        # process 0's devices on a mesh that says it is process 1
        pmesh.Mesh(pl.mesh.devices, owner=pl.owner, process_index=1)
    pmesh.set_global_devices(1, world(1))
    try:
        pl = make_global_mesh(dp=2)
        assert pl.process_index == 1 and pl.addressable_sp == (1,)
        assert pl.owner.tolist() == [[0, 1, 2], [0, 1, 2]]
        assert pl.mesh.row_groups(1) == [(cpu, [1])]
        assert pl.mesh.distinct_devices() == [cpu]
        sub = make_global_mesh(processes=(0, 2))
        assert sub.sp_by_process == {0: (0, 1), 2: (2, 3)}
        assert sub.addressable_sp == () and sub.mesh.distinct_devices() == []
        with pytest.raises(ValueError, match="does not divide"):
            # one position on process 0, three on process 1
            make_global_mesh(dp=2, devices=[GlobalDevice(0, 0, None)] + [
                GlobalDevice(1, i, cpu) for i in range(3)])
    finally:
        pmesh.set_global_devices(0, None)


def test_multihost_config_flag_env_fallbacks(monkeypatch):
    monkeypatch.delenv(ENV_COORDINATOR, raising=False)
    assert MultihostConfig.from_flags() is None

    cfg = MultihostConfig.from_flags(
        "127.0.0.1:9999", process_id=1, num_processes=2, dryrun_devices=4
    )
    assert cfg.process_id == 1 and cfg.num_processes == 2
    assert cfg.dryrun_devices == 4

    monkeypatch.setenv(ENV_COORDINATOR, "10.0.0.1:1234")
    monkeypatch.setenv(ENV_PROCESS_ID, "3")
    monkeypatch.setenv(ENV_NUM_PROCESSES, "8")
    env_cfg = MultihostConfig.from_flags()
    assert env_cfg.coordinator == "10.0.0.1:1234"
    assert env_cfg.process_id == 3 and env_cfg.num_processes == 8
    # the reference's fields, then the port's device
    ref = rmh.MultihostConfig.from_flags()
    assert tuple(env_cfg)[: len(ref)] == tuple(ref)
    assert env_cfg.device == "cuda"

    monkeypatch.delenv(ENV_PROCESS_ID)
    with pytest.raises(ValueError):
        MultihostConfig.from_flags("10.0.0.1:1234", num_processes=8)


def test_command_codec_roundtrip():
    arrays = {
        "qkeys": np.arange(12, dtype=np.int32).reshape(3, 4),
        "now": np.array([1, 2, 3], dtype=np.int64),
    }
    raw = _encode_cmd("query", arrays, cls="ops", cut=7)
    head, out = _decode_cmd(raw)
    assert head == {"kind": "query", "cls": "ops", "cut": 7}
    np.testing.assert_array_equal(out["qkeys"], arrays["qkeys"])
    assert out["now"].dtype == np.int64

    head2, out2 = _decode_cmd(_encode_cmd("refresh", cut=123, fp={"a": 1}))
    assert head2["cut"] == 123 and head2["fp"] == {"a": 1}
    assert out2 == {}


@pytest.mark.parametrize("kind,arrays,scalars", [
    ("query", {"qkeys": np.arange(32, dtype=np.int32).reshape(2, 16),
               "alt_lo": np.array([-np.inf, 3.5], np.float32),
               "now": np.array([5, 6], np.int64)}, {"cls": "isas"}),
    ("refresh", None, {"cut": 4096, "fp": {"applied": 3, "classes": {
        "ops": [1, 0, 0, 1]}}, "boundaries": [10, 20, 30], "bgen": 2,
        "sres": None}),
    ("reform", None, {"cut": 77, "members": [0, 1, 2]}),
    ("stop", None, {}),
])
def test_command_codec_crosses_the_packages(kind, arrays, scalars):
    """The command stream is the reference's wire format: equal bytes
    for the same head and arrays, and each package decodes the
    other's."""
    raw = _encode_cmd(kind, arrays, **scalars)
    assert raw == rmh._encode_cmd(kind, arrays, **scalars)
    for dec, blob in ((rmh._decode_cmd, raw),
                      (_decode_cmd, rmh._encode_cmd(kind, arrays,
                                                    **scalars))):
        head, out = dec(blob)
        assert head == {"kind": kind, **scalars}
        assert sorted(out) == sorted(arrays or {})
        for k, v in (arrays or {}).items():
            assert out[k].dtype == v.dtype
            np.testing.assert_array_equal(out[k], v)


def test_replicated_output_query_path_bit_identical():
    """replicate_out=True only changes placement, never the merged
    values — the property the multi-host bit-identical acceptance
    rests on, checked here shape-for-shape on one process, and equal
    to the reference's values."""
    from dss_tpu.dar.oracle import Record as RRecord
    from dss_tpu.parallel import make_mesh as r_make_mesh
    from dss_tpu.parallel import sharded as rs
    from dss_tpu.ops import conflict as rc

    from dss_tpu_torch.dar.oracle import Record
    from dss_tpu_torch.ops.conflict import (
        INT32_MAX,
        NO_TIME_HI,
        NO_TIME_LO,
        query_spec,
    )
    from dss_tpu_torch.parallel import make_mesh
    from dss_tpu_torch.parallel.sharded import (
        ShardedDar,
        sharded_conflict_query_batch,
    )

    rng = np.random.default_rng(3)
    rows = [
        (f"e{i}", np.unique(rng.integers(0, 64, 4).astype(np.int32)),
         0.0, 1000.0, NO_TIME_LO, NO_TIME_HI, 0)
        for i in range(40)
    ]
    mesh = make_mesh(8, dp=2, sp=4, devices=pmesh.virtual_devices("cpu", 8))
    dar = ShardedDar([Record(*r) for r in rows], mesh, max_results=64)
    q = 8
    keys = np.sort(rng.integers(0, 64, (q, 16)).astype(np.int32), axis=1)
    args = (keys, np.full(q, -np.inf, np.float32),
            np.full(q, np.inf, np.float32),
            np.full(q, NO_TIME_LO, np.int64),
            np.full(q, NO_TIME_HI, np.int64))
    now = np.zeros(q, np.int64)
    kw = dict(mesh=mesh, cap=dar.cap, shard_results=64, max_results=64)
    base = sharded_conflict_query_batch(
        dar.post_key, dar.post_ent, dar.ents, query_spec(*args, "cpu"),
        torch.from_numpy(now), **kw)
    repl = sharded_conflict_query_batch(
        dar.post_key, dar.post_ent, dar.ents, query_spec(*args, "cpu"),
        torch.from_numpy(now), replicate_out=True, **kw)
    for b, r in zip(base, repl):
        np.testing.assert_array_equal(b.numpy(), r.numpy())
    assert (base[0].numpy() != int(INT32_MAX)).any()  # hits exist
    assert base[2].numpy().sum() > 0
    rmesh = r_make_mesh(8, dp=2, sp=4)
    rdar = rs.ShardedDar([RRecord(*r) for r in rows], rmesh, max_results=64)
    want = rs.sharded_conflict_query_batch(
        rdar.post_key, rdar.post_ent, rdar.ents,
        rc.QuerySpec(*(jax.numpy.asarray(a) for a in args)),
        jax.numpy.asarray(now), mesh=rmesh, cap=rdar.cap, shard_results=64,
        max_results=64, replicate_out=True,
    )
    for g, w in zip(repl, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_replica_query_refactor_equivalence(tmp_path):
    """query_batch == pad + query_padded, and the degraded host path
    answers identically to the mesh for the same record state."""
    import time as _t
    import uuid

    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.geo import covering as geo_covering
    from dss_tpu_torch.geo import s2cell
    from dss_tpu_torch.parallel import make_mesh
    from dss_tpu_torch.parallel.replica import ShardedReplica
    from dss_tpu_torch.services.scd import SCDService

    from tests.test_sharded import _op_params_at

    wal = tmp_path / "dss.wal"
    store = DSSStore(storage="memory", wal_path=str(wal))
    scd = SCDService(store.scd, store.clock)
    ids = []
    for i in range(4):
        op = str(uuid.uuid4())
        scd.put_operation(op, _op_params_at(40.0 + 0.1 * i), "uss1")
        ids.append(op)
    rep = ShardedReplica(
        make_mesh(8, dp=2, sp=4, devices=pmesh.virtual_devices("cpu", 8)),
        wal_path=str(wal))
    rep.sync()
    keys_list = []
    for i in range(4):
        cells = geo_covering.covering_polygon(
            [(40.0 + 0.1 * i, -100.0), (40.02 + 0.1 * i, -100.0),
             (40.02 + 0.1 * i, -99.98), (40.0 + 0.1 * i, -99.98)]
        )
        keys_list.append(s2cell.cell_to_dar_key(cells))
    now = int(_t.time() * 1e9) + int(120e9)
    b = len(keys_list)
    args = (
        keys_list,
        np.full(b, -np.inf, np.float32),
        np.full(b, np.inf, np.float32),
        np.full(b, -(2**62), np.int64),
        np.full(b, 2**62, np.int64),
    )
    mesh_res = rep.query_batch(*args, now=now, cls="ops")
    padded = rep.pad_query_batch(*args, now=now)
    assert rep.query_padded("ops", *padded) == mesh_res
    assert rep.query_batch_host(*args, now=now, cls="ops") == mesh_res
    for i, op in enumerate(ids):
        assert op in mesh_res[i]
    # fingerprints are deterministic and JSON-stable (the lockstep
    # divergence check round-trips through the command codec)
    fp = rep.state_fingerprint()
    assert json.loads(json.dumps(fp)) == fp
    assert fp["classes"]["ops"][0] == 4
    rep.close()
    store.close()


def test_multihost_metrics_names_are_stable():
    assert "dss_multihost_degraded" in MULTIHOST_METRICS
    assert "dss_multihost_refresh_bytes" in MULTIHOST_METRICS
    assert all(m.startswith("dss_multihost_") for m in MULTIHOST_METRICS)
    assert MULTIHOST_METRICS == rmh.MULTIHOST_METRICS


# -- the default device ---------------------------------------------------------------


def test_the_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from dss_tpu_torch.cmds.multihost_dryrun import run_dryrun

    cfg = MultihostConfig("127.0.0.1:0", 0, 1, dryrun_devices=2)
    with pytest.raises(RuntimeError, match="cuda"):
        pmh.initialize(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_dryrun(str(tmp_path))
    assert not os.listdir(tmp_path)  # no fixture, no process
    assert not torch.distributed.is_initialized()


# -- two processes over gloo ------------------------------------------------------------


_DP2 = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np, torch
    from dss_tpu_torch.dar.oracle import Record
    from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
    from dss_tpu_torch.parallel import make_mesh, mesh as pmesh
    from dss_tpu_torch.parallel import multihost as mh
    from dss_tpu_torch.parallel.sharded import ShardedDar

    pid, port_file, out, port = sys.argv[1:]
    pid = int(pid)

    def bound(p):
        with open(port_file + ".tmp", "w") as fh:
            fh.write(str(p))
        os.replace(port_file + ".tmp", port_file)

    torch.set_num_threads(1)  # two processes share the host's cores
    rt = mh.initialize(mh.MultihostConfig(
        f"127.0.0.1:{port}", pid, 2, dryrun_devices=4, device="cpu"),
        on_bound=bound if pid == 0 else None)
    rng = np.random.default_rng(5)
    recs = []
    for i in range(300):
        k = np.unique(rng.integers(0, 400, rng.integers(1, 9)))
        t0 = int(rng.integers(0, 50))
        recs.append(Record(f"e{i}", k.astype(np.int32),
                           float(rng.uniform(0, 500)), 2000.0, t0,
                           t0 + int(rng.integers(1, 20)), i % 3))
    pl = pmesh.make_global_mesh(dp=2)
    pl.mesh.group = mh.member_group((0, 1))
    one = make_mesh(8, dp=2, sp=4, devices=pmesh.virtual_devices("cpu", 8))
    q = 40
    keys = np.full((q, 16), -1, np.int32)
    for i in range(q):
        keys[i, :6] = np.sort(rng.choice(400, 6, replace=False))
    args = (keys, np.full(q, -np.inf, np.float32),
            np.full(q, np.inf, np.float32), np.full(q, NO_TIME_LO),
            np.full(q, NO_TIME_HI))
    now = rng.integers(0, 60, q).astype(np.int64)
    res = {}
    for name, mesh in (("spanning", pl.mesh), ("one", one)):
        # shard_results 4 makes shards overflow: the flag crosses too
        dar = ShardedDar(recs, mesh, max_results=64, shard_results=4)
        res[name] = {"answers": dar.query_batch(*args, now=now),
                     "hits": dar.shard_hits.tolist(),
                     "fallbacks": dar.overflow_fallbacks,
                     "nbytes": dar.nbytes, "multihost": dar.multihost}
    res["placement"] = pl.describe()
    res["gathers"] = pl.mesh.seam.gathers
    with open(out, "w") as fh:
        json.dump(res, fh)
    rt.close()
    """
)


def test_spanning_mesh_dp2_equals_one_process(tmp_path):
    """A global 2x4 mesh over two processes (4 CPU positions each, dp=2
    column-blocked: each process two whole columns of both rows)
    answers, counts shard hits and falls back exactly as a one-process
    2x4 mesh; each process holds half the shard rows."""
    port_file = str(tmp_path / "port")
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, port = [], "0"
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DP2, str(i), port_file, outs[i], port],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
        deadline = time.monotonic() + 30
        while not os.path.exists(port_file):
            if time.monotonic() > deadline or procs[0].poll() is not None:
                procs[0].kill()
                pytest.fail("process 0 never bound its store: "
                            + procs[0].communicate()[1].decode()[-2000:])
            time.sleep(0.05)
        port = open(port_file).read()
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        errs.append(err.decode(errors="replace"))
    assert [p.returncode for p in procs] == [0, 0], errs
    res = [json.load(open(o)) for o in outs]
    for r in res:
        assert r["placement"] == "p0:sp[0, 1] p1:sp[2, 3]"
        assert r["spanning"]["multihost"] and not r["one"]["multihost"]
        for k in ("answers", "hits", "fallbacks"):
            assert r["spanning"][k] == r["one"][k], k
        assert r["one"]["fallbacks"] > 0
        assert r["gathers"] == 1
        # half the shard rows, all of the entity columns
        assert r["spanning"]["nbytes"] < r["one"]["nbytes"]
    assert res[0]["spanning"] == res[1]["spanning"]


def _reference_answers(fixture, now, tmp_path):
    """The reference's in-process single-process ShardedReplica at 1x4
    (JAX on the virtual CPU devices) over the fixture WAL: wave A, then
    wave B appended."""
    from dss_tpu.cmds.multihost_dryrun import _query_keys, _run_queries
    from dss_tpu.parallel import make_mesh as r_make_mesh
    from dss_tpu.parallel.replica import ShardedReplica

    wal = tmp_path / "ref.wal"
    wal.write_bytes(open(os.path.join(fixture, "wal_a.jsonl"), "rb").read())
    rep = ShardedReplica(r_make_mesh(4, dp=1, sp=4), wal_path=str(wal),
                         warm_batches=(1,))
    keys = _query_keys()
    try:
        rep.sync()
        wave_a = _run_queries(rep, keys, now)
        with open(wal, "ab") as fh:
            fh.write(open(os.path.join(fixture, "wal_b.jsonl"), "rb").read())
        rep.sync()
        wave_b = _run_queries(rep, keys, now)
    finally:
        rep.close()
    return keys, wave_a, wave_b


def test_two_process_dryrun_on_the_cpu_equals_the_reference(tmp_path):
    """The port's dryrun on the CPU: every leg ok; the two-process
    mesh's answers equal the reference's single-process ShardedReplica
    at 1x4 on the same fixture, keys and `now`."""
    from dss_tpu_torch.cmds.multihost_dryrun import _query_keys, run_dryrun

    verdict = run_dryrun(str(tmp_path), num_processes=2,
                         devices_per_process=2, reps=1, timeout_s=90,
                         device="cpu")
    assert verdict["ok"], json.dumps(verdict, default=str)[-4000:]
    assert verdict["bit_identical"] and verdict["peerloss_ok"]
    assert verdict["elastic_ok"] and verdict["capacity_ok"]
    multi = verdict["multi"]
    assert multi["num_processes"] == 2 and multi["device"] == "cpu"
    assert multi["placement"] == {"0": [0, 1], "1": [2, 3]}
    stats = multi["stats"]
    assert stats["dss_multihost_processes"] == 2
    assert stats["dss_multihost_degraded"] == 0
    assert stats["dss_multihost_refresh_bytes"] > 0
    assert stats["dss_shard_members"] == 2
    assert stats["dss_multihost_gathers"] > 0
    el = verdict["elastic"]
    assert el["hotmove"]["boundary_moves"] >= 1
    assert (el["hotmove"]["imbalance_after"]
            < el["hotmove"]["imbalance_before"])
    assert el["join"]["members"] == [0, 1, 2]
    assert el["join"]["placement"] == {"0": [0, 1], "1": [2, 3],
                                       "2": [4, 5]}
    assert el["leave"]["members"] == [0, 1]
    pl = verdict["peerloss"]
    assert pl["degraded"] and pl["host_only_match"]
    assert pl["local_mesh_match"]
    assert pl["stats"]["dss_multihost_degraded"] == 1
    assert pl["stats"]["dss_multihost_local_only"] == 1
    # the JAX reference, in this process, on the same fixture
    keys, wave_a, wave_b = _reference_answers(
        os.path.join(str(tmp_path), "fixture"), multi["now"], tmp_path)
    for a, b in zip(keys, _query_keys()):
        np.testing.assert_array_equal(a, b)
    assert multi["wave_a"] == wave_a
    assert multi["wave_b"] == wave_b
    assert any(ids for rows in wave_b.values() for ids in rows)

"""The port's import line, device rule and state carried across.

- Every module of dss_tpu_torch (the serving modules by name: errors,
  chaos, deadline, coalesce, trace, stages, plan, resident; the store
  slice's by name: clock, runtime, chaos.retry, chaos.ladder, models,
  geo.covering, dar.codec, dar.wal, dar.readcache, dar.store,
  dar.dss_store, dar.follower; the API slice's by name: build_info,
  obs.metrics, obs.logging, auth, auth.jwt, auth.authorizer, services,
  services.serialization, services.rid, services.scd, api, api.app,
  cmds, cmds.dummy_oauth, cmds.server; the native/push slice's by
  name: native, native._buildlib, push, push.queue, push.deliver,
  push.match, push.pipeline; the shm front's by name: parallel,
  parallel.shmring, dar.shmfront, plan.shmroute; the mesh route's by
  name: ops.conflict, parallel.mesh, parallel.sharded,
  parallel.replica; the region's by name: region, region.client,
  region.log_server, region.mirror, region.coordinator,
  cmds.region_server; the federation's by name: region.federation,
  cmds.federation_dryrun; the tuner's by name: scenario,
  scenario.generator, plan.autotune, tune, tune.observe, tune.propose,
  tune.shadow, tune.controller; multihost's by name: parallel.multihost,
  cmds.multihost_dryrun; the mesh kernels' by name: ops.mesh_cuda),
  chip_smoke and b1_device_time import in a
  process where `jax`, `requests` (absent on the card's machine; the
  region client rides http.client) and every `dss_tpu` module are
  refused.
- Tables, stores and the autotune sweep run without device= on a
  machine without CUDA raise instead of running on the CPU.
- convert round trip: reference records and table arrays become port
  state that answers the same.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.oracle import Record as RefRecord
from dss_tpu.dar.snapshot import DarTable as RefDarTable
from dss_tpu.dar import tiers as ref_tiers

from dss_tpu_torch import convert
from dss_tpu_torch.dar import tiers
from dss_tpu_torch.dar.dss_store import DSSStore
from dss_tpu_torch.dar.index import CudaSpatialIndex
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.ops.fastpath import FastTable, warmup
from dss_tpu_torch.parallel.mesh import make_mesh
from dss_tpu_torch.plan import autotune

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    sys.modules["jax"] = None  # any `import jax` raises ImportError
    sys.modules["requests"] = None  # nor `import requests`

    class RefuseReference:
        def find_spec(self, name, path=None, target=None):
            if name == "dss_tpu" or name.startswith("dss_tpu."):
                raise ImportError(f"port imported the reference: {name}")
            return None

    sys.meta_path.insert(0, RefuseReference())
    import dss_tpu_torch

    names = ["dss_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            dss_tpu_torch.__path__, "dss_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    for mod in ("ops.fastpath_cuda", "ops.cuda_build", "ops.resident",
                "errors", "chaos", "chaos.faults", "dar.deadline",
                "dar.coalesce", "obs.trace", "obs.stages", "plan",
                "plan.costs", "plan.planner", "clock", "runtime",
                "chaos.retry", "chaos.ladder", "models", "models.core",
                "models.volumes", "models.rid", "models.scd", "geo.s2cell",
                "geo.covering", "dar.codec", "dar.wal", "dar.readcache",
                "dar.store", "dar.dss_store", "dar.follower",
                "build_info", "obs.metrics", "obs.logging", "auth",
                "auth.jwt", "auth.authorizer", "services",
                "services.serialization", "services.rid", "services.scd",
                "api", "api.app", "cmds", "cmds.dummy_oauth",
                "cmds.server", "native", "native._buildlib", "push",
                "push.queue", "push.deliver", "push.match",
                "push.pipeline", "parallel", "parallel.shmring",
                "dar.shmfront", "plan.shmroute", "ops.conflict",
                "parallel.mesh", "parallel.sharded",
                "parallel.replica", "region", "region.client",
                "region.log_server", "region.mirror",
                "region.coordinator", "cmds.region_server",
                "region.federation", "cmds.federation_dryrun",
                "scenario", "scenario.generator", "plan.autotune",
                "tune", "tune.observe", "tune.propose", "tune.shadow",
                "tune.controller", "parallel.multihost",
                "cmds.multihost_dryrun", "ops.mesh_cuda"):
        assert "dss_tpu_torch." + mod in names, (mod, names)
    import chip_smoke  # its helpers; main() only runs as a script
    assert callable(chip_smoke.run) and callable(chip_smoke.make_batch)
    import b1_device_time  # loads chip_smoke anew from its own path
    assert callable(b1_device_time.load_smoke(b1_device_time.HERE).run)
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "requests") and sys.modules[m] is not None
                 or m == "dss_tpu" or m.startswith("dss_tpu."))
    assert not bad, bad
    print(len(names))
    """
)


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 53  # every module was reached


def _tiny_table_args():
    n = 4
    z = np.zeros(n, np.float32)
    t = np.zeros(n, np.int64)
    live = np.ones(n, bool)
    return (
        (np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
         z, z, t, t, live),
        dict(alt_lo=z, alt_hi=z, t0=t, t1=t, live=live),
    )


@pytest.mark.parametrize("make", ["fasttable", "dartable", "index", "snapshot",
                                  "warmup", "store", "region_store",
                                  "mesh", "autotune"])
def test_default_device_without_a_card_raises(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, se = _tiny_table_args()
    build = {
        "fasttable": lambda: FastTable(*args, slot_exact=se),
        "dartable": lambda: DarTable(),
        "index": lambda: CudaSpatialIndex(),
        "snapshot": lambda: tiers.build_snapshot(
            [RefRecord("a", np.asarray([1], np.int32), 0.0, 1.0, 0, 1, 0)]
        ),
        "warmup": lambda: warmup(),
        "store": lambda: DSSStore(storage="cuda"),
        # a region instance: the card is needed before the log is asked
        "region_store": lambda: DSSStore(storage="cuda",
                                         region_url="http://127.0.0.1:1"),
        "mesh": lambda: make_mesh(2, dp=1, sp=2),
        # the sweep refuses before it builds its fixture
        "autotune": lambda: autotune.autotune(quick=True),
    }[make]
    with pytest.raises(RuntimeError, match="cuda"):
        build()
    # an explicit CPU device is the caller's choice and works
    FastTable(*args, slot_exact=se, device="cpu")


def _ref_records(rng, n):
    out = []
    for i in range(n):
        k = np.unique(rng.integers(0, 200, rng.integers(1, 6))).astype(np.int32)
        a = float(rng.uniform(0, 1000))
        t0 = int(rng.integers(0, 20))
        out.append(RefRecord(f"r{i}", k, a, a + 200.0, t0,
                             t0 + int(rng.integers(1, 9)), i % 3))
    return out


def test_convert_round_trip():
    rng = np.random.default_rng(4)
    recs = _ref_records(rng, 500)
    ported = convert.records_from_reference(recs)
    assert [r.entity_id for r in ported] == [r.entity_id for r in recs]
    for a, b in zip(ported, recs):
        np.testing.assert_array_equal(a.keys, b.keys)
        assert (a.alt_lo, a.alt_hi, a.t_start, a.t_end, a.owner_id) == (
            b.alt_lo, b.alt_hi, b.t_start, b.t_end, b.owner_id
        )

    ref = RefDarTable(idle_fold_s=0)
    ref.bulk_load(recs)
    port = convert.dartable_from_records(recs, device="cpu", idle_fold_s=0)
    try:
        # same slots: the L0 snapshots list ids in the same order
        assert port._state.snap.ids == ref._state.snap.ids
        keys_list = [np.asarray([k, k + 1], np.int32) for k in range(0, 200, 2)]
        b = len(keys_list)
        q = (
            np.full(b, -np.inf, np.float32), np.full(b, np.inf, np.float32),
            np.zeros(b, np.int64), np.full(b, 30, np.int64),
        )
        want = ref.query_many(keys_list, *q, now=3)
        assert port.query_many(keys_list, *q, now=3) == want

        # the reference L0 table's arrays -> a port FastTable
        rf = ref._state.snap.fast
        ft = convert.fasttable_from_arrays(
            rf.host_key, rf.host_ent, rf.host_live, rf.slot_exact,
            rf.b_alo, rf.b_ahi, rf.b_t0, rf.b_t1, p3=np.asarray(rf.p3),
            device="cpu",
        )
        qkeys = np.full((b, 16), -1, np.int32)
        for i, k in enumerate(keys_list):
            qkeys[i, :2] = k
        got = ft.query_fused(qkeys, *q, now=3)
        exp = rf.query_fused(qkeys, *q, now=3)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        # the carried p3 answers the legacy path as the reference does
        got = ft.query_batch(qkeys, *q, now=3, use_kernel=True)
        exp = rf.query_batch(qkeys, *q, now=3)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        # tier bookkeeping agrees too
        assert tiers.stats(port._state.tiers) == ref_tiers.stats(
            ref._state.tiers
        )
    finally:
        ref.close()
        port.close()

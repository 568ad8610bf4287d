"""Multi-process dryrun of the multi-host mesh (the process seam).

Proves the process-spanning mesh: two OS processes join ONE mesh
(parallel/multihost.py: a TCPStore and a gloo process group), tail the
same WAL, fold the tier protocol in lockstep, and answer the same
sharded queries BIT-IDENTICALLY to a single-process run of the same
mesh shape.  A peer-loss leg kills the follower mid-serve and asserts
the leader flips to degraded local-only serving with unchanged answers;
an elastic leg moves a hot range's boundary, joins a third process and
lets it leave again; a capacity leg splits under per-host capacity
weights.

The port of the reference's `dss_tpu/cmds/multihost_dryrun.py`.  As a
port entry point it runs on the card unless asked otherwise: every
worker's mesh positions are `--multihost_dryrun N` virtual positions on
`--device` (default `cuda`, which raises on a machine without a card;
`--device cpu` runs the plain versions), so two or three processes
share one card; the reference's are N virtual CPU devices each.  The
cross-process collectives ride gloo on host-staged tensors, as the
reference's dryrun rides gloo.  Process 0's store binds a free port,
which reaches the other workers through a file in the leg's directory,
and each worker logs to a file there.

Three roles in one module:

  python -m dss_tpu_torch.cmds.multihost_dryrun --make_wal DIR
      write the WAL fixture: wave A (wal_a) + a live tail (wal_b)
      through the port's store + services, all four entity classes.

  python -m dss_tpu_torch.cmds.multihost_dryrun --process_id I \\
      --num_processes N --jax_coordinator 127.0.0.1:PORT \\
      --multihost_dryrun 2 --wal ... [--out ...] [--peerloss]
      one mesh worker (process 0 = leader, writes the result JSON).

  run_dryrun(...)  — the orchestrator API: spawns the fixture writer
      and the workers, compares against the single-process run,
      returns the combined verdict.

Usage:  python -m dss_tpu_torch.cmds.multihost_dryrun --run
            [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# fixture geometry: one small box per index, disjoint across indexes
LATS = [40.0 + 0.1 * i for i in range(6)]
NEW_LAT = 41.0  # wave-B addition


def _box(lat):
    return [
        (lat, -100.0), (lat + 0.02, -100.0),
        (lat + 0.02, -99.98), (lat, -99.98),
    ]


def _iso(off):
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + off)
    )


def _isa_params(lat):
    return {
        "extents": {
            "spatial_volume": {
                "footprint": {
                    "vertices": [
                        {"lat": a, "lng": b} for a, b in _box(lat)
                    ]
                },
                "altitude_lo": 10.0,
                "altitude_hi": 300.0,
            },
            "time_start": _iso(60),
            "time_end": _iso(3600),
        },
        "flights_url": "https://uss.example.com/f",
    }


def _rid_sub_params(lat):
    return {
        "extents": {
            "spatial_volume": {
                "footprint": {
                    "vertices": [
                        {"lat": a, "lng": b} for a, b in _box(lat)
                    ]
                },
                "altitude_lo": 0.0,
                "altitude_hi": 3000.0,
            },
            "time_start": _iso(60),
            "time_end": _iso(3600),
        },
        "callbacks": {
            "identification_service_area_url": "https://uss.example.com"
        },
    }


def _op_params(lat):
    return {
        "extents": [
            {
                "volume": {
                    "outline_polygon": {
                        "vertices": [
                            {"lat": a, "lng": b} for a, b in _box(lat)
                        ]
                    },
                    "altitude_lower": {
                        "value": 50.0, "reference": "W84", "units": "M"
                    },
                    "altitude_upper": {
                        "value": 200.0, "reference": "W84", "units": "M"
                    },
                },
                "time_start": {"value": _iso(60), "format": "RFC3339"},
                "time_end": {"value": _iso(3600), "format": "RFC3339"},
            }
        ],
        "uss_base_url": "https://uss.example.com",
        "new_subscription": {"uss_base_url": "https://uss.example.com"},
        "state": "Accepted",
        "old_version": 0,
        "key": [],
    }


def make_wal(outdir: str) -> None:
    """Write the fixture: wal_a (wave A) + wal_b (the live tail the
    leader appends mid-run, exercising the DELTA fold path)."""
    from dss_tpu_torch.dar.dss_store import DSSStore
    from dss_tpu_torch.services.rid import RIDService
    from dss_tpu_torch.services.scd import SCDService

    wal = os.path.join(outdir, "full.wal")
    store = DSSStore(storage="memory", wal_path=wal)
    rid = RIDService(store.rid, store.clock)
    scd = SCDService(store.scd, store.clock)
    ids = {"isas": [], "ops": []}
    for i, lat in enumerate(LATS):
        owner = f"uss{i}"
        isa_id = f"00000000-0000-4000-8000-00000000a{i:03d}"
        rid.create_isa(isa_id, _isa_params(lat), owner)
        ids["isas"].append(isa_id)
        rid.create_subscription(
            f"00000000-0000-4000-8000-00000000b{i:03d}",
            _rid_sub_params(lat),
            owner,
        )
        op_id = f"00000000-0000-4000-8000-00000000c{i:03d}"
        scd.put_operation(op_id, _op_params(lat), owner)
        ids["ops"].append(op_id)
    cut = os.path.getsize(wal)
    # wave B: an add, an update-shadowing write, and a delete — the
    # delta fold must ship adds AND hide superseded/deleted base rows
    rid.create_isa(
        "00000000-0000-4000-8000-00000000a900",
        _isa_params(NEW_LAT),
        "uss9",
    )
    v = rid.get_isa(ids["isas"][0])["service_area"]["version"]
    rid.delete_isa(ids["isas"][0], v, "uss0")
    scd.delete_operation(ids["ops"][1], "uss1")
    store.close()
    with open(wal, "rb") as fh:
        blob = fh.read()
    with open(os.path.join(outdir, "wal_a.jsonl"), "wb") as fh:
        fh.write(blob[:cut])
    with open(os.path.join(outdir, "wal_b.jsonl"), "wb") as fh:
        fh.write(blob[cut:])


# -- worker -------------------------------------------------------------------


def _query_keys():
    """Deterministic per-box DAR key sets (computed identically in
    every process — pure geometry, no RNG)."""
    from dss_tpu_torch.geo import covering as geo_covering
    from dss_tpu_torch.geo import s2cell

    out = []
    for lat in LATS + [NEW_LAT]:
        cells = geo_covering.covering_polygon(_box(lat))
        out.append(s2cell.cell_to_dar_key(cells))
    return out


def _run_queries(replica, keys_list, now):
    import numpy as np

    b = len(keys_list)
    res = {}
    for cls in ("ops", "isas", "rid_subs", "scd_subs"):
        res[cls] = replica.query_batch(
            keys_list,
            np.full(b, -np.inf, np.float32),
            np.full(b, np.inf, np.float32),
            np.full(b, -(2**62), np.int64),
            np.full(b, 2**62, np.int64),
            now=now,
            cls=cls,
        )
    return res


def _write_json(path: str, obj) -> None:
    """Write `obj` to `path` whole or not at all (a reader polls it)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def worker(args) -> None:
    import torch

    from dss_tpu_torch.parallel import multihost as mh

    if args.device == "cpu":
        # the workers share the host's cores (their tensors are tiny):
        # one intra-op thread each, or a leg's processes oversubscribe
        # the host many times over
        torch.set_num_threads(1)

    cfg = mh.MultihostConfig(
        coordinator=args.jax_coordinator,
        process_id=args.process_id,
        num_processes=args.num_processes,
        dryrun_devices=args.multihost_dryrun,
        watchdog_interval_s=args.watchdog_interval,
        watchdog_timeout_s=args.watchdog_timeout,
        device=args.device,
    )
    # process 0 may bind a free port: hand it to the other workers
    runtime = mh.initialize(
        cfg,
        on_bound=(lambda port: _write_json(args.port_file, port))
        if args.port_file else None,
    )

    from dss_tpu_torch.parallel.mesh import make_global_mesh

    # serving membership may be a subset of the provisioned world:
    # non-member processes are standby slots that tail the log in
    # lockstep (their snapshot+tail catch-up) until a reform joins
    # them — the elastic-membership leg drives exactly that
    members = (
        tuple(int(x) for x in args.members.split(","))
        if args.members
        else tuple(range(args.num_processes))
    )
    placement = make_global_mesh(dp=1, processes=members)
    replica = mh.MultihostReplica(
        runtime,
        placement,
        wal_path=args.wal,
        warm_batches=(1,),
        members=members,
    )
    if args.capacity:
        # per-HOST capacity weights (the autotune profiles'
        # capacity_weight scalars) expanded to the per-sp-shard vector
        # the splitter consumes: every column a host owns carries that
        # host's capacity, so a slow host's key runs come out
        # proportionally lighter.  Leader-only input (followers apply
        # broadcast boundaries verbatim) but harmless everywhere.
        import numpy as np

        host_cap = [float(x) for x in args.capacity.split(",")]
        if len(host_cap) < runtime.num_processes:
            raise SystemExit(
                f"--capacity needs {runtime.num_processes} entries"
            )
        cap_vec = np.ones(placement.sp, np.float64)
        for pid, cols in placement.sp_by_process.items():
            for c in cols:
                cap_vec[c] = host_cap[int(pid)]
        replica._inner.capacity_weights = cap_vec
    # the elastic leg forces a deterministic hot-range boundary move:
    # lift the move-rate cap so the forced rebalance fires on the very
    # next fold instead of waiting out the production default
    replica._inner.move_interval_s = 0.0

    if not runtime.is_leader:
        # the peer-loss leg: the leader orders this follower to die
        # abruptly mid-serve (a SIGKILL'd host, not a clean exit)
        replica.extra_commands["die"] = lambda head: os._exit(9)
        try:
            replica.run_follower()
            rc = 0
        except mh.MultihostDegradedError:
            rc = 3
        replica.close()
        runtime.close()
        sys.exit(rc)

    # -- leader ---------------------------------------------------------------
    now = int(time.time() * 1e9) + int(120e9)
    keys_list = _query_keys()
    out = {
        "num_processes": runtime.num_processes,
        "device": args.device,
        "now": now,
        "mesh": {"dp": placement.dp, "sp": placement.sp},
        "placement": {
            str(p): list(cols)
            for p, cols in placement.sp_by_process.items()
        },
    }
    t0 = time.perf_counter()
    replica.sync()  # wave A: major fold per class
    out["wave_a"] = _run_queries(replica, keys_list, now)
    with open(args.wal_b, "rb") as src, open(args.wal, "ab") as dst:
        dst.write(src.read())
    replica.sync()  # wave B: delta fold
    out["refresh_s"] = round(time.perf_counter() - t0, 3)
    out["wave_b"] = _run_queries(replica, keys_list, now)

    # steady-state cross-process query throughput (every round runs
    # 4 classes x len(keys_list) queries through the mesh)
    reps = max(args.reps, 1)
    nq = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        r = _run_queries(replica, keys_list, now)
        nq += sum(len(v) for v in r.values())
    out["query_s"] = round(time.perf_counter() - t0, 3)
    out["queries"] = nq
    out["query_qps"] = round(nq / max(out["query_s"], 1e-9), 1)

    if args.elastic and runtime.num_processes > 2:
        import numpy as np

        # -- forced hot-range boundary move -----------------------------------
        # hammer one hot box so the load EWMA concentrates in its key
        # range; the next sync detects the imbalance, broadcasts the
        # new boundary map with the fold cut, and every member rebuilds
        # under it — answers must not move a bit
        inner = replica._inner
        hot = keys_list[0]
        for _ in range(40):
            replica.query_batch(
                [hot],
                np.full(1, -np.inf, np.float32),
                np.full(1, np.inf, np.float32),
                np.full(1, -(2**62), np.int64),
                np.full(1, 2**62, np.int64),
                now=now,
                cls="isas",
            )
        # the million-user hot spot, compressed: stamp the hot box's
        # key range with heavy measured work (the same RangeLoad.record
        # call the serving paths make, at a deterministic magnitude)
        for _ in range(20):
            inner.load.record(hot, work=200.0)
        inner.plan_rebalance()  # evaluates; may already move
        imb_before = inner._imbalance
        replica.sync()  # broadcasts boundaries with the fold cut
        out["hotmove"] = {
            "imbalance_before": round(imb_before, 3),
            "boundary_moves": inner.boundary_moves,
            "boundaries": (
                None if inner.boundaries is None
                else [int(x) for x in inner.boundaries]
            ),
        }
        hot_res = _run_queries(replica, keys_list, now)
        out["hotmove"]["match"] = hot_res == out["wave_b"]
        # recovery: replan under the new boundaries — the measured
        # imbalance must drop back under the threshold
        inner.plan_rebalance()
        out["hotmove"]["imbalance_after"] = round(inner._imbalance, 3)

        # -- host join (snapshot+tail, cut in at the next fold) ---------------
        joiner = runtime.num_processes - 1
        new_members = tuple(
            sorted(set(replica.members) | {joiner})
        )
        replica.set_members(new_members)
        replica.sync()  # reform at this fold boundary
        out["join"] = {
            "members": list(replica.members),
            "mesh": dict(replica.mesh.shape),
            "placement": {
                str(p): list(cols)
                for p, cols in replica.placement.sp_by_process.items()
            },
        }
        join_res = _run_queries(replica, keys_list, now)
        out["join"]["match"] = join_res == out["wave_b"]
        # a SECOND hot-range move AFTER the join: the reform reset
        # boundary_gen on every process (joiner included), so this
        # move's broadcast must drive the identical force-major
        # decision on all three — the exact lockstep seam a stale
        # generation would wedge
        for _ in range(20):
            inner.load.record(hot, work=200.0)
        inner._last_decay = float("-inf")
        replica.sync()
        out["join"]["post_join_moves"] = inner.boundary_moves
        out["join"]["post_join_match"] = (
            _run_queries(replica, keys_list, now) == out["wave_b"]
        )

        # -- graceful leave (departing host's ranges redistribute) ------------
        replica.set_members(tuple(m for m in new_members if m != joiner))
        replica.sync()
        out["leave"] = {
            "members": list(replica.members),
            "mesh": dict(replica.mesh.shape),
        }
        leave_res = _run_queries(replica, keys_list, now)
        out["leave"]["match"] = leave_res == out["wave_b"]

    if args.capacity:
        # heterogeneous-capacity placement: force a load-driven move
        # with per-host capacity weights active — the split targets
        # skew toward the fast host, the per-shard result capacity
        # re-sizes from the post-move predicted load, and the ANSWERS
        # must not move a bit (placement never changes results)
        inner = replica._inner
        hot = keys_list[0]
        for _ in range(20):
            inner.load.record(hot, work=200.0)
        inner._last_decay = float("-inf")
        replica.sync()  # plans under capacity weights + broadcasts
        out["capmove"] = {
            "capacity": [float(x) for x in args.capacity.split(",")],
            "boundary_moves": inner.boundary_moves,
            "boundaries": (
                None if inner.boundaries is None
                else [int(x) for x in inner.boundaries]
            ),
            "shard_results_cap": int(inner._build_shard_results() or 0),
            "match": _run_queries(replica, keys_list, now)
            == out["wave_b"],
        }

    if args.peerloss and runtime.num_processes > 1:
        replica.broadcast_control("die")
        t_kill = time.perf_counter()
        deadline = time.monotonic() + 3 * args.watchdog_timeout + 5
        while not runtime.degraded and time.monotonic() < deadline:
            time.sleep(0.05)
        out["degraded"] = runtime.degraded
        out["degraded_after_s"] = round(time.perf_counter() - t_kill, 3)
        # host-only window: the mesh is gone, answers must still be
        # exact (served straight from the tailed record map)
        host_res = _run_queries(replica, keys_list, now)
        out["host_only_match"] = host_res == out["wave_b"]
        replica.sync()  # re-home on the local mesh
        local_res = _run_queries(replica, keys_list, now)
        out["local_mesh_match"] = local_res == out["wave_b"]

    out["stats"] = {
        k: v
        for k, v in replica.stats().items()
        if isinstance(v, (int, float))
    }
    replica.close()
    runtime.close()
    if args.out:
        _write_json(args.out, out)
    else:
        print(json.dumps(out))


# -- orchestrator -------------------------------------------------------------


def _spawn(argv, log_path):
    """A worker process, logging to `log_path` (a file, not a pipe: an
    undrained pipe would stall a worker that the orchestrator is not
    waiting on yet)."""
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "dss_tpu_torch.cmds.multihost_dryrun",
             *argv],
            cwd=REPO,
            stdout=log,
            stderr=subprocess.STDOUT,
        )


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as fh:
            return fh.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def _run_leg(
    workdir: str,
    fixture: str,
    num_processes: int,
    *,
    devices_per_process: int = 2,
    peerloss: bool = False,
    members: str = "",
    elastic: bool = False,
    capacity: str = "",
    reps: int = 3,
    watchdog_interval: float = 0.25,
    watchdog_timeout: float = 2.0,
    timeout_s: float = 600.0,
    device: str = "cuda",
) -> dict:
    os.makedirs(workdir, exist_ok=True)
    wal = os.path.join(workdir, "dss.wal")
    shutil.copyfile(os.path.join(fixture, "wal_a.jsonl"), wal)
    out_path = os.path.join(workdir, "leader.json")
    port_path = os.path.join(workdir, "coordinator.port")
    common = [
        "--num_processes", str(num_processes),
        "--multihost_dryrun", str(devices_per_process),
        "--device", device,
        "--wal", wal,
        "--wal_b", os.path.join(fixture, "wal_b.jsonl"),
        "--reps", str(reps),
        "--watchdog_interval", str(watchdog_interval),
        "--watchdog_timeout", str(watchdog_timeout),
    ]
    if peerloss:
        common.append("--peerloss")
    if members:
        common += ["--members", members]
    if elastic:
        common.append("--elastic")
    if capacity:
        common += ["--capacity", capacity]
    logs = [os.path.join(workdir, f"worker{i}.log")
            for i in range(num_processes)]
    deadline = time.monotonic() + timeout_s
    # process 0 binds a free port for its store and writes it to a file
    # (no bind-and-close race with other runs on the host)
    procs = [_spawn(["--process_id", "0", *common,
                     "--jax_coordinator", "127.0.0.1:0",
                     "--port_file", port_path, "--out", out_path], logs[0])]
    port = None
    while port is None and time.monotonic() < deadline:
        if os.path.exists(port_path):
            with open(port_path, encoding="utf-8") as fh:
                port = json.load(fh)
        elif procs[0].poll() is not None:
            break
        else:
            time.sleep(0.05)
    if port is not None:
        for i in range(1, num_processes):
            procs.append(_spawn(["--process_id", str(i), *common,
                                 "--jax_coordinator", f"127.0.0.1:{port}"],
                                logs[i]))
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1.0)))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p in procs:  # nothing outlives its leg
        if p.poll() is None:
            p.kill()
            p.wait()
    leader_ok = rcs[0] == 0 and os.path.exists(out_path)
    # follower exit: 0 on clean stop; 9 when the peerloss leg killed it
    follower_ok = len(rcs) == num_processes and all(
        rc == (9 if peerloss else 0) for rc in rcs[1:]
    )
    result = {
        "rcs": rcs,
        "ok": leader_ok and follower_ok,
        "log_tail": "" if leader_ok and follower_ok else "\n".join(
            _tail(path) for path in logs
        ),
    }
    if leader_ok:
        with open(out_path, "r", encoding="utf-8") as fh:
            result["leader"] = json.load(fh)
    return result


def run_dryrun(
    workdir: str,
    *,
    num_processes: int = 2,
    devices_per_process: int = 2,
    reps: int = 3,
    timeout_s: float = 600.0,
    elastic: bool = True,
    capacity: bool = True,
    device: str = "cuda",
) -> dict:
    """The full acceptance: fixture -> single-process run ->
    N-process mesh (bit-identical check) -> peer-loss leg (degraded
    local-only check) -> elasticity leg (forced hot-range boundary
    move, host join via snapshot+tail, graceful leave — all
    bit-identical) -> capacity leg.  Every worker's positions are on
    `device` (cuda raises here, before any process starts, without a
    card).  Returns the combined verdict dict."""
    from dss_tpu_torch.ops.fastpath import resolve_device

    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    fixture = os.path.join(workdir, "fixture")
    os.makedirs(fixture, exist_ok=True)
    fx_log = os.path.join(workdir, "fixture.log")
    fx = _spawn(["--make_wal", fixture], fx_log)
    try:
        fx.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        fx.kill()
        fx.wait()
    if fx.returncode != 0:
        return {"ok": False, "stage": "fixture", "log": _tail(fx_log)}

    leg = {"reps": reps, "timeout_s": timeout_s, "device": device}
    total_devices = num_processes * devices_per_process
    ref = _run_leg(
        os.path.join(workdir, "ref"),
        fixture,
        1,
        devices_per_process=total_devices,  # same mesh shape, 1 process
        **leg,
    )
    if not ref["ok"]:
        return {"ok": False, "stage": "reference", **ref}
    multi = _run_leg(
        os.path.join(workdir, "multi"),
        fixture,
        num_processes,
        devices_per_process=devices_per_process,
        **leg,
    )
    if not multi["ok"]:
        return {"ok": False, "stage": "multi", **multi}
    bit_identical = (
        multi["leader"]["wave_a"] == ref["leader"]["wave_a"]
        and multi["leader"]["wave_b"] == ref["leader"]["wave_b"]
    )
    leg["reps"] = 1
    peer = _run_leg(
        os.path.join(workdir, "peerloss"),
        fixture,
        num_processes,
        devices_per_process=devices_per_process,
        peerloss=True,
        **leg,
    )
    pl = peer.get("leader", {})
    peerloss_ok = bool(
        peer["ok"]
        and pl.get("degraded")
        and pl.get("host_only_match")
        and pl.get("local_mesh_match")
    )
    out = {
        "ok": bool(bit_identical and peerloss_ok),
        "num_processes": num_processes,
        "devices_per_process": devices_per_process,
        "device": device,
        "bit_identical": bit_identical,
        "peerloss_ok": peerloss_ok,
        "reference": ref["leader"],
        "multi": multi["leader"],
        "peerloss": pl or {k: v for k, v in peer.items() if k != "leader"},
    }
    if elastic:
        # elasticity: a 3-slot world serving from 2 members — forced
        # hot-range boundary move, p2 joins via its lockstep tail
        # (snapshot+tail), then leaves again; every phase's answers
        # must match BOTH wave_b and the single-process run
        el = _run_leg(
            os.path.join(workdir, "elastic"),
            fixture,
            3,
            devices_per_process=devices_per_process,
            members="0,1",
            elastic=True,
            **leg,
        )
        ell = el.get("leader", {})
        hm, jn, lv = (
            ell.get("hotmove", {}), ell.get("join", {}), ell.get("leave", {})
        )
        elastic_ok = bool(
            el["ok"]
            and ell.get("wave_b") == ref["leader"]["wave_b"]
            and hm.get("match")
            and hm.get("boundary_moves", 0) >= 1
            and hm.get("imbalance_after", 1e9)
            < hm.get("imbalance_before", 0)
            and jn.get("match")
            and jn.get("post_join_match")
            and jn.get("post_join_moves", 0) >= 2
            and len(jn.get("members", [])) == 3
            and lv.get("match")
            and len(lv.get("members", [])) == 2
        )
        out["elastic_ok"] = elastic_ok
        out["elastic"] = ell or {
            k: v for k, v in el.items() if k != "leader"
        }
        out["ok"] = bool(out["ok"] and elastic_ok)
    if capacity:
        # heterogeneous hosts: process 1 declared at 40% capacity —
        # the weighted split hands it lighter key runs, a forced hot
        # move runs under those weights, and every answer stays
        # bit-identical to the homogeneous single-process run
        cap = _run_leg(
            os.path.join(workdir, "capacity"),
            fixture,
            num_processes,
            devices_per_process=devices_per_process,
            capacity=",".join(
                ["1.0"] + ["0.4"] * (num_processes - 1)
            ),
            **leg,
        )
        cw = cap.get("leader", {})
        cm = cw.get("capmove", {})
        capacity_ok = bool(
            cap["ok"]
            and cw.get("wave_a") == ref["leader"]["wave_a"]
            and cw.get("wave_b") == ref["leader"]["wave_b"]
            and cm.get("match")
            and cm.get("boundary_moves", 0) >= 1
        )
        out["capacity_ok"] = capacity_ok
        out["capacity"] = cw.get("capmove", cap.get("rcs"))
        if not cap["ok"]:
            out["capacity_log"] = cap["log_tail"]
        out["ok"] = bool(out["ok"] and capacity_ok)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--make_wal", default="", help="write the WAL fixture")
    ap.add_argument("--jax_coordinator", default="",
                    help="process 0's store address (port 0 on process 0 "
                    "binds a free port; see --port_file)")
    ap.add_argument("--port_file", default="",
                    help="process 0 writes its store's bound port here")
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--multihost_dryrun", type=int, default=2,
                    help="mesh positions per process, on --device")
    ap.add_argument(
        "--device", default="cuda",
        help="device of every worker's mesh positions (default cuda, "
        "which raises without a card; cpu runs the plain versions)",
    )
    ap.add_argument("--wal", default="")
    ap.add_argument("--wal_b", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--peerloss", action="store_true")
    ap.add_argument(
        "--members", default="",
        help="csv of initial serving-mesh member process ids (default "
        "all); non-members run standby, tailing the log until a join",
    )
    ap.add_argument(
        "--elastic", action="store_true",
        help="leader runs the elasticity schedule: forced hot-range "
        "boundary move, host join via snapshot+tail, graceful leave",
    )
    ap.add_argument(
        "--capacity", default="",
        help="csv of per-HOST capacity weights (one per process; the "
        "autotune profiles' capacity_weight scalars): the leader "
        "splits key runs proportionally and the leg asserts answers "
        "stay bit-identical with weights on",
    )
    ap.add_argument("--watchdog_interval", type=float, default=0.25)
    ap.add_argument("--watchdog_timeout", type=float, default=2.0)
    ap.add_argument(
        "--run", action="store_true",
        help="orchestrate the full dryrun and print its verdict",
    )
    args = ap.parse_args()
    if args.make_wal:
        make_wal(args.make_wal)
        return
    if args.run or not args.jax_coordinator:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="dss-mh-") as td:
            verdict = run_dryrun(td, device=args.device)
        print(json.dumps(verdict, indent=2)[:4000])
        sys.exit(0 if verdict.get("ok") else 1)
    worker(args)


if __name__ == "__main__":
    main()

"""The DSS server binary: flags, store bootstrap, auth setup, serve.

Collapses the reference's two processes (cmds/grpc-backend
RunGRPCServer, main.go:90-222 + cmds/http-gateway RunHTTPProxy) into
one REST server; the flag inventory mirrors grpc-backend main.go:42-73.

Run: python -m dss_tpu_torch.cmds.server --addr :8082 --enable_scd \
         --public_key_files build/test-certs/oauth.pem \
         --accepted_jwt_audiences localhost --storage cuda

A copy of the reference's `dss_tpu/cmds/server.py` in standalone mode,
with its read-worker fleet (`--workers N`), and in region mode
(`--region_url`: one instance of a DSS Region over a shared region log,
dss_tpu_torch/region; `--workers` stays standalone-only, as in the
reference), and federated (`--federation_map`: one region of several,
each owning a key range of the airspace, region/federation.py; refused
with `--workers`, as in the reference).
`--storage cuda` (the default) puts every entity class's tables on
`--device` (default `cuda`, which raises on a machine without a card;
`--device cpu` runs the plain versions).  `--device` and
`--virtual_devices N` (a mesh of N positions on `--device`) take the
place of the reference's JAX-only `--virtual_cpu_devices`.
`--sharded_replica dp,sp` keeps a sharded read replica of every entity
class on a (dp, sp) mesh, tailing the WAL or the region log
(parallel/replica.py).  With
`--workers N`
the leader is the one process that owns the card; its N read workers
run `--device cpu` (the reference pins them to JAX's CPU the same way),
so they create no CUDA context.  `--autotune_profile` seeds the
serving knobs from a profile measured by plan/autotune.py (on the card
unless `--device cpu`) before any store reads the environment, and
`--self_tune` arms the tune controller over the live stage histograms.
The multihost flags stay in the parser, and each exits naming its
slice when set (LATER_SLICE_FLAGS).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import threading
import time

from aiohttp import web

from dss_tpu_torch.api.app import RID_SCOPES, SCD_SCOPES, build_app
from dss_tpu_torch.auth.authorizer import (
    Authorizer,
    JWKSResolver,
    StaticKeyResolver,
)
from dss_tpu_torch.clock import Clock
from dss_tpu_torch.dar.dss_store import DSSStore
from dss_tpu_torch.services.rid import RIDService
from dss_tpu_torch.services.scd import SCDService


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DSS server (PyTorch/CUDA)")
    p.add_argument("--addr", default=":8082", help="address to listen on")
    p.add_argument(
        "--storage",
        default="cuda",
        choices=["memory", "cuda"],
        help="spatial index backend (memory = host linear scan)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device of the cuda backend's tables: cuda (the "
        "default; raises without a card) or cpu (the kernels' plain "
        "versions)",
    )
    p.add_argument(
        "--wal_path", default="", help="write-ahead log file (durability)"
    )
    p.add_argument("--wal_fsync", action="store_true")
    p.add_argument("--enable_scd", action="store_true")
    p.add_argument(
        "--public_key_files",
        default="",
        help="comma-separated PEM files with JWT verification keys",
    )
    p.add_argument("--jwks_endpoint", default="")
    p.add_argument("--jwks_key_ids", default="")
    p.add_argument(
        "--key_refresh_timer",
        type=float,
        default=0.0,
        help="seconds between JWKS refreshes (0 = no refresh)",
    )
    p.add_argument(
        "--accepted_jwt_audiences",
        default="",
        help="comma-separated accepted `aud` claims",
    )
    p.add_argument(
        "--insecure_no_auth",
        action="store_true",
        help="disable auth entirely (local testing only)",
    )
    p.add_argument(
        "--dump_requests",
        action="store_true",
        help="log request bodies (reference --dump_requests)",
    )
    p.add_argument(
        "--trace_requests",
        action="store_true",
        help="per-request tracing: X-Request-Id propagation + "
        "auth/service stage timings in the access log (reference "
        "--trace-requests, pkg/logging/http.go:36-55)",
    )
    p.add_argument(
        "--profile_dir",
        default="",
        help="enable POST /debug/profile?seconds=N: write a "
        "torch.profiler Chrome trace (host ops, and CUDA kernels and "
        "copies on a card) into this directory under live traffic "
        "(reference --gcp_prof_service_name analog)",
    )
    p.add_argument(
        "--autotune_profile",
        default=os.environ.get("DSS_AUTOTUNE_PROFILE", ""),
        help="autotune profile JSON (dss_tpu_torch/plan/autotune.py, "
        "deploy/autotune/<host-class>.json) seeding the serving knobs "
        "at boot; env > profile > defaults.  Env fallback "
        "DSS_AUTOTUNE_PROFILE",
    )
    p.add_argument(
        "--self_tune",
        action="store_true",
        default=os.environ.get("DSS_TUNE", "0").lower()
        in ("1", "true", "yes", "on"),
        help="arm the self-tuning controller (dss_tpu_torch/tune): "
        "observe the live stage histograms, propose within step "
        "limits, shadow-replay the recorded decisions, apply under a "
        "guard window with automatic rollback (DSS_TUNE_* knobs).  "
        "Env fallback DSS_TUNE",
    )
    p.add_argument(
        "--region_url",
        default="",
        help="region log server URL(s), comma-separated primary + "
        "mirrors for failover (python -m "
        "dss_tpu_torch.cmds.region_server, or the reference's).  When "
        "set, this instance joins a multi-instance DSS Region: writes "
        "go through the shared region log and remote writes are "
        "tail-applied.  Mutually exclusive with --wal_path",
    )
    p.add_argument(
        "--region_token_file",
        default="",
        help="file holding the shared region secret (env "
        "DSS_REGION_TOKEN overrides)",
    )
    p.add_argument(
        "--region_poll_interval",
        type=float,
        default=0.05,
        help="seconds between region log tail polls (read staleness "
        "bound on non-writing instances)",
    )
    p.add_argument(
        "--region_snapshot_every",
        type=int,
        default=512,
        help="upload a state snapshot to the region log every N "
        "applied entries; the log compacts below it, bounding "
        "late-join/recovery cost",
    )
    p.add_argument(
        "--instance_id",
        default="",
        help="stable identity of this DSS instance within the region",
    )
    p.add_argument(
        "--federation_map",
        default=os.environ.get("DSS_FED_MAP", ""),
        help="path to the format-versioned multi-region federation "
        "map (S2-key-range -> region ownership + peer URLs, "
        "region/federation.py).  Joins this region to the federation: "
        "locality routing serves owned coverings locally, fans "
        "cross-region slices out to peers, and serves bounded-stale "
        "follower reads during partitions.  Env fallback DSS_FED_MAP; "
        "DSS_FED_* knobs in the README",
    )
    p.add_argument(
        "--federation_region",
        default=os.environ.get("DSS_FED_REGION", ""),
        help="this deployment's region id in the federation map "
        "(overrides the map's 'local' field; env DSS_FED_REGION)",
    )
    p.add_argument(
        "--push",
        action="store_true",
        default=os.environ.get("DSS_PUSH", "") == "1",
        help="attach the reverse-query push pipeline: subscription "
        "matches ride the planner's rqmatch route and matched writes "
        "are delivered to registered webhooks (/aux/v1/push/*; "
        "DSS_PUSH_* knobs).  Env fallback DSS_PUSH=1",
    )
    p.add_argument(
        "--virtual_devices",
        type=int,
        default=0,
        help="let the sharded replica's mesh hold N positions, all on "
        "--device (one card runs a 2x4 mesh shard after shard; the "
        "port's form of the reference's --virtual_cpu_devices).  0 = "
        "one position per device",
    )
    p.add_argument(
        "--jax_coordinator",
        default="",
        help="process 0's coordination address: join a process-"
        "spanning mesh (multihost slice).  Env fallback "
        "DSS_JAX_COORDINATOR",
    )
    p.add_argument("--process_id", type=int, default=None,
                   help="index in the multi-host mesh (multihost slice; "
                   "env DSS_PROCESS_ID)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes in the multi-host mesh (multihost "
                   "slice; env DSS_NUM_PROCESSES)")
    p.add_argument("--multihost_dryrun", type=int, default=0,
                   help="the multi-host path on the CPU (multihost "
                   "slice; env DSS_MULTIHOST_DRYRUN)")
    p.add_argument(
        "--sharded_replica",
        default="",
        help="'dp,sp' mesh shape: serve sharded ShardedDar read "
        "replicas of ALL entity classes (SCD operations, constraints "
        "and subscriptions, RID ISAs and subscriptions), refreshed "
        "from the WAL; oversized bounded-staleness search batches "
        "offload to the mesh, and /aux/v1/replica/<surface> serves "
        "each class directly.  Needs --wal_path",
    )
    p.add_argument(
        "--replica_refresh_interval",
        type=float,
        default=0.5,
        help="seconds between replica log polls / snapshot rebuilds",
    )
    p.add_argument(
        "--no_shard_rebalance",
        action="store_true",
        help="pin the sharded replica to the static equal-count "
        "postings split: disable the load-weighted boundary search "
        "(equivalent to DSS_SHARD_REBALANCE_RATIO=0)",
    )
    p.add_argument(
        "--workers",
        type=int,
        default=0,
        help="spawn N read-worker processes sharing the listen port "
        "via SO_REUSEPORT: the leader owns the card + all mutations "
        "(journaled to the WAL), workers serve searches over the "
        "shared-memory ring to the leader (DSS_SHM_ENABLE=0: from a "
        "WAL-tail replica) and proxy everything else to the leader.  "
        "Workers run --device cpu.  0 = single process.  Standalone "
        "mode only.",
    )
    p.add_argument(
        "--worker_reader",
        action="store_true",
        help=argparse.SUPPRESS,  # internal: this process is a read worker
    )
    p.add_argument(
        "--leader_url",
        default="",
        help=argparse.SUPPRESS,  # internal: leader base URL for proxying
    )
    p.add_argument(
        "--shm_region",
        default="",
        help=argparse.SUPPRESS,  # internal: shared-memory ring region path
    )
    p.add_argument(
        "--shm_worker_index",
        type=int,
        default=-1,
        help=argparse.SUPPRESS,  # internal: this worker's ring index
    )
    p.add_argument(
        "--follower_poll_interval",
        type=float,
        default=0.02,
        help="read-worker WAL tail interval in seconds (staleness bound)",
    )
    p.add_argument(
        "--no_warmup",
        action="store_true",
        help="skip the background kernel build and graph warm at "
        "startup",
    )
    p.add_argument(
        "--no_resident",
        action="store_true",
        help="disable the resident serving kernel (ops/resident.py): "
        "the persistent device-feeder loop replaying captured CUDA "
        "graphs of shape buckets, which amortizes the device dispatch "
        "floor across in-flight batches.  On by default for --storage "
        "cuda; the deadline router then learns a separate resident "
        "floor (DSS_CO_EST_RES_FLOOR_MS seed) and routes device-class "
        "batches through the loop",
    )
    p.add_argument(
        "--inline_reads",
        default="auto",
        choices=["auto", "on", "off"],
        help="run read handlers directly on the event loop instead of "
        "the thread-pool executor.  'auto' enables it on single-core "
        "hosts, where the two executor handoffs are pure overhead "
        "(reads are lock-free and sub-millisecond)",
    )
    p.add_argument(
        "--default_timeout",
        type=float,
        default=10.0,
        help="per-request deadline in seconds; exceeding it returns 504 "
        "(reference: 10s default RPC timeout, grpc-backend main.go:48). "
        "0 disables.",
    )
    p.add_argument(
        "--shutdown_grace",
        type=float,
        default=25.0,
        help="seconds SIGTERM waits for in-flight requests to complete "
        "before closing connections (reference: GracefulStop, "
        "grpc-backend main.go:217-221)",
    )
    p.add_argument(
        "--tls_cert",
        default="",
        help="TLS certificate chain (PEM) — serve HTTPS directly "
        "(deploy/make_certs.py emits server.crt/server.key; leave "
        "unset when an ingress/mesh terminates TLS)",
    )
    p.add_argument(
        "--tls_key",
        default="",
        help="TLS private key (PEM); required with --tls_cert",
    )
    return p


def build_worker(args) -> web.Application:
    """A read worker: searches ride the shm ring to the leader (or, with
    DSS_SHM_ENABLE=0, scan the local WAL-tail replica); every other
    route proxies to the leader.  Runs on the CPU (`--device cpu` from
    _forward_args): the leader owns the card, and the worker's replica
    only assembles records and serves the proxy fallback."""
    from dss_tpu_torch.api.app import make_worker_proxy_middleware
    from dss_tpu_torch.dar.follower import WalFollower
    from dss_tpu_torch.obs.logging import configure_logging, get_logger
    from dss_tpu_torch.obs.metrics import MetricsRegistry

    configure_logging()
    log = get_logger("dss.worker")
    if not args.wal_path or not args.leader_url:
        raise SystemExit("--worker_reader needs --wal_path and --leader_url")
    if args.federation_map:
        raise SystemExit(
            "--worker_reader cannot serve a federated region (see the"
            " --federation_map/--workers refusal in the leader)"
        )
    device = None
    if args.storage == "cuda":
        from dss_tpu_torch.ops.fastpath import resolve_device

        device = resolve_device(args.device)
    clock = Clock()
    store = DSSStore(storage=args.storage, clock=clock, device=device)
    follower = WalFollower(
        store, args.wal_path, interval_s=args.follower_poll_interval
    )
    follower.start()
    log.info(
        "read worker up: replica from %s every %.0f ms on %s, leader %s",
        args.wal_path, args.follower_poll_interval * 1000,
        device if device is not None else "-", args.leader_url,
    )
    rid_store, scd_store = store.rid, store.scd
    front = None
    if args.shm_region:
        # shared-memory serving front (parallel/shmring.py): searches
        # ride the query ring to the device owner — with a worker-
        # local version-fenced read cache answering repeat polls in
        # microseconds — instead of re-scanning the WAL-tail replica.
        # The replica stays: record assembly + proxy-fallback serving.
        from dss_tpu_torch.dar.shmfront import (
            ShmRIDStore, ShmSCDStore, ShmSearchFront,
        )
        from dss_tpu_torch.parallel import shmring

        region = shmring.ShmRegion.open_existing(args.shm_region)
        client = shmring.ShmWorkerClient(
            region, args.shm_worker_index
        )
        front = ShmSearchFront(
            region, client, follower, clock,
            catchup_s=float(os.environ.get("DSS_SHM_CATCHUP_S", 1.0)),
            owner_ttl_s=float(
                os.environ.get("DSS_SHM_OWNER_TTL_S", 5.0)
            ),
            owner_threads=int(
                os.environ.get("DSS_SHM_OWNER_THREADS", 0)
            ) or min(4, max(2, os.cpu_count() or 2)),
        )
        rid_store = ShmRIDStore(store.rid, front)
        scd_store = ShmSCDStore(store.scd, front)
        log.info(
            "shm front: worker %d of %d on %s (depth %d, slot %d B)",
            args.shm_worker_index, region.nworkers, args.shm_region,
            region.depth, region.slot_bytes,
        )
    rid = RIDService(rid_store, clock)
    scd = SCDService(scd_store, clock) if args.enable_scd else None
    authorizer = _make_authorizer(args)
    metrics = MetricsRegistry(
        proc=f"worker-{args.shm_worker_index}:{os.getpid()}"
        if args.shm_region else f"worker:{os.getpid()}"
    )
    if front is not None:
        # per-stage histograms across the whole front: this worker's
        # stage observations land in its shared block, and its
        # /metrics renders the MERGED dss_stage_duration_seconds
        # family (any process's scrape shows the front's tails)
        from dss_tpu_torch.parallel.shmring import (
            StageHistWriter, shm_stage_hist,
        )

        metrics.attach_stage_writer(
            StageHistWriter(front.region, args.shm_worker_index)
        )
        metrics.set_stage_agg(
            lambda _r=front.region: shm_stage_hist(_r)
        )
    from dss_tpu_torch.build_info import build_info

    metrics.set_info("dss_build_info", build_info())

    def stats_fn():
        out = store.stats()
        out.update(follower.stats())
        if front is not None:
            out.update(front.stats())
        return out

    app = build_app(
        rid,
        scd,
        authorizer,
        enable_scd=args.enable_scd,
        metrics=metrics,
        dump_requests=args.dump_requests,
        stats_fn=stats_fn,
        status_fn=store.freshness_status,
        health_fn=store.health.mode_name,
        default_timeout_s=args.default_timeout,
        trace_requests=args.trace_requests,
        # shm-front workers run optimistic inline reads regardless of
        # core count: a worker-cache hit is microseconds on the event
        # loop, and the front raises NeedsDevice before anything that
        # blocks (ring round trip, replica catchup) so misses re-run
        # on the executor — see ShmSearchFront.serve
        inline_reads=(
            args.inline_reads != "off" if args.shm_region
            else _inline_reads(args)
        ),
        worker_proxy=make_worker_proxy_middleware(
            args.leader_url, follower=follower,
            costs=front.costs if front is not None else None,
        ),
    )
    app["dss_store"] = store

    async def _close_replica(app):
        # stop the tail and the replica's coalescers before the
        # interpreter exits, so no daemon thread is inside a torch call
        # then (as the leader's _close_store does)
        def close():
            follower.close()
            if front is not None:
                front.client.close()
            store.close()

        await asyncio.get_running_loop().run_in_executor(None, close)

    app.on_cleanup.append(_close_replica)
    # the worker's boot heap is the initially-replayed WAL; tail
    # records arriving later stay in normal generations
    from dss_tpu_torch.runtime import freeze_boot_heap

    freeze_boot_heap()
    return app


def _inline_reads(args) -> bool:
    if args.inline_reads == "on":
        return True
    if args.inline_reads == "off":
        return False
    return (os.cpu_count() or 2) == 1


def _make_authorizer(args):
    if args.insecure_no_auth:
        return None
    if args.public_key_files:
        resolver = StaticKeyResolver.from_files(
            [f for f in args.public_key_files.split(",") if f]
        )
    elif args.jwks_endpoint:
        resolver = JWKSResolver(
            args.jwks_endpoint,
            [k for k in args.jwks_key_ids.split(",") if k] or None,
        )
    else:
        raise SystemExit(
            "one of --public_key_files / --jwks_endpoint is required "
            "(or --insecure_no_auth)"
        )
    audiences = [a for a in args.accepted_jwt_audiences.split(",") if a]
    if not audiences:
        raise SystemExit(
            "--accepted_jwt_audiences is required when auth is enabled "
            "(every token would be rejected otherwise)"
        )
    scopes = dict(RID_SCOPES)
    scopes.update(SCD_SCOPES)
    return Authorizer(
        resolver,
        audiences=audiences,
        scopes_table=scopes,
        refresh_interval_s=args.key_refresh_timer or None,
    )


# flag -> (its value when unset, the slice of the port that brings it).
# The process-spanning mesh is also entered through
# DSS_JAX_COORDINATOR, as in the reference.
LATER_SLICE_FLAGS = {
    "jax_coordinator": ("", "multihost"),
    "process_id": (None, "multihost"),
    "num_processes": (None, "multihost"),
    "multihost_dryrun": (0, "multihost"),
}


def refuse_later_slices(args) -> None:
    """SystemExit naming the slice of the first flag that a later slice
    of the port brings (the port serves standalone and region mode,
    federated or not, with or without its read-worker fleet, its
    single-process mesh and its tuner)."""
    if os.environ.get("DSS_JAX_COORDINATOR"):
        args.jax_coordinator = os.environ["DSS_JAX_COORDINATOR"]
    for flag, (unset, slice_) in LATER_SLICE_FLAGS.items():
        if getattr(args, flag) != unset:
            raise SystemExit(
                f"--{flag} is not ported yet; it comes with the {slice_} "
                "slice of the PyTorch/CUDA port (standalone, region "
                "and federated mode, the single-process mesh and the "
                "tuner only)"
            )


def mesh_devices(args) -> list:
    """The positions a `--sharded_replica` mesh may take: N on
    `--device` with `--virtual_devices N`, else one per device (every
    card for `cuda`; the one CPU for `cpu`)."""
    from dss_tpu_torch.ops.fastpath import resolve_device
    from dss_tpu_torch.parallel.mesh import local_devices, virtual_devices

    dev = resolve_device(args.device)
    if args.virtual_devices:
        return virtual_devices(dev, args.virtual_devices)
    if dev.type == "cuda" and dev.index is None:
        return local_devices()
    return [dev]


def region_token(args) -> str:
    """The shared region secret: DSS_REGION_TOKEN, else
    --region_token_file; "" for none."""
    token = os.environ.get("DSS_REGION_TOKEN", "")
    if not token and args.region_token_file:
        with open(args.region_token_file, "r", encoding="utf-8") as fh:
            token = fh.read().strip()
    return token


def make_replica(args, store, log):
    """`--sharded_replica dp,sp`: a ShardedReplica of every entity class
    tailing `--wal_path` or the region log of `--region_url` on a (dp,
    sp) mesh, refreshing in the background and attached to the store's
    coalescers; None without the flag."""
    if not args.sharded_replica:
        return None
    from dss_tpu_torch.parallel.mesh import make_mesh
    from dss_tpu_torch.parallel.replica import ShardedReplica

    try:
        dp, sp = (int(x) for x in args.sharded_replica.split(","))
    except ValueError:
        raise SystemExit(
            f"--sharded_replica must be 'dp,sp' (got "
            f"{args.sharded_replica!r})"
        )
    region_client = None
    if args.region_url:
        from dss_tpu_torch.region.client import RegionClient

        region_client = RegionClient(
            args.region_url,
            (args.instance_id or "dss") + "-replica",
            auth_token=region_token(args) or None,
        )
    elif not args.wal_path:
        raise SystemExit(
            "--sharded_replica needs --wal_path or --region_url "
            "(a log to tail)"
        )
    devs = mesh_devices(args)
    if len(devs) < dp * sp:
        raise SystemExit(
            f"--sharded_replica {dp},{sp} needs {dp * sp} devices, have "
            f"{len(devs)} (--virtual_devices N gives N positions on "
            "--device)"
        )
    mesh = make_mesh(dp * sp, dp=dp, sp=sp, devices=devs)
    # every bucket a mesh-offloaded chunk can land in (chunks are
    # <= 64; remainders bucket to 16/32): the first offload after a
    # swap finds its kernels loaded
    replica = ShardedReplica(
        mesh, wal_path=None if region_client else args.wal_path,
        region_client=region_client, warm_batches=(1, 32, 64),
    )
    if args.no_shard_rebalance:
        replica.rebalance_ratio = 0.0
    replica.start(args.replica_refresh_interval)
    # oversized bounded-staleness search batches ride the mesh
    store.attach_mesh_replica(replica)
    log.info(
        "sharded replica serving all entity classes on a %dx%d mesh "
        "over %s (%s)", dp, sp, mesh.distinct_devices(),
        "region log" if args.region_url else "wal",
    )
    return replica


def build(args) -> web.Application:
    from dss_tpu_torch.obs.logging import configure_logging, get_logger
    from dss_tpu_torch.obs.metrics import MetricsRegistry

    refuse_later_slices(args)
    if args.worker_reader:
        return build_worker(args)
    if args.federation_map and args.workers > 0:
        # worker readers serve searches from a plain WAL-tail replica
        # with no federation layer: a cross-region covering landing on
        # a worker would return a silently PARTIAL answer, and peer
        # federation calls would 404.  Refuse the combination (before
        # the store boots) until workers grow federation-aware routing.
        raise SystemExit(
            "--federation_map with --workers > 0 is not supported yet:"
            " read workers would serve cross-region coverings"
            " partially; run federated instances single-process"
        )

    configure_logging()
    log = get_logger("dss.server")
    from dss_tpu_torch.build_info import build_info

    log.info("build: %s", build_info())
    device = None
    if args.storage == "cuda":
        # the port's device rule: a cuda device without a card raises
        from dss_tpu_torch.ops.fastpath import resolve_device

        device = resolve_device(args.device)
    clock = Clock()
    token = region_token(args)
    store = DSSStore(
        storage=args.storage,
        clock=clock,
        wal_path=args.wal_path or None,
        wal_fsync=args.wal_fsync,
        device=device,
        region_url=args.region_url or None,
        region_token=token or None,
        region_poll_interval_s=args.region_poll_interval,
        region_snapshot_every=args.region_snapshot_every,
        instance_id=args.instance_id or None,
    )
    log.info(
        "store ready: storage=%s device=%s wal=%s scd=%s region=%s",
        args.storage,
        device if device is not None else "-",
        args.wal_path or "(none)",
        args.enable_scd,
        args.region_url or "(standalone)",
    )
    log.info(
        "read cache: %s (cap=%d entries, stale_lag=%d gens; "
        "DSS_CACHE_* / configure_serving(cache=) to change)",
        "enabled" if store.cache.enabled else "disabled",
        store.cache.capacity,
        store.cache.stale_lag,
    )
    from dss_tpu_torch import native

    log.info(
        "native host halves: %s (inline reads %s)",
        "loaded" if native.available() else "not built yet (numpy)",
        "on" if _inline_reads(args) else "off",
    )
    fed_router = None
    if args.federation_map:
        # multi-region federation: attach BEFORE building services so
        # they see the federated store wrappers (locality routing +
        # ownership-guarded writes + bounded-stale remote reads)
        from dss_tpu_torch.region import federation as fedmod

        fmap = fedmod.FederationMap.load(
            args.federation_map, local=args.federation_region or None
        )
        fed_router = fedmod.FederationRouter.from_map(
            fmap,
            token=os.environ.get("DSS_FED_TOKEN") or None,
            **fedmod.env_knobs(),
        )
        store.attach_federation(fed_router)
        log.info(
            "federation: region %s of %s (stale lag bound %.1fs, "
            "sync every %.2fs)",
            fmap.local, fmap.region_ids, fed_router.stale_lag_s,
            fed_router.sync_interval_s,
        )
    rid = RIDService(store.rid, clock)
    scd = SCDService(store.scd, clock) if args.enable_scd else None

    # resident serving route: on by default on the cuda backend — the
    # coalescers grow the persistent device-feeder route and install
    # fold-time graph warm hooks; the bucket-grid boot warm runs on the
    # warm thread below so captures never race a request deadline
    use_resident = args.storage == "cuda" and not args.no_resident
    if use_resident:
        store.configure_serving(resident=True)

    warm_thread = None
    if args.storage == "cuda" and not args.no_warmup:
        # build the kernels and run the first device-path shapes in the
        # background, so the first real request after boot does not
        # pay the nvcc build inside its deadline (an early request
        # waits on the same in-flight build — never a double build)
        from dss_tpu_torch.ops import resident as _resident
        from dss_tpu_torch.ops.fastpath import warmup as _fastpath_warmup

        def _warm():
            try:
                t0 = time.perf_counter()
                _fastpath_warmup(device)
                log.info(
                    "fastpath warmup done in %.1fs",
                    time.perf_counter() - t0,
                )
            except Exception:  # noqa: BLE001 — warmup is best-effort
                log.exception("fastpath warmup failed")
            if use_resident:
                cache = _resident.graph_cache()
                try:
                    t0 = time.perf_counter()
                    n = store.warm_resident()
                    log.info(
                        "resident graph warm: %d entries in %.1fs "
                        "(cache %d of cap %d, %d reserved; %d capture "
                        "failures)",
                        n, time.perf_counter() - t0, cache.size(),
                        cache.cap(), cache.reserved(),
                        cache.capture_failures,
                    )
                except Exception:  # noqa: BLE001 — best-effort
                    log.exception(
                        "resident warm failed (%d capture failures)",
                        cache.capture_failures,
                    )

        warm_thread = threading.Thread(
            target=_warm, name="fastpath-warmup", daemon=True
        )
        warm_thread.start()

    authorizer = _make_authorizer(args)

    metrics = MetricsRegistry(
        proc=f"leader:{os.getpid()}" if args.workers > 0 else None
    )
    metrics.set_info("dss_build_info", build_info())

    replica = make_replica(args, store, log)

    push = None
    if args.push:
        from dss_tpu_torch.push import PushPipeline
        from dss_tpu_torch.push.pipeline import env_knobs as _push_knobs

        push = PushPipeline(metrics=metrics, **_push_knobs())
        store.attach_push(push)
        log.info(
            "push pipeline: %d delivery workers, queue bound %d, log "
            "%s (DSS_PUSH_* knobs)",
            push.pool._workers, push.log.max_depth,
            os.environ.get("DSS_PUSH_LOG") or "(in-memory)",
        )

    def stats_fn():
        out = store.stats()
        if replica is not None:
            out.update(replica.stats())
        return out

    app = build_app(
        rid,
        scd,
        authorizer,
        enable_scd=args.enable_scd,
        metrics=metrics,
        dump_requests=args.dump_requests,
        stats_fn=stats_fn,
        status_fn=store.freshness_status,
        health_fn=store.health.mode_name,
        default_timeout_s=args.default_timeout,
        replica=replica,
        federation=fed_router,
        push=push,
        trace_requests=args.trace_requests,
        profile_dir=args.profile_dir,
        inline_reads=_inline_reads(args),
        # workers wait on this seq for read-your-writes after a
        # proxied mutation
        wal_seq_fn=(lambda: store.wal.seq) if args.workers > 0 else None,
    )
    # main() attaches the shared-memory front to the store (workers
    # mode) after the listen sockets exist
    app["dss_store"] = store
    app["dss_metrics"] = metrics

    async def _close_store(app):
        # after the graceful stop: let the boot warm finish, then stop
        # the push delivery workers, folds, coalescers and resident
        # loops (store.close, push first), so that no daemon thread is
        # inside a torch call when the interpreter exits (it would
        # abort the process: "terminate called without an active
        # exception"); the federation's sync thread and the replica's
        # tail stop first
        def close():
            if fed_router is not None:
                fed_router.close()
            if replica is not None:
                replica.close()
            if warm_thread is not None:
                warm_thread.join(args.shutdown_grace)
            store.close()

        await asyncio.get_running_loop().run_in_executor(None, close)
        r = app["dss_read_routes"]
        log.info(
            "reads: %d inline on the event loop, %d re-run on the "
            "executor (NeedsDevice), %d on the executor",
            r["inline"], r["rerun"], r["executor"],
        )

    app.on_cleanup.append(_close_store)

    # autotune profile provenance (satellite of the self-tuning loop):
    # stable gauge whether or not a profile was loaded — 0.0 means
    # "no profile or no timestamp", the alertable case is large
    metrics.set_gauge(
        "dss_autotune_profile_age_s",
        float(getattr(args, "_autotune_profile_age_s", 0.0)),
    )

    if args.self_tune:
        from dss_tpu_torch import tune as _tune

        tune_cfg = _tune.env_knobs()

        def _tune_actuator(kn, _store=store):
            _store.configure_serving(**{
                _tune.KNOB_TO_CONFIGURE[k]: v for k, v in kn.items()
            })

        controller = _tune.TuneController(
            # late-binds the shm whole-front aggregate: main() wires
            # set_stage_agg after the listen sockets exist
            hist_provider=metrics.stage_hist_front,
            actuator=_tune_actuator,
            current_fn=store.tune_knob_values,
            interval_s=tune_cfg["interval_s"],
            guard_s=tune_cfg["guard_s"],
            min_count=tune_cfg["min_count"],
            deadband=tune_cfg["deadband"],
            p99_tol=tune_cfg["p99_tol"],
            rollback_frac=tune_cfg["rollback_frac"],
            ring=tune_cfg["ring"],
            profile_seeded=getattr(
                args, "_autotune_profile_seeded", ()
            ),
            device=args.device,
        )
        store.attach_tuner(controller)
        log.info(
            "self-tuning armed: interval %.0fs, guard %.0fs, "
            "min_count %d, deadband %.0f%%, rollback at %.2fx p99 "
            "(DSS_TUNE_* knobs in OPERATIONS.md; freeze with "
            "store.tune.freeze() or a DSS_TUNE=0 restart)",
            tune_cfg["interval_s"], tune_cfg["guard_s"],
            tune_cfg["min_count"], 100.0 * tune_cfg["deadband"],
            tune_cfg["rollback_frac"],
        )

    from dss_tpu_torch.obs import trace as _trace

    if _trace.enabled():
        cfg = _trace.env_config()
        log.info(
            "tracing: sample=%g slow_ms=%g ring=%d "
            "(/aux/v1/debug/traces; DSS_TRACE_* in OPERATIONS.md)",
            cfg["sample"], cfg["slow_ms"], cfg["ring"],
        )

    # park the boot heap outside GC scans once boot actually finishes:
    # after the background warm (its buffers are part of the boot
    # heap; freezing mid-warm would pin transients instead) and after
    # the sharded replica's first full log sync (its record maps are
    # the largest heap in replica mode).  When neither is pending the
    # freeze runs synchronously, before serving.
    from dss_tpu_torch.runtime import freeze_boot_heap

    def _freeze_after_boot():
        if warm_thread is not None:
            warm_thread.join()
        if replica is not None:
            deadline = time.monotonic() + 300.0
            while (
                replica.staleness_s() == float("inf")
                and time.monotonic() < deadline
            ):
                time.sleep(0.5)
        # a handful of requests may be in flight by now; collect()
        # first so only their live frames (bounded, one-time) can pin
        freeze_boot_heap()

    if warm_thread is None and replica is None:
        freeze_boot_heap()
    else:
        threading.Thread(
            target=_freeze_after_boot, name="gc-freeze", daemon=True
        ).start()
    return app


def _public_socket(addr: str, reuse_port: bool):
    import socket

    host, _, port = addr.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuse_port:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host or "0.0.0.0", int(port)))
    s.listen(1024)
    return s


def _watch_parent():
    """Read workers exit when the leader dies (no orphaned listeners
    competing on the port)."""
    parent = os.getppid()

    def loop():
        while True:
            if os.getppid() != parent:
                os._exit(0)
            time.sleep(1.0)

    threading.Thread(target=loop, name="parent-watch", daemon=True).start()


def _forward_args(args, leader_url: str, worker_index: int = -1):
    """argv for a read-worker child.  Every child runs `--device cpu`:
    the leader is the one process that owns the card."""
    out = [
        "--worker_reader",
        "--leader_url", leader_url,
        "--addr", args.addr,
        "--storage", args.storage,
        "--device", "cpu",
        "--wal_path", args.wal_path,
        "--default_timeout", str(args.default_timeout),
        "--shutdown_grace", str(args.shutdown_grace),
        "--follower_poll_interval", str(args.follower_poll_interval),
        "--inline_reads", args.inline_reads,
    ]
    if getattr(args, "_shm_path", ""):
        out += [
            "--shm_region", args._shm_path,
            "--shm_worker_index", str(worker_index),
        ]
    if args.enable_scd:
        out.append("--enable_scd")
    if args.insecure_no_auth:
        out.append("--insecure_no_auth")
    if args.public_key_files:
        out += ["--public_key_files", args.public_key_files]
    if args.jwks_endpoint:
        out += ["--jwks_endpoint", args.jwks_endpoint]
    if args.jwks_key_ids:
        out += ["--jwks_key_ids", args.jwks_key_ids]
    if args.key_refresh_timer:
        out += ["--key_refresh_timer", str(args.key_refresh_timer)]
    if args.accepted_jwt_audiences:
        out += ["--accepted_jwt_audiences", args.accepted_jwt_audiences]
    if args.dump_requests:
        out.append("--dump_requests")
    if args.trace_requests:
        out.append("--trace_requests")
    return out


def load_autotune_profile(args) -> None:
    """Seed serving knobs from the measured host profile BEFORE any
    store or coalescer reads the environment (env > profile > defaults;
    --workers children inherit the seeded environment), warn on a
    host-class mismatch or an old or unstamped profile, and leave the
    profile's age and seeded keys on `args` for build() (the
    dss_autotune_profile_age_s gauge and the tuner's precedence:
    profile-seeded keys stay proposable).  The host class compared is
    that of --device."""
    from dss_tpu_torch.obs.logging import get_logger
    from dss_tpu_torch.plan import autotune as _autotune

    profile = _autotune.load_profile(args.autotune_profile)
    applied = _autotune.apply_profile(profile)
    plog = get_logger("dss.server")
    plog.info(
        "autotune profile %s (host class %s): seeded %s",
        args.autotune_profile,
        profile.get("host_class", "?"),
        ", ".join(f"{k}={v}" for k, v in sorted(applied.items()))
        or "nothing (env overrides everything)",
    )
    stale = _autotune.profile_staleness(profile, device=args.device)
    if not stale["host_class_match"]:
        plog.warning(
            "AUTOTUNE PROFILE HOST-CLASS MISMATCH: profile measured on "
            "%r, this host is %r — the seeded cost models describe a "
            "DIFFERENT machine; re-run plan/autotune.autotune() here "
            "(or arm --self_tune to converge live)",
            stale["profile_host_class"], stale["host_class"],
        )
    if not stale["has_timestamp"]:
        plog.warning(
            "autotune profile %s has no measured_at timestamp "
            "(pre-provenance format): age unknown, treating as fresh; "
            "re-run plan/autotune.autotune() to stamp it",
            args.autotune_profile,
        )
    elif stale["age_s"] > 30 * 86400.0:
        plog.warning(
            "autotune profile %s is %.0f days old: the measured cost "
            "models may no longer describe this host; re-run "
            "plan/autotune.autotune()",
            args.autotune_profile, stale["age_s"] / 86400.0,
        )
    args._autotune_profile_age_s = stale["age_s"]
    args._autotune_profile_seeded = tuple(sorted(applied))


def main():
    import atexit
    import shutil
    import socket
    import subprocess
    import sys
    import tempfile

    args = make_parser().parse_args()
    refuse_later_slices(args)  # before anything boots

    if args.autotune_profile:
        load_autotune_profile(args)

    from dss_tpu_torch.cmds import make_ssl_context

    ssl_ctx = make_ssl_context(args.tls_cert, args.tls_key)

    if args.worker_reader:
        _watch_parent()
        app = build(args)
        sock = _public_socket(args.addr, reuse_port=True)
        web.run_app(
            app,
            sock=sock,
            shutdown_timeout=args.shutdown_grace,
            ssl_context=ssl_ctx,
        )
        return

    if args.workers > 0:
        if args.region_url:
            raise SystemExit(
                "--workers is standalone-only (region instances already "
                "scale horizontally; run more instances instead)"
            )
        if ssl_ctx is not None:
            raise SystemExit(
                "--tls_cert is single-process only: the worker fleet "
                "shares one leader loopback that must stay plaintext — "
                "terminate TLS at the ingress for --workers deployments"
            )
        if not args.wal_path:
            args.wal_path = os.path.join(
                tempfile.mkdtemp(prefix="dss-wal-"), "wal.jsonl"
            )
        # shared-memory serving front (parallel/shmring.py), on by
        # default: the region file must exist BEFORE workers boot.
        # DSS_SHM_ENABLE=0 falls back to plain WAL-tail workers.
        from dss_tpu_torch.dar.coalesce import _env_bool
        from dss_tpu_torch.parallel import shmring

        shm_raw = os.environ.get("DSS_SHM_ENABLE")
        shm_enable = True if shm_raw is None else _env_bool(shm_raw)
        shm_dir = shm_path = ""
        region = None
        if shm_enable:
            shm_dir = tempfile.mkdtemp(prefix="dss-shm-")
            shm_path = os.path.join(shm_dir, "ring.shm")
            region = shmring.ShmRegion.create(
                shm_path, nworkers=args.workers, **shmring.env_knobs()
            )
        args._shm_path = shm_path
        app = build(args)
        owner = None
        if region is not None:
            owner = app["dss_store"].attach_shm_front(
                region,
                threads=int(
                    os.environ.get("DSS_SHM_OWNER_THREADS", 0)
                ) or None,
                worker_ttl_s=float(
                    os.environ.get("DSS_SHM_WORKER_TTL_S", 5.0)
                ),
            )
            # the leader's stage observations (loopback-proxied
            # writes) land in block N; its /metrics also renders the
            # merged whole-front stage histograms
            app["dss_metrics"].attach_stage_writer(
                shmring.StageHistWriter(region, args.workers)
            )
            app["dss_metrics"].set_stage_agg(
                lambda _r=region: shmring.shm_stage_hist(_r)
            )
        # With the shm front attached the leader is a PURE device
        # owner: it serves the ring plus the loopback port the workers
        # proxy writes to, and leaves the public port entirely to the
        # workers.  A public connection landing on the leader would be
        # served at single-process latency AND steal owner CPU from
        # the ring drain.  Plain SO_REUSEPORT mode (DSS_SHM_ENABLE=0)
        # keeps the shared public bind.
        internal = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        internal.bind(("127.0.0.1", 0))
        internal.listen(1024)
        leader_url = f"http://127.0.0.1:{internal.getsockname()[1]}"
        if region is not None:
            leader_socks = [internal]
        else:
            leader_socks = [
                _public_socket(args.addr, reuse_port=True), internal,
            ]

        def spawn_worker(i):
            return subprocess.Popen(
                [sys.executable, "-m", "dss_tpu_torch.cmds.server"]
                + _forward_args(args, leader_url, worker_index=i)
            )

        children = [spawn_worker(i) for i in range(args.workers)]
        stopping = threading.Event()

        # a dead worker's in-flight ring slots are reclaimed the
        # moment the leader reaps it (the heartbeat TTL is the
        # backstop for a wedged-but-alive worker), and the worker is
        # RESPAWNED: with the shm front on, the leader leaves the
        # public port entirely to the workers, so an unreplaced crash
        # would permanently shrink — and at zero workers eliminate —
        # the service's public listeners.  A crash-looping worker
        # (died within 10s of spawn) backs off exponentially to 30s;
        # one that served a while restarts on the next tick.
        def watch_children():
            from dss_tpu_torch.obs.logging import get_logger

            log = get_logger("dss.server")
            backoff = [0.5] * len(children)
            respawn_at = [0.0] * len(children)
            spawned_at = [time.monotonic()] * len(children)
            dead: set = set()
            while not stopping.is_set():
                now = time.monotonic()
                for i, c in enumerate(children):
                    if c.poll() is None:
                        continue
                    if i not in dead:
                        dead.add(i)
                        freed = (
                            owner.reclaim_worker(i)
                            if owner is not None else 0
                        )
                        if now - spawned_at[i] < 10.0:
                            backoff[i] = min(backoff[i] * 2, 30.0)
                        else:
                            backoff[i] = 0.5
                        respawn_at[i] = now + backoff[i]
                        log.warning(
                            "worker %d exited (rc=%s); reclaimed %d "
                            "in-flight shm slots; respawn in %.1fs",
                            i, c.returncode, freed, backoff[i],
                        )
                    elif now >= respawn_at[i] and not stopping.is_set():
                        children[i] = spawn_worker(i)
                        spawned_at[i] = time.monotonic()
                        dead.discard(i)
                        log.warning(
                            "worker %d respawned (pid %d)",
                            i, children[i].pid,
                        )
                time.sleep(0.5)

        threading.Thread(
            target=watch_children, name="worker-watch", daemon=True
        ).start()

        def reap():
            stopping.set()
            for c in children:
                if c.poll() is None:
                    c.terminate()
            for c in children:
                try:
                    c.wait(timeout=args.shutdown_grace + 5)
                except subprocess.TimeoutExpired:
                    c.kill()
                    c.wait()
            if shm_dir:
                shutil.rmtree(shm_dir, ignore_errors=True)

        atexit.register(reap)
        web.run_app(
            app,
            sock=leader_socks,
            shutdown_timeout=args.shutdown_grace,
        )
        return

    app = build(args)
    host, _, port = args.addr.rpartition(":")
    # run_app installs SIGINT/SIGTERM handlers: the listener stops
    # accepting, in-flight requests get shutdown_timeout to finish,
    # then connections close (the GracefulStop analog)
    web.run_app(
        app,
        host=host or "0.0.0.0",
        port=int(port),
        shutdown_timeout=args.shutdown_grace,
        ssl_context=ssl_ctx,
    )


if __name__ == "__main__":
    main()

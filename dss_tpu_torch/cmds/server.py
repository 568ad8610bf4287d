"""The DSS server binary: flags, store bootstrap, auth setup, serve.

Collapses the reference's two processes (cmds/grpc-backend
RunGRPCServer, main.go:90-222 + cmds/http-gateway RunHTTPProxy) into
one REST server; the flag inventory mirrors grpc-backend main.go:42-73.

Run: python -m dss_tpu_torch.cmds.server --addr :8082 --enable_scd \
         --public_key_files build/test-certs/oauth.pem \
         --accepted_jwt_audiences localhost --storage cuda

A copy of the reference's `dss_tpu/cmds/server.py` in standalone mode.
`--storage cuda` (the default) puts every entity class's tables on
`--device` (default `cuda`, which raises on a machine without a card;
`--device cpu` runs the plain versions).  `--device` takes the place of
the reference's JAX-only `--virtual_cpu_devices`.  The flags of later
slices of the port stay in the parser, and each exits naming its slice
when set (LATER_SLICE_FLAGS).
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
    # -- flags of later slices of the port: each exits naming its slice
    # when set (LATER_SLICE_FLAGS); the reference's env fallbacks count
    p.add_argument(
        "--autotune_profile",
        default=os.environ.get("DSS_AUTOTUNE_PROFILE", ""),
        help="autotune profile JSON seeding the serving knobs (tuner "
        "slice).  Env fallback DSS_AUTOTUNE_PROFILE",
    )
    p.add_argument(
        "--self_tune",
        action="store_true",
        default=os.environ.get("DSS_TUNE", "0").lower()
        in ("1", "true", "yes", "on"),
        help="arm the self-tuning controller (tuner slice).  Env "
        "fallback DSS_TUNE",
    )
    p.add_argument(
        "--region_url",
        default="",
        help="region log server URL(s): join a multi-instance DSS "
        "Region (region slice)",
    )
    p.add_argument("--region_token_file", default="",
                   help="the shared region secret (region slice)")
    p.add_argument("--region_poll_interval", type=float, default=0.05,
                   help="region log tail poll seconds (region slice)")
    p.add_argument("--region_snapshot_every", type=int, default=512,
                   help="region snapshot period in entries (region slice)")
    p.add_argument("--instance_id", default="",
                   help="this instance's identity in the region "
                   "(region slice)")
    p.add_argument(
        "--federation_map",
        default=os.environ.get("DSS_FED_MAP", ""),
        help="multi-region federation map (region slice).  Env "
        "fallback DSS_FED_MAP",
    )
    p.add_argument(
        "--federation_region",
        default=os.environ.get("DSS_FED_REGION", ""),
        help="this deployment's region id in the federation map "
        "(region slice; env DSS_FED_REGION)",
    )
    p.add_argument(
        "--push",
        action="store_true",
        default=os.environ.get("DSS_PUSH", "") == "1",
        help="the reverse-query push pipeline (push slice).  Env "
        "fallback DSS_PUSH=1",
    )
    p.add_argument(
        "--jax_coordinator",
        default="",
        help="process 0's coordination address: join a process-"
        "spanning mesh (mesh slice).  Env fallback DSS_JAX_COORDINATOR",
    )
    p.add_argument("--process_id", type=int, default=None,
                   help="index in the multi-host mesh (mesh slice; env "
                   "DSS_PROCESS_ID)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes in the multi-host mesh (mesh slice; "
                   "env DSS_NUM_PROCESSES)")
    p.add_argument("--multihost_dryrun", type=int, default=0,
                   help="the multi-host path on the CPU (mesh slice; "
                   "env DSS_MULTIHOST_DRYRUN)")
    p.add_argument(
        "--sharded_replica",
        default="",
        help="'dp,sp' mesh shape of sharded read replicas (mesh slice)",
    )
    p.add_argument("--replica_refresh_interval", type=float, default=0.5,
                   help="replica refresh seconds (mesh slice)")
    p.add_argument("--no_shard_rebalance", action="store_true",
                   help="pin the sharded replica's split (mesh slice)")
    p.add_argument(
        "--workers",
        type=int,
        default=0,
        help="read-worker processes sharing the listen port (shm front "
        "slice).  0 = single process",
    )
    p.add_argument("--worker_reader", action="store_true",
                   help=argparse.SUPPRESS)  # shm front slice
    p.add_argument("--leader_url", default="", help=argparse.SUPPRESS)
    p.add_argument("--shm_region", default="",
                   help=argparse.SUPPRESS)  # shm front slice
    p.add_argument("--shm_worker_index", type=int, default=-1,
                   help=argparse.SUPPRESS)
    p.add_argument("--follower_poll_interval", type=float, default=0.02,
                   help="read-worker WAL tail seconds (shm front slice)")
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
# The parser's defaults already read the reference's env fallbacks
# (DSS_FED_MAP, DSS_PUSH, DSS_TUNE, DSS_AUTOTUNE_PROFILE); the mesh is
# also entered through DSS_JAX_COORDINATOR, as in the reference.
LATER_SLICE_FLAGS = {
    "workers": (0, "shm front"),
    "worker_reader": (False, "shm front"),
    "shm_region": ("", "shm front"),
    "federation_map": ("", "region"),
    "region_url": ("", "region"),
    "sharded_replica": ("", "mesh"),
    "jax_coordinator": ("", "mesh"),
    "process_id": (None, "mesh"),
    "num_processes": (None, "mesh"),
    "multihost_dryrun": (0, "mesh"),
    "push": (False, "push"),
    "self_tune": (False, "tuner"),
    "autotune_profile": ("", "tuner"),
}


def refuse_later_slices(args) -> None:
    """SystemExit naming the slice of the first flag that a later slice
    of the port brings (the port serves standalone mode only)."""
    if os.environ.get("DSS_JAX_COORDINATOR"):
        args.jax_coordinator = os.environ["DSS_JAX_COORDINATOR"]
    for flag, (unset, slice_) in LATER_SLICE_FLAGS.items():
        if getattr(args, flag) != unset:
            raise SystemExit(
                f"--{flag} is not ported yet; it comes with the {slice_} "
                "slice of the PyTorch/CUDA port (standalone mode only)"
            )


def build(args) -> web.Application:
    from dss_tpu_torch.obs.logging import configure_logging, get_logger
    from dss_tpu_torch.obs.metrics import MetricsRegistry

    refuse_later_slices(args)
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
    store = DSSStore(
        storage=args.storage,
        clock=clock,
        wal_path=args.wal_path or None,
        wal_fsync=args.wal_fsync,
        device=device,
    )
    log.info(
        "store ready: storage=%s device=%s wal=%s scd=%s "
        "region=(standalone)",
        args.storage,
        device if device is not None else "-",
        args.wal_path or "(none)",
        args.enable_scd,
    )
    log.info(
        "read cache: %s (cap=%d entries, stale_lag=%d gens; "
        "DSS_CACHE_* / configure_serving(cache=) to change)",
        "enabled" if store.cache.enabled else "disabled",
        store.cache.capacity,
        store.cache.stale_lag,
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

    metrics = MetricsRegistry()
    metrics.set_info("dss_build_info", build_info())

    app = build_app(
        rid,
        scd,
        authorizer,
        enable_scd=args.enable_scd,
        metrics=metrics,
        dump_requests=args.dump_requests,
        stats_fn=store.stats,
        status_fn=store.freshness_status,
        health_fn=store.health.mode_name,
        default_timeout_s=args.default_timeout,
        trace_requests=args.trace_requests,
        profile_dir=args.profile_dir,
        inline_reads=_inline_reads(args),
    )
    app["dss_store"] = store
    app["dss_metrics"] = metrics

    async def _close_store(app):
        # after the graceful stop: let the boot warm finish, then stop
        # the folds, coalescers and resident loops, so that no daemon
        # thread is inside a torch call when the interpreter exits (it
        # would abort the process: "terminate called without an active
        # exception")
        def close():
            if warm_thread is not None:
                warm_thread.join(args.shutdown_grace)
            store.close()

        await asyncio.get_running_loop().run_in_executor(None, close)

    app.on_cleanup.append(_close_store)

    # autotune profile provenance: a stable gauge whether or not a
    # profile was loaded (profiles come with the tuner slice: 0.0)
    metrics.set_gauge("dss_autotune_profile_age_s", 0.0)

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
    # heap; freezing mid-warm would pin transients instead).  When no
    # warm is pending the freeze runs synchronously, before serving.
    from dss_tpu_torch.runtime import freeze_boot_heap

    def _freeze_after_boot():
        warm_thread.join()
        # a handful of requests may be in flight by now; collect()
        # first so only their live frames (bounded, one-time) can pin
        freeze_boot_heap()

    if warm_thread is None:
        freeze_boot_heap()
    else:
        threading.Thread(
            target=_freeze_after_boot, name="gc-freeze", daemon=True
        ).start()
    return app


def main():
    args = make_parser().parse_args()
    refuse_later_slices(args)  # before anything boots

    from dss_tpu_torch.cmds import make_ssl_context

    ssl_ctx = make_ssl_context(args.tls_cert, args.tls_key)
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

"""The region log server binary: the shared source of truth for a
multi-instance DSS Region (the CRDB-cluster stand-in of the upstream
DSS's README.md:22-49).  The port of the reference's
`dss_tpu/cmds/region_server.py`, flag for flag; it uses no card and
creates no CUDA context (nothing here imports torch).

Run one PRIMARY per region; point every DSS instance's --region_url at
it (plus the mirrors, comma-separated, for failover):

    python -m dss_tpu_torch.cmds.region_server --addr :8090 \
        --wal_path /data/region.wal --token_file /secrets/region.token

For a replicated region, add mirrors and a quorum (region/mirror.py,
docs/OPERATIONS.md "Replication and failover"):

    # primary acks each append only once 2 durable copies exist
    python -m dss_tpu_torch.cmds.region_server --addr :8090 \
        --wal_path /data/region.wal --quorum 2
    # each mirror, on its own host/disk
    python -m dss_tpu_torch.cmds.region_server --addr :8091 \
        --wal_path /data/mirror.wal \
        --mirror_of http://primary:8090 \
        --advertise_url http://me:8091

Failover: promote the most caught-up mirror (highest /status head)
with `--promote` (sent to the RUNNING mirror's address), then repoint
the survivors:

    python -m dss_tpu_torch.cmds.region_server --promote --addr :8091
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

from aiohttp import web

from dss_tpu_torch.region.log_server import build_region_app


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DSS region log server")
    p.add_argument("--addr", default=":8090", help="address to listen on")
    p.add_argument(
        "--wal_path",
        default="",
        help="durable log file (the region's source of truth); empty = "
        "in-memory (testing only)",
    )
    p.add_argument(
        "--wal_fsync",
        action="store_true",
        help="fsync every append before acking: an acked write then "
        "survives a host crash, at per-append fsync cost.  Without it "
        "a crash can lose the unsynced tail — instances detect the "
        "regression via the persisted epoch (rotated on recovery) and "
        "resync to the log's truth.  Quorum replication (--quorum) is "
        "the complementary guard: copies on K processes/disks",
    )
    p.add_argument(
        "--token_file",
        default="",
        help="file holding the shared region secret; every instance "
        "must present it as a bearer token (empty = no auth, trusted "
        "network only).  Env DSS_REGION_TOKEN overrides.",
    )
    p.add_argument(
        "--mirror_of",
        default="",
        help="run as a MIRROR of this primary region server URL: "
        "serve reads, replicate its log, refuse writes with 503 "
        "not-primary.  Promote with --promote on failover.",
    )
    p.add_argument(
        "--advertise_url",
        default="",
        help="URL the primary should reach THIS process at (mirrors "
        "register it; defaults to http://127.0.0.1:<addr port>, which "
        "only works single-host)",
    )
    p.add_argument(
        "--quorum",
        type=int,
        default=1,
        help="total durable copies (this primary + mirrors) required "
        "before an append is acked.  1 = today's single-node behavior; "
        "run majority (e.g. 2 of primary+2 mirrors) for failover "
        "safety — the kill-the-primary guarantee needs quorum >= 2",
    )
    p.add_argument(
        "--repl_timeout",
        type=float,
        default=5.0,
        help="seconds to wait for mirror quorum acks before failing an "
        "append with 503 quorum-unavailable",
    )
    p.add_argument(
        "--rotate_epoch",
        action="store_true",
        help="force one epoch rotation at boot.  REQUIRED when "
        "starting from a WAL restored from backup: a cleanly-shut-down "
        "backup carries a valid clean marker, so boot alone cannot "
        "detect the regression — this flag fences readers of the lost "
        "suffix and resyncs the fleet to the restored log's truth.  "
        "Ignored for mirrors (their log is reset by the primary).",
    )
    p.add_argument(
        "--promote",
        action="store_true",
        help="one-shot: ask the RUNNING mirror at --addr to promote "
        "itself to primary (bumps the persisted epoch, fencing the old "
        "primary), print the result, and exit",
    )
    p.add_argument(
        "--tls_cert",
        default="",
        help="TLS certificate chain (PEM) — serve HTTPS directly "
        "(deploy/make_certs.py emits server.crt/server.key; leave "
        "unset when an ingress/sidecar terminates TLS, as the k8s "
        "manifests do)",
    )
    p.add_argument(
        "--tls_key",
        default="",
        help="TLS private key (PEM); required with --tls_cert",
    )
    p.add_argument(
        "--tls_ca",
        default="",
        help="CA bundle (PEM) to trust when the one-shot client verbs "
        "(--promote) talk to a TLS-serving region server: the request "
        "goes https:// verified against this CA (make_certs.py emits "
        "ca.crt).  Without it --promote speaks plaintext http.",
    )
    return p


def build(args) -> web.Application:
    token = os.environ.get("DSS_REGION_TOKEN", "")
    if not token and args.token_file:
        with open(args.token_file, "r", encoding="utf-8") as fh:
            token = fh.read().strip()
    host, _, port = args.addr.rpartition(":")
    advertise = args.advertise_url or f"http://127.0.0.1:{int(port)}"
    return build_region_app(
        args.wal_path or None,
        auth_token=token or None,
        fsync=args.wal_fsync,
        mirror_of=args.mirror_of or None,
        advertise_url=advertise,
        quorum=args.quorum,
        repl_timeout_s=args.repl_timeout,
        rotate_epoch=args.rotate_epoch,
    )


def send_promote(args) -> int:
    """POST /promote to the running server at --addr and report.
    With --tls_ca the request goes https:// verified against that CA
    (a TLS-serving mirror is unreachable over plaintext)."""
    token = os.environ.get("DSS_REGION_TOKEN", "")
    if not token and args.token_file:
        with open(args.token_file, "r", encoding="utf-8") as fh:
            token = fh.read().strip()
    host, _, port = args.addr.rpartition(":")
    ctx = None
    scheme = "http"
    if args.tls_ca:
        import ssl

        scheme = "https"
        ctx = ssl.create_default_context(cafile=args.tls_ca)
    url = f"{scheme}://{host or 'localhost'}:{int(port)}/promote"
    req = urllib.request.Request(
        url, data=b"{}", method="POST",
        headers={"Content-Type": "application/json"},
    )
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
            out = json.loads(resp.read().decode())
    except Exception as e:  # noqa: BLE001 — CLI surface: report + exit code
        print(json.dumps({"error": f"promote failed: {e}"}))
        return 1
    print(json.dumps(out))
    return 0


def main():
    from dss_tpu_torch.runtime import freeze_boot_heap

    args = make_parser().parse_args()
    if args.promote:
        raise SystemExit(send_promote(args))
    from dss_tpu_torch.cmds import make_ssl_context

    ssl_ctx = make_ssl_context(args.tls_cert, args.tls_key)
    app = build(args)  # replays the log in RegionLog.__init__
    freeze_boot_heap()
    host, _, port = args.addr.rpartition(":")
    web.run_app(
        app, host=host or "0.0.0.0", port=int(port), ssl_context=ssl_ctx
    )


if __name__ == "__main__":
    main()

"""Multi-instance DSS Region: replicated write log + per-instance DAR.

The port of the reference's `dss_tpu/region` (all but the federation,
which comes with its own slice).  The upstream DSS's region story is a
shared CockroachDB cluster — N organizations' DSS instances
gossip/Raft-replicate one SQL database (its README.md:22-49,
implementation_details.md:11-42) and every instance reads its own
replica.  The port keeps the reference's shape:

  - the REGION LOG (dss_tpu_torch.region.log_server) is the shared,
    ordered, durable source of truth — the CRDB-analog; its WAL is the
    reference's format, so one region may mix both packages' instances
    and log servers;
  - every DSS instance's DAR on the card is a READ REPLICA built by
    replaying the log (dss_tpu_torch.dar), exactly like the upstream
    "snapshot is a cache of the database" posture (SURVEY.md §5);
  - region-wide write serializability comes from a TTL write lease:
    a writer acquires the lease, catches up to the log head, validates
    against region-current state (version fences, OVN checks, quota),
    appends its logical operation as ONE atomic batch, and releases.
    This trades CRDB's optimistic MVCC for a simple total order —
    correct first; the DSS workload is read-heavy.

Consistency properties:
  - writes: region-serializable (single lease + catch-up before
    validation); a logical operation's records land atomically.
  - reads on the writing instance: read-your-writes (the writer
    applies locally before acknowledging).
  - reads on other instances: bounded staleness = tail-poll interval
    (default 50 ms) + transfer; monotonic (records apply in log order).
  - crash recovery: an instance that fails an append (lease fenced) or
    restarts resynchronizes from the latest state snapshot + the log
    tail after it; the region server owns durability via its
    write-ahead file and compacts entries below the snapshot, so
    recovery cost is bounded by snapshot interval, not history length.
  - txn rollback: an aborted local transaction that already journaled
    records is undone record-by-record from captured undo state — no
    resync, nothing region-visible.
"""

from dss_tpu_torch.region.client import (
    RegionClient,
    RegionError,
    SnapshotRequired,
)
from dss_tpu_torch.region.coordinator import RegionCoordinator
from dss_tpu_torch.region.log_server import build_region_app

__all__ = [
    "RegionClient",
    "RegionCoordinator",
    "RegionError",
    "SnapshotRequired",
    "build_region_app",
]

# The reference's region.federation (multi-region locality routing +
# bounded-stale follower reads) is imported explicitly by its users; the
# port's comes with the federation slice.

"""Entry `replica_churn`: the bounded-stale sharded read replica under
live filing.

Set-up builds `ShardedReplica` as the entry `replica` does, with the
configuration's `tier_ratio` besides (the server's DSS_TIER_RATIO),
tailing its own write-ahead log in the checkout, and loads the intents
into its record map and base tier the same way.  The driver then hands
it the write stream (`portbench/churn.py`): `file_backlog` appends the
backlog through `WriteAheadLog.append`, as the store does, and runs one
`sync()`, which tails it into the delta tier and the shadow set.
`lines(writes, r)` serializes round r's writes as the log's own lines
(the store's records: `scd_op_put` with `codec.op_to_doc` of the
operation, its cells the corridor's level-13 S2 cell ids, or
`scd_op_del`; a sequence number each, continuing the log's), so that
in the window `append` only writes them and `sync` (`poll_once`, then
`refresh`: the minor fold, its warm-up and the plan) does the
replica's part.  Searches go through `query_batch` as in the entry
`replica`, over the base and the delta tier.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from portbench import churn
from portbench.entries import replica

# one log a process (runs of the tests side by side), removed on close
LOG = Path(__file__).resolve().parents[2] / "build" / "portbench" / (
    f"replica_churn.{os.getpid()}.wal")
FOLD_COUNTERS = ("replica_fold_h2d_bytes", "replica_minor_fold_records",
                 "replica_delta_refreshes", "replica_major_rebuilds",
                 "replica_applied_records", "replica_apply_errors",
                 "replica_ops_delta_records", "replica_ops_shadowed")


class Entry(replica.Entry):
    span = "query_batch"

    def __init__(self, cfg: dict, data, device: str):
        from dss_tpu_torch.dar.oracle import Record
        from dss_tpu_torch.dar.wal import WriteAheadLog
        from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices
        from dss_tpu_torch.parallel.replica import ShardedReplica

        m = cfg["replica"]
        n = m["dp"] * m["sp"]
        LOG.parent.mkdir(parents=True, exist_ok=True)
        LOG.unlink(missing_ok=True)
        self.wal = WriteAheadLog(str(LOG))
        self.rep = ShardedReplica(
            make_mesh(n, dp=m["dp"], sp=m["sp"],
                      devices=virtual_devices(device, n)),
            wal_path=str(LOG), max_results=m["max_results"],
            warm_batches=tuple(m["warm_batches"]),
            tier_ratio=m["tier_ratio"])
        with self.rep._mu:
            self.rep._records["ops"] = {
                r.entity_id: r for r in data.records(Record)}
            self.rep._dirty["ops"] = True
        self.rep.refresh()
        self.data = data  # the intents, which the write stream updates
        self._out = None  # the log, opened for the window's lines
        self._seq = 0  # the last sequence number serialized
        self._versions = {}  # puts serialized per intent id

    def _record(self, w: churn.Writes, j: int) -> dict:
        """Write j of the stream as the store's log record."""
        from dss_tpu_torch.clock import from_nanos
        from dss_tpu_torch.dar import codec
        from dss_tpu_torch.geo import s2cell
        from dss_tpu_torch.models import scd

        e = int(w.ent[j])
        eid = str(w.ids[e])
        if w.kind[j] == churn.DELETE:
            return {"t": "scd_op_del", "id": eid}
        f, k = w.fresh, int(w.row[j])
        version = self._versions[eid] = self._versions.get(eid, 0) + 1
        owner = int(w.owner[e])
        op = scd.Operation(
            id=eid, owner=f"uss{owner:05d}", version=version,
            ovn=f"{eid[:8]}{version:08x}",
            start_time=from_nanos(int(f.t_start[k])),
            end_time=from_nanos(int(f.t_end[k])),
            altitude_lower=float(f.alt_lo[k]),
            altitude_upper=float(f.alt_hi[k]),
            uss_base_url=f"https://uss{owner:05d}.example.com/scd",
            state=(scd.OperationState.ACCEPTED if w.kind[j] == churn.INSERT
                   else scd.OperationState.ACTIVATED),
            cells=s2cell.dar_key_to_cell(f.keys[k]))
        return {"t": "scd_op_put", "doc": codec.op_to_doc(op)}

    def file_backlog(self, w: churn.Writes) -> None:
        """Round 0 through the log's own append, then one sync."""
        part = w.of_round(0)
        for j in range(part.start, part.stop):
            self.wal.append(self._record(w, j))
        self._seq = self.wal.seq
        self.rep.sync()

    def lines(self, w: churn.Writes, r: int) -> str:
        """Round r's writes as the log's lines, numbered on from the
        log's sequence."""
        part = w.of_round(r)
        out = []
        for j in range(part.start, part.stop):
            self._seq += 1
            out.append(json.dumps(dict(self._record(w, j), seq=self._seq),
                                  separators=(",", ":")) + "\n")
        return "".join(out)

    def append(self, lines: str) -> None:
        """A round's lines at the log's end, flushed (as the store's
        append leaves them, without fsync)."""
        if self._out is None:
            self.wal.close()
            self._out = open(LOG, "a", encoding="utf-8")
        self._out.write(lines)
        self._out.flush()

    def sync(self) -> None:
        self.rep.sync()

    def counters(self) -> dict:
        out = super().counters()
        stats = self.rep.stats()
        out.update((k, stats[k]) for k in FOLD_COUNTERS if k in stats)
        return out

    def close(self) -> None:
        if self._out is not None:
            self._out.close()
        self.wal.close()
        super().close()
        LOG.unlink(missing_ok=True)

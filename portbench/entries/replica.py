"""Entry `replica`: the bounded-stale sharded read replica.

Set-up builds `parallel/replica.py` `ShardedReplica` on a (dp, sp)
mesh of positions of the one card, with the server's knobs
(`--sharded_replica dp,sp`: `max_results`, the warm batches of the
chunks it is sent), tailing an empty log in the checkout.  The intents
go straight into its record map (`_records["ops"]`, under its lock, as
`chip_smoke.py`'s skew phase fills one): the records its tail would
parse from the log, without the JSON, which no query reads.  One
`refresh()` folds them into the base tier's `ShardedDar`, as the
replica's loop does at boot; the loop is not started, since nothing is
written during the window.  A batch is what the coalescer hands the
replica for a chunk of bounded-stale searches (`dar/coalesce.py`
`_pack_args`: one key array a query, per-query now) and goes through
`query_batch(..., cls="ops")`: the pad, K1 and K2 (`ops/mesh_cuda.py`)
on the base tier, the id lists, the shadow drop and the load record.
Answers are sorted lists of intent ids.
"""

from __future__ import annotations

from itertools import chain
from pathlib import Path

import numpy as np

from portbench import gen

LOG = Path(__file__).resolve().parents[2] / "build" / "portbench" / "replica.wal"


class Entry:
    span = "query_batch"

    def __init__(self, cfg: dict, data, device: str):
        from dss_tpu_torch.dar.oracle import Record
        from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices
        from dss_tpu_torch.parallel.replica import ShardedReplica

        m = cfg["replica"]
        n = m["dp"] * m["sp"]
        LOG.parent.mkdir(parents=True, exist_ok=True)
        LOG.write_bytes(b"")
        self.rep = ShardedReplica(
            make_mesh(n, dp=m["dp"], sp=m["sp"],
                      devices=virtual_devices(device, n)),
            wal_path=str(LOG), max_results=m["max_results"],
            warm_batches=tuple(m["warm_batches"]))
        with self.rep._mu:
            self.rep._records["ops"] = {
                r.entity_id: r for r in data.records(Record)}
            self.rep._dirty["ops"] = True
        self.rep.refresh()

    @staticmethod
    def prepare(q) -> tuple:
        return (list(q.keys), q.alt_lo, q.alt_hi, q.t_start, q.t_end,
                np.full(len(q), gen.NOW, np.int64))

    def query(self, args) -> list:
        keys, lo, hi, t0, t1, now = args
        return self.rep.query_batch(keys, lo, hi, t0, t1, now=now,
                                    cls="ops")

    @staticmethod
    def keep(answers, positions) -> tuple:
        """-> (the ids of the answers at `positions`, one after another,
        joined by newlines into one string; the length of each)."""
        picked = [answers[k] for k in positions]
        return ("\n".join(chain.from_iterable(picked)),
                np.array([len(a) for a in picked], np.int64))

    def counters(self) -> dict:
        from dss_tpu_torch.ops import mesh_cuda

        stats = self.rep.stats()
        return {"overflow_fallbacks": stats["replica_ops_overflow_fallbacks"],
                "k1_launches": mesh_cuda.mesh_query.launches,
                "k2_launches": mesh_cuda.mesh_merge.launches}

    def close(self) -> None:
        self.rep.close()
        self.rep = None

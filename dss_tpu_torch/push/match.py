"""Reverse-query matching: the write-side half of the fused kernel.

A subscription-notification lookup is the same geometry problem as a
search with the roles swapped: the write's 4D volume (cells + altitude
band + time window) is the QUERY, the subscription class's DAR is the
DATA.  MatchStage batches those write-side queries and routes them
through the planner's `rqmatch` candidate (plan/planner.py) — one
fused DarTable.query_many launch per batch when the device class is
admissible, chunked exact host scans (bit-identical by construction)
when it is not: DEVICE_LOST, the memory backend, or an injected
`push.match` fault, which is absorbed onto the host oracle exactly
like the coalescer absorbs device loss (a notification miss is a
correctness bug; a slower match is a latency note).

The stage shares the subscription-class coalescer's Planner when one
exists, so rqmatch plans land in the same co_plan_* counters the read
routes use (dss_dar_scd_sub_co_plan_rqmatch in /metrics) and rqmatch
cost observations feed the same CostModel's est_rq_* keys.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dss_tpu_torch import chaos
from dss_tpu_torch.geo import s2cell
from dss_tpu_torch.obs import stages
from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO
from dss_tpu_torch.plan.planner import BatchShape, Planner

__all__ = ["MatchQuery", "MatchStage"]

# (cells_u64, alt_lo | None, alt_hi | None, t_start_ns | None,
#  t_end_ns | None) — one write's match volume
MatchQuery = Tuple[np.ndarray, Optional[float], Optional[float],
                   Optional[int], Optional[int]]


class MatchStage:
    """Match write volumes against one subscription class's index.

    `index` is a dar.index spatial index (CudaSpatialIndex or
    MemorySpatialIndex).  On the cuda backend the stage plans with the
    index's own coalescer Planner (shared counters + cost model); the
    memory backend gets a private Planner whose device class is never
    admissible, so every plan routes hostchunk — the oracle."""

    def __init__(self, index, *, planner: Optional[Planner] = None,
                 health=None, metrics=None):
        self._index = index
        self._table = getattr(index, "table", None)
        self._health = health
        # direct registry handle: match runs on writer/pipeline
        # threads with no thread-local stage sink, so stages.mark alone
        # would drop push_match_ms on the floor — this feeds the
        # dss_stage_duration_seconds{stage="push_match_ms"} histogram
        # (STAGE_NAMES allowlist) the same way deliver.py feeds
        # push_deliver_ms
        self._metrics = metrics
        co = getattr(index, "coalescer", None)
        if planner is not None:
            self._planner = planner
        elif co is not None:
            self._planner = co._planner
        else:
            self._planner = Planner()
        self.batches = 0
        self.queries = 0
        self.absorbed = 0  # device-class faults re-served on the host

    # -- planning ---------------------------------------------------------

    def _device_ok(self) -> bool:
        if self._table is None:
            return False
        if self._health is not None and not self._health.device_ok():
            return False
        return True

    # -- execution --------------------------------------------------------

    @staticmethod
    def _pack(queries: Sequence[MatchQuery]):
        keys_list = [
            s2cell.cell_to_dar_key(np.asarray(c, dtype=np.uint64))
            for c, _, _, _, _ in queries
        ]
        alt_lo = np.asarray(
            [-np.inf if a is None else float(a)
             for _, a, _, _, _ in queries], np.float32,
        )
        alt_hi = np.asarray(
            [np.inf if a is None else float(a)
             for _, _, a, _, _ in queries], np.float32,
        )
        t0 = np.asarray(
            [NO_TIME_LO if t is None else int(t)
             for _, _, _, t, _ in queries], np.int64,
        )
        t1 = np.asarray(
            [NO_TIME_HI if t is None else int(t)
             for _, _, _, _, t in queries], np.int64,
        )
        return keys_list, alt_lo, alt_hi, t0, t1

    def _run_table(self, queries, now_ns: int,
                   host_route: bool) -> List[List[str]]:
        keys_list, alt_lo, alt_hi, t0, t1 = self._pack(queries)
        return self._table.query_many(
            keys_list, alt_lo, alt_hi, t0, t1,
            now=int(now_ns), host_route=host_route,
        )

    def _run_oracle(self, queries, now_ns: int) -> List[List[str]]:
        if self._table is not None:
            return self._run_table(queries, now_ns, host_route=True)
        out = []
        for cells, alt_lo, alt_hi, t0, t1 in queries:
            ids = self._index.query_ids(
                np.asarray(cells, dtype=np.uint64),
                alt_lo=alt_lo, alt_hi=alt_hi,
                t_start=t0, t_end=t1, now=int(now_ns),
            )
            out.append(sorted(ids))
        return out

    # -- public -----------------------------------------------------------

    def match_many(self, queries: Sequence[MatchQuery], *,
                   now_ns: int) -> List[List[str]]:
        """Match a batch of write volumes; returns a sorted id list
        per query.  Bit-identical across routes — the rqmatch kernel,
        the forced host chunks, and the memory oracle all implement
        the same COALESCE intersection rules."""
        b = len(queries)
        if b == 0:
            return []
        t0 = time.perf_counter()
        state = self._planner.capture(device_ok=self._device_ok())
        plan = self._planner.plan(
            BatchShape(n=b, rqmatch=True), state, None
        )
        try:
            chaos.fault_point("push.match")
            if plan.route == "rqmatch":
                out = [
                    sorted(ids)
                    for ids in self._run_table(
                        queries, now_ns, host_route=False
                    )
                ]
            else:
                out = self._run_oracle(queries, now_ns)
        except Exception as e:  # noqa: BLE001 — absorb, never miss
            if not isinstance(e, chaos.FaultError) and not (
                chaos.is_device_loss(e)
            ):
                raise
            # injected fault or in-flight device loss: the host
            # oracle serves the same answer — a notification must
            # never be missed because a route died under it
            out = self._run_oracle(queries, now_ns)
            self.absorbed += 1
        dur_ms = (time.perf_counter() - t0) * 1000.0
        if plan.route == "rqmatch":
            self._planner.observe_rqmatch(b, dur_ms)
        stages.mark("push_match_ms", dur_ms)
        if self._metrics is not None:
            self._metrics.observe_stage(
                "push", "push_match_ms", dur_ms / 1000.0
            )
        self.batches += 1
        self.queries += b
        return out

    def match(self, cells, alt_lo=None, alt_hi=None, t_start_ns=None,
              t_end_ns=None, *, now_ns: int) -> List[str]:
        """Single-volume convenience (the store's write path)."""
        return self.match_many(
            [(cells, alt_lo, alt_hi, t_start_ns, t_end_ns)],
            now_ns=now_ns,
        )[0]

    def oracle_many(self, queries: Sequence[MatchQuery], *,
                    now_ns: int) -> List[List[str]]:
        """The host-oracle answer, unconditionally — what the
        bit-identity tests (and the chaos drills) compare against."""
        return self._run_oracle(queries, now_ns)

    def stats(self) -> dict:
        return {
            "match_batches": self.batches,
            "match_queries": self.queries,
            "match_absorbed": self.absorbed,
        }

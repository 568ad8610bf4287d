"""Spatial index strategies behind the store implementations.

The port of the reference's `dss_tpu/dar/index.py`:

MemorySpatialIndex — pure-python linear scan over the oracle.

CudaSpatialIndex — the DarTable device index (dss_tpu_torch.dar.snapshot),
the counterpart of the reference's TpuSpatialIndex; cell ids are
compressed to int32 DAR keys on the way in, and concurrent single
queries are micro-batched by a QueryCoalescer (dss_tpu_torch.dar.coalesce)
configured from the DSS_CO_* environment.

Both expose identical query semantics (the SQL COALESCE rules).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from dss_tpu_torch.dar import oracle
from dss_tpu_torch.dar import tiers as tiersmod
from dss_tpu_torch.dar.coalesce import QueryCoalescer
from dss_tpu_torch.dar.coalesce import env_knobs as coalesce_env_knobs
from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.geo import s2cell


def _to_keys(cells_u64: np.ndarray) -> np.ndarray:
    return s2cell.cell_to_dar_key(np.asarray(cells_u64, dtype=np.uint64))


class MemorySpatialIndex:
    def __init__(self):
        self._recs: Dict[str, Record] = {}
        # same per-cell write clock as the DarTable backend
        self.cell_clock = tiersmod.CellClock()

    def put(self, id, cells_u64, alt_lo, alt_hi, t_start, t_end, owner_id):
        keys = np.unique(_to_keys(cells_u64))
        old = self._recs.get(id)
        self._recs[id] = Record(
            entity_id=id,
            keys=keys,
            alt_lo=-np.inf if alt_lo is None else float(alt_lo),
            alt_hi=np.inf if alt_hi is None else float(alt_hi),
            t_start=int(t_start),
            t_end=int(t_end),
            owner_id=int(owner_id),
        )
        # bump after the mutation; old + new coverings both change
        # their cells' answers
        self.cell_clock.bump(None if old is None else old.keys, keys)

    def remove(self, id):
        old = self._recs.pop(id, None)
        if old is not None:
            self.cell_clock.bump(old.keys)

    def clock_fence(self, cells_u64) -> "tuple[int, int, int, int]":
        """(incarnation, max stamp, generation, floor) over the
        covering — a read cache's O(|cells|) validity check."""
        return self.cell_clock.fence(_to_keys(cells_u64))

    def adopt_cell_clock(self, clock: tiersmod.CellClock) -> None:
        """Carry a predecessor index's clock across a state reset."""
        self.cell_clock = clock

    def query_ids(
        self,
        cells_u64,
        alt_lo=None,
        alt_hi=None,
        t_start=None,
        t_end=None,
        *,
        now,
        owner_id=None,
        allow_stale=False,  # no replica tier here; same-freshness reads
    ) -> List[str]:
        keys = _to_keys(cells_u64)
        recs = {i: r for i, r in enumerate(self._recs.values())}
        slots = oracle.search(
            recs, keys, alt_lo, alt_hi, t_start, t_end, now, owner_id
        )
        return [recs[s].entity_id for s in slots]

    def max_owner_count(self, cells_u64, owner_id, *, now) -> int:
        keys = _to_keys(cells_u64)
        recs = {i: r for i, r in enumerate(self._recs.values())}
        return oracle.max_count_per_cell(recs, keys, owner_id, now)

    def stats(self) -> dict:
        return {
            "live_records": len(self._recs),
            "write_generation": self.cell_clock.generation,
            "cell_clock_high_water": self.cell_clock.high_water,
        }


class CudaSpatialIndex:
    """The DarTable index on a CUDA card (or on `device`), with the
    reference TpuSpatialIndex's surface.

    query_ids goes through the QueryCoalescer: concurrent callers are
    drained into one batch, routed to the exact host scan, a cold B1
    launch or the resident loop (DSS_CO_RESIDENT=1), and answered with
    the same sorted id lists as a direct DarTable.query."""

    def __init__(self, *, device=None, **table_kwargs):
        self._table = DarTable(device=device, **table_kwargs)
        # concurrent readers (one thread per in-flight request) are
        # micro-batched into single fused kernel launches; serving
        # knobs come from DSS_CO_* env vars and can be adjusted at
        # runtime via coalescer.configure
        self._coalescer = QueryCoalescer(
            self._table, **coalesce_env_knobs()
        )

    def put(self, id, cells_u64, alt_lo, alt_hi, t_start, t_end, owner_id):
        self._table.upsert(
            id, _to_keys(cells_u64), alt_lo, alt_hi, int(t_start), int(t_end), owner_id
        )

    def remove(self, id):
        self._table.remove(id)

    def query_ids(
        self,
        cells_u64,
        alt_lo=None,
        alt_hi=None,
        t_start=None,
        t_end=None,
        *,
        now,
        owner_id=None,
        allow_stale=False,
    ) -> List[str]:
        return self._coalescer.query(
            _to_keys(cells_u64),
            alt_lo,
            alt_hi,
            None if t_start is None else int(t_start),
            None if t_end is None else int(t_end),
            now=int(now),
            owner_id=owner_id,
            allow_stale=allow_stale,
        )

    def max_owner_count(self, cells_u64, owner_id, *, now) -> int:
        return self._table.max_owner_count(
            _to_keys(cells_u64), owner_id, now=int(now)
        )

    @property
    def cell_clock(self) -> tiersmod.CellClock:
        return self._table.cell_clock

    def clock_fence(self, cells_u64) -> "tuple[int, int, int, int]":
        """(incarnation, max stamp, generation, floor) over the
        covering — a read cache's O(|cells|) validity check."""
        return self._table.cell_clock.fence(_to_keys(cells_u64))

    def adopt_cell_clock(self, clock: tiersmod.CellClock) -> None:
        """See MemorySpatialIndex.adopt_cell_clock."""
        self._table.cell_clock = clock

    def stats(self) -> dict:
        out = self._table.stats()
        # serving-pipeline gauges (queue depth, adaptive batch size,
        # pack/device/collect stage totals, route mix, shed counts)
        out.update(self._coalescer.stats())
        return out

    @property
    def table(self) -> DarTable:
        return self._table

    @property
    def coalescer(self) -> QueryCoalescer:
        return self._coalescer

    def retire(self):
        """A state reset swapped this index out: it takes no more
        writes, so its table's folder is told to stop (without waiting
        out a fold in progress); reads, and the coalescer, go on serving
        a reader that took the index before the swap.  close() ends
        both."""
        self._table.close(join=False)

    def close(self):
        """Stop the coalescer (it drains what it holds) before the
        table."""
        self._coalescer.close()
        self._table.close()

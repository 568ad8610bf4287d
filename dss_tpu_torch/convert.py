"""State carried across: port objects from plain arrays and records.

Takes numpy arrays and duck-typed objects only, so a reference table's
state (np.asarray of its columns, its Record objects) becomes port
state without this package importing the reference.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from dss_tpu_torch.dar.oracle import Record
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.ops.fastpath import BLOCK, FastTable, resolve_device


def records_from_reference(records: Iterable) -> List[Record]:
    """Port Records from any objects with entity_id, keys, alt_lo,
    alt_hi, t_start, t_end and owner_id — same order, so slot
    assignment is the same."""
    return [
        Record(
            entity_id=r.entity_id,
            keys=np.asarray(r.keys, np.int32),
            alt_lo=float(r.alt_lo),
            alt_hi=float(r.alt_hi),
            t_start=int(r.t_start),
            t_end=int(r.t_end),
            owner_id=int(r.owner_id),
        )
        for r in records
    ]


def fasttable_from_arrays(
    host_key, host_ent, host_live, slot_exact,
    b_alo=None, b_ahi=None, b_t0=None, b_t1=None, *, p3, device=None,
) -> FastTable:
    """A port FastTable from a table's host arrays, its (NB, 5, 128) i32
    `p3` columns and, when `slot_exact` is given, its (NB, 128) exact
    block columns (np.asarray of a reference table's device columns, or
    another port table's).  slot_exact=None carries a table that has
    only `p3`, as a reference table built without it.  The device
    columns are byte-identical to the inputs."""
    p3 = np.asarray(p3)
    if p3.dtype != np.int32 or p3.ndim != 3 or p3.shape[1:] != (5, BLOCK):
        raise ValueError(
            f"p3 must be int32 (NB, 5, {BLOCK}), got {p3.dtype} {p3.shape}"
        )
    if p3.shape[0] * BLOCK < len(host_key):
        raise ValueError("p3 is shorter than the postings")
    cols = None
    if slot_exact is not None:
        cols = [np.asarray(c) for c in (b_alo, b_ahi, b_t0, b_t1)]
        want = (np.float32, np.float32, np.int64, np.int64)
        for c, dt in zip(cols, want):
            if c.dtype != dt or c.shape != (p3.shape[0], BLOCK):
                raise ValueError(
                    f"block column must be {np.dtype(dt)} "
                    f"({p3.shape[0]}, {BLOCK}) like p3, got {c.dtype} "
                    f"{c.shape}"
                )
        slot_exact = {k: np.array(v) for k, v in slot_exact.items()}
    elif any(c is not None for c in (b_alo, b_ahi, b_t0, b_t1)):
        raise ValueError("exact block columns given without slot_exact")
    ft = FastTable.__new__(FastTable)
    ft._adopt(
        np.asarray(host_key), np.asarray(host_ent),
        np.asarray(host_live, bool), p3, slot_exact, cols,
        resolve_device(device),
    )
    return ft


def dartable_from_records(records: Iterable, *, device=None,
                          **table_kwargs) -> DarTable:
    """A port DarTable bulk-loaded with `records` (port Records or any
    duck-typed equivalents)."""
    table = DarTable(device=device, **table_kwargs)
    table.bulk_load(records_from_reference(records))
    return table

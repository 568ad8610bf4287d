"""The least bytes a conflict-query kernel must move, from its inputs.

Counted from the generated intents and the batch through the plain
reference's postings, so a bound reads the same work whatever kernel
implements the query: each input byte read once and each output byte
written once, and where the work depends on the data, what these
inputs need (the runs of the batch's cells, the intents in them, the
hits), never what one search strategy happens to touch.

  query_bytes    keys (4 B a cell), band (2 x f32), window (2 x i64)
  postings_bytes each posting of each distinct query cell's run once:
                 its key and its intent (2 x i32)
  attr_bytes     each distinct candidate intent's 4D attributes once
                 (2 x f32 altitudes, 2 x i64 times)
  out_bytes      each distinct hit as one i32 intent, and one i32 count
                 a query

`filter_bytes` is B1's and K1's bound (the same 4D query over the same
postings); `merge_bytes` is K2's: it reads every query's shard count
and kept intents and writes the merged list, a count and an overflow
flag a query (each hit is in at least one shard, so this is a floor for
any split of the key space).  The peak bandwidth of each card is in
`peaks.json`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ATTR_BYTES = 4 + 4 + 8 + 8
POSTING_BYTES = 4 + 4
QUERY_FIXED_BYTES = 4 + 4 + 8 + 8


def filter_bytes(ref, q, now: int) -> dict:
    """The least bytes of one batch of conflict queries -> the four
    parts, their sum (`bytes`) and the distinct hits (`hits`)."""
    cells = np.unique(q.keys[q.keys >= 0])
    lo, hi = ref.runs(cells)
    qi, ent = ref.candidates(q.keys)
    hit_q, _ = ref.hits(q, now)
    parts = {
        "query_bytes": int(q.keys.size * 4 + len(q) * QUERY_FIXED_BYTES),
        "postings_bytes": int((hi - lo).sum()) * POSTING_BYTES,
        "attr_bytes": int(len(np.unique(ent))) * ATTR_BYTES,
        "out_bytes": int(len(hit_q) + len(q)) * 4,
    }
    return {**parts, "bytes": sum(parts.values()), "hits": int(len(hit_q))}


def merge_bytes(n_queries: int, hits: int) -> int:
    """K2's least bytes for a batch with `hits` distinct hits."""
    read = n_queries * 4 + hits * 4
    write = hits * 4 + n_queries * (4 + 1)
    return read + write


def peak_bytes_per_s(kind: str):
    """The published HBM bandwidth of the card named `kind`, or None for
    a card the table does not hold."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    entry = table.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])

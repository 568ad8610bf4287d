"""The plain reference of a conflict query, in NumPy.

Works every answer out again from the generated intents and queries,
with its own postings (each intent's keys, sorted, with the intent's
index beside each key) and the 4D test of the DSS's SQL, frozen here:
an intent answers a query when they share a cell and

    intent.alt_hi >= query.alt_lo    intent.alt_lo <= query.alt_hi
    intent.t_end >= query.t_start    intent.t_start <= query.t_end
    intent.t_end >= now

(the port's `dar/oracle.py` `search`, itself the reference's
pkg/scd/store/cockroach/operations.go:374-435).  An answer is the
sorted, distinct intent indices.  It imports nothing of the program
and takes nothing the program built.

`judge(run, data)` holds a seeded sample of a run's kept answers (ids
mapped to intent indices through the generated ids) against it: a
query counts as mismatched when its answer is not the reference's set
of intents, element for element (a repeat, a missing, an extra or an
unknown intent).  Every configuration that names this reference states
exact answers, so the limit on mismatched queries is 0.

`alt_dtype="bfloat16"` is the benchmark's control: the same test on
altitudes rounded to bfloat16 (round to nearest, ties to even), the
next precision below the float32 that the configurations state.
"""

from __future__ import annotations

import numpy as np

from portbench import check, gen

# the number compared -> its limit (an exact comparison: PERF.md §2)
LIMITS = {"mismatched_queries": 0}
BLOCK_QUERIES = 4096  # queries answered at once (bounds the temporaries)


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class Reference:
    """Answers conflict queries over one set of intents."""

    def __init__(self, keys, alt_lo, alt_hi, t_start, t_end,
                 alt_dtype: str = "float32"):
        if alt_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"alt_dtype {alt_dtype!r}")
        self._round = to_bfloat16 if alt_dtype == "bfloat16" else (
            lambda a: np.asarray(a, np.float32))
        n, k = keys.shape
        flat = np.asarray(keys, np.int32).ravel()
        order = np.argsort(flat, kind="stable")
        self.post_key = flat[order]
        self.post_ent = (order // k).astype(np.int64)
        self.n = n
        self.alt_lo = self._round(alt_lo)
        self.alt_hi = self._round(alt_hi)
        self.t_start = np.asarray(t_start, np.int64)
        self.t_end = np.asarray(t_end, np.int64)

    def runs(self, keys: np.ndarray):
        """(lo, hi) postings positions of each key: the run of intents
        that hold that cell."""
        flat = np.asarray(keys, np.int32).ravel()
        return (np.searchsorted(self.post_key, flat, "left"),
                np.searchsorted(self.post_key, flat, "right"))

    def candidates(self, keys: np.ndarray):
        """(query index, intent index) of every posting in every query
        cell's run; an intent in several of a query's cells repeats."""
        m, w = keys.shape
        lo, hi = self.runs(keys)
        cnt = hi - lo
        total = int(cnt.sum())
        qi = np.repeat(np.arange(m * w, dtype=np.int64) // w, cnt)
        first = np.cumsum(cnt) - cnt
        pos = np.arange(total, dtype=np.int64) + np.repeat(lo - first, cnt)
        return qi, self.post_ent[pos]

    def hits(self, q, now: int):
        """(query index, intent index) of every distinct answer, sorted
        by query then intent."""
        qi, ent = self.candidates(q.keys)
        ok = ((self.alt_hi[ent] >= self._round(q.alt_lo)[qi])
              & (self.alt_lo[ent] <= self._round(q.alt_hi)[qi])
              & (self.t_end[ent] >= q.t_start[qi])
              & (self.t_start[ent] <= q.t_end[qi])
              & (self.t_end[ent] >= now))
        pairs = np.unique(qi[ok] * self.n + ent[ok])
        return pairs // self.n, pairs % self.n

    def answer(self, q, now: int) -> list:
        """The sorted distinct intent indices that answer each query."""
        out = []
        for lo in range(0, len(q), BLOCK_QUERIES):
            part = q.take(slice(lo, lo + BLOCK_QUERIES))
            qi, ent = self.hits(part, now)
            cuts = np.searchsorted(qi, np.arange(len(part) + 1))
            out += [ent[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        return out


def mismatches(got: list, want: list) -> int:
    """Queries whose answer (intent indices, any order) is not the
    reference's sorted distinct set."""
    return sum(
        not np.array_equal(np.sort(np.asarray(g, np.int64)), w)
        for g, w in zip(got, want))


def judge(run, data) -> tuple:
    """-> (queries compared, {name: reading}) over a seeded sample of
    `run.kept` (pool index, positions, the kept answers' ids joined by
    newlines, their lengths), and `run.ref`, the reference the bound
    readers share."""
    run.ref = Reference(data.keys, data.alt_lo, data.alt_hi, data.t_start,
                        data.t_end)
    sizes = np.array([len(k[1]) for k in run.kept], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    pick = check.sample(int(offs[-1]), run.traffic["check_sample"], run.seed)
    block = np.searchsorted(offs, pick, "right") - 1
    parts, got = [], []
    for b in np.unique(block):
        i, pos, ids, lens = run.kept[b]
        local = pick[block == b] - offs[b]
        parts.append(run.pool[i].take(pos[local]))
        cuts = np.concatenate([[0], np.cumsum(lens)])
        idx = (data.index_of(np.array(ids.split("\n"))) if ids
               else np.zeros(0, np.int64))
        got += [idx[cuts[k]:cuts[k + 1]] for k in local]
    if not got:
        return 0, {"mismatched_queries": 0}
    want = run.ref.answer(gen.Queries.concat(parts), gen.NOW)
    return len(got), {"mismatched_queries": mismatches(got, want)}


def control(cell: dict, recipe, seed: int) -> dict:
    """The control on one seed: the reference with altitudes in
    bfloat16 in the program's place, over as many of the cell's queries
    as a run compares (`check_sample`, from the cell's first batches),
    held to the float32 reference."""
    data_cfg, traffic = cell["config"]["data"], cell["traffic"]
    data = recipe.intents(data_cfg, seed)
    r = gen.rng(seed, gen.BATCHES)
    parts, have = [], 0
    while have < traffic["check_sample"]:
        parts.append(recipe.queries(data_cfg, traffic["query"], r,
                                    traffic["batch"]))
        have += traffic["batch"]
    q = gen.Queries.concat(parts).take(slice(0, traffic["check_sample"]))
    args = (data.keys, data.alt_lo, data.alt_hi, data.t_start, data.t_end)
    got = Reference(*args, "bfloat16").answer(q, gen.NOW)
    want = Reference(*args).answer(q, gen.NOW)
    return {"compared_queries": len(q),
            "mismatched_queries": mismatches(got, want)}

"""The plain reference of a conflict query under a stream of writes, in
NumPy.

Every version of every intent (`portbench/churn.py` `versions`: the
configuration's intents as loaded, then each put of the write stream)
goes into one static index, `conflict.Reference`'s postings, with the
rounds it is current in: from the round that filed it up to the round
of its intent's next write.  A query answered after round k is held to
the 4D test of `conflict.py` over the versions current at round k: the
state after the backlog and rounds 1..k, every write appended before
the chunk.  An answer is the sorted, distinct intent indices.  It
imports nothing of the program and takes nothing the program built.

`judge(run, data)` holds a seeded sample of a run's kept answers, each
at its round, against it (`mismatched_queries`, limit 0: the
configuration states exact answers).  `judge(run, data, stale=True)`
is the stale control: the same answers held to the state the window
opened on.  `control(cell, recipe, seed)` is the benchmark's control:
the reference with altitudes in bfloat16, the next precision below the
configuration's float32, at the state after the backlog.
"""

from __future__ import annotations

import numpy as np

from portbench import check, churn, gen
from portbench.reference import conflict

LIMITS = {"mismatched_queries": 0}
BLOCK_QUERIES = conflict.BLOCK_QUERIES


class Reference(conflict.Reference):
    """Answers conflict queries at any round of a write stream."""

    def __init__(self, v: churn.Versions, alt_dtype: str = "float32"):
        super().__init__(v.keys, v.alt_lo, v.alt_hi, v.t_start, v.t_end,
                         alt_dtype)
        self.ent, self.born, self.dies = v.ent, v.born, v.dies
        self.n_ent = int(v.ent.max()) + 1 if len(v.ent) else 0

    def answer(self, q, now: int, at: np.ndarray) -> list:
        """The sorted distinct intent indices that answer each query,
        query i at round at[i]."""
        out = []
        for lo in range(0, len(q), BLOCK_QUERIES):
            part = q.take(slice(lo, lo + BLOCK_QUERIES))
            qi, ver = self.hits(part, now)
            r = np.asarray(at[lo:lo + BLOCK_QUERIES], np.int64)[qi]
            ok = (self.born[ver] <= r) & (r < self.dies[ver])
            pairs = np.unique(qi[ok] * self.n_ent + self.ent[ver[ok]])
            qi, ent = pairs // self.n_ent, pairs % self.n_ent
            cuts = np.searchsorted(qi, np.arange(len(part) + 1))
            out += [ent[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        return out


def index_of(ids: np.ndarray):
    """-> a function from ids to intent indices (-1 for an unknown id)."""
    order = np.argsort(ids)
    srt = ids[order]

    def find(got: np.ndarray) -> np.ndarray:
        got = np.asarray(got, "U36")
        pos = np.searchsorted(srt, got).clip(0, len(srt) - 1)
        return np.where(srt[pos] == got, order[pos], -1)

    return find


def judge(run, data, stale: bool = False) -> tuple:
    """-> (queries compared, {name: reading}) over a seeded sample of
    `run.kept` (pool index, positions, the kept answers' ids joined by
    newlines, their lengths, the round that answered them); with
    `stale`, each held to the state the window opened on."""
    w = run.writes
    sizes = np.array([len(k[1]) for k in run.kept], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    pick = check.sample(int(offs[-1]), run.traffic["check_sample"], run.seed)
    block = np.searchsorted(offs, pick, "right") - 1
    find = index_of(w.ids)
    opened = run.traffic["warm_rounds"]
    parts, got, at = [], [], []
    for b in np.unique(block):
        i, pos, ids, lens, rnd = run.kept[b]
        local = pick[block == b] - offs[b]
        parts.append(run.pool[i].take(pos[local]))
        cuts = np.concatenate([[0], np.cumsum(lens)])
        idx = find(np.array(ids.split("\n"))) if ids else np.zeros(
            0, np.int64)
        got += [idx[cuts[k]:cuts[k + 1]] for k in local]
        at += [opened if stale else rnd] * len(local)
    if not got:
        return 0, {"mismatched_queries": 0}
    ref = Reference(churn.versions(data, w))
    want = ref.answer(gen.Queries.concat(parts), gen.NOW, np.array(at))
    return len(got), {"mismatched_queries": conflict.mismatches(got, want)}


def control(cell: dict, recipe, seed: int) -> dict:
    """The control on one seed: the reference with altitudes in
    bfloat16 in the program's place, over as many of the cell's queries
    as a run compares (`check_sample`, from the cell's first chunks),
    at the state after the backlog, held to the float32 reference."""
    data_cfg, traffic = cell["config"]["data"], cell["traffic"]
    data = recipe.intents(data_cfg, seed)
    w = churn.draw(recipe, data_cfg, data, cell["config"]["backlog"],
                   traffic["round"], 0, seed)
    r = gen.rng(seed, gen.BATCHES)
    parts, have = [], 0
    while have < traffic["check_sample"]:
        parts.append(recipe.queries(data_cfg, traffic["query"], r,
                                    traffic["batch"]))
        have += traffic["batch"]
    q = gen.Queries.concat(parts).take(slice(0, traffic["check_sample"]))
    v = churn.versions(data, w)
    at = np.zeros(len(q), np.int64)
    got = Reference(v, "bfloat16").answer(q, gen.NOW, at)
    want = Reference(v).answer(q, gen.NOW, at)
    return {"compared_queries": len(q),
            "mismatched_queries": conflict.mismatches(got, want)}

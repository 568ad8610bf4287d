"""The write stream of a churn cell: the backlog that set-up files and
the rounds of writes that the window sends between its searches.

Intent i < n is the configuration's intent i; intent n + k is the k-th
insert of the stream.  Round 0 is the backlog (`backlog` of the
configuration, per million intents: updates and deletes of distinct
intents of the configuration, inserts of new ones, filed in a seeded
order); round r >= 1 is the r-th round of the mix (`round`: so many
updates, inserts and deletes, in a seeded order).  In a round an update
re-files a live delta-resident intent (one updated or inserted since
the configuration's intents were loaded), drawn uniformly; an insert
files a new intent; a delete takes the oldest live insert, first in
first out.  So every round leaves as many intents written since the
load, and as many of the configuration's hidden, as it found.  A put's
new version (corridor, band, window) is drawn as the recipe draws
intents; an update keeps the intent's id and owner, an insert takes
the drawn id and owner.

NumPy only: the reference reads the stream (`versions`) as the entry
files it.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from portbench import gen

UPDATE, INSERT, DELETE = 0, 1, 2
WRITES = 3  # the stream tag of gen.rng(): the writes


@dataclass
class Writes:
    """The stream as columns, one entry a write, in filing order."""

    kind: np.ndarray  # i8 [E]: UPDATE, INSERT or DELETE
    ent: np.ndarray  # i64 [E]: the intent written
    rnd: np.ndarray  # i64 [E]: the round that files it (0: the backlog)
    row: np.ndarray  # i64 [E]: a put's row of `fresh` (-1: a delete)
    fresh: gen.Intents  # the puts' new versions; an insert's id and owner
    ids: np.ndarray  # U36 [n + inserts]: every intent's id
    owner: np.ndarray  # i32 [n + inserts]
    starts: np.ndarray  # i64 [rounds + 2]: each round's first write

    @property
    def rounds(self) -> int:
        """Rounds after the backlog."""
        return len(self.starts) - 2

    def of_round(self, r: int) -> slice:
        return slice(int(self.starts[r]), int(self.starts[r + 1]))


def counts(per_million: dict, n: int) -> tuple:
    """The backlog's (updates, inserts, deletes) for n intents."""
    return tuple(int(round(per_million[k] * n / 1e6))
                 for k in ("updates_per_million", "inserts_per_million",
                           "deletes_per_million"))


def draw(recipe, data_cfg: dict, data: gen.Intents, backlog: dict,
         mix: dict, rounds: int, seed: int) -> Writes:
    """The backlog and `rounds` rounds of the mix `mix` ({"updates",
    "inserts", "deletes"}), from the seed."""
    n = len(data.ids)
    n_upd, n_ins, n_del = counts(backlog, n)
    per = (mix["updates"], mix["inserts"], mix["deletes"])
    r = gen.rng(seed, WRITES)
    picked = r.choice(n, n_upd + n_del, replace=False)
    kinds = [r.permutation(np.repeat(np.int8([UPDATE, INSERT, DELETE]),
                                     (n_upd, n_ins, n_del)))]
    kinds += [r.permutation(np.repeat(np.int8([UPDATE, INSERT, DELETE]),
                                      per)) for _ in range(rounds)]
    puts = n_upd + n_ins + rounds * (per[0] + per[1])
    fresh = recipe.intents(dict(data_cfg, intents=puts),
                           int(r.integers(0, 2**63)))
    pick = r.random(sum(len(k) for k in kinds))

    kind = np.concatenate(kinds)
    ent = np.empty(len(kind), np.int64)
    row = np.full(len(kind), -1, np.int64)
    live, where = [], {}  # live delta-resident intents, their positions
    fifo = deque()  # live inserts, oldest first
    upd, dele = iter(picked[:n_upd].tolist()), iter(picked[n_upd:].tolist())
    new = put = 0

    def add(e):
        where[e] = len(live)
        live.append(e)

    for j, k in enumerate(kind.tolist()):
        backlog_write = j < len(kinds[0])
        if k == UPDATE:
            if backlog_write:
                e = next(upd)
                add(e)
            else:
                e = live[int(pick[j] * len(live))]
        elif k == INSERT:
            e = n + new
            new += 1
            add(e)
            fifo.append(e)
        else:
            if backlog_write:
                e = next(dele)
            else:
                e = fifo.popleft()
                last = live.pop()
                if last != e:
                    live[where[e]] = last
                    where[last] = where[e]
                del where[e]
        ent[j] = e
        if k != DELETE:
            row[j] = put
            put += 1
    ins_rows = row[kind == INSERT]
    sizes = [len(k) for k in kinds]
    return Writes(
        kind=kind, ent=ent,
        rnd=np.repeat(np.arange(rounds + 1, dtype=np.int64), sizes),
        row=row, fresh=fresh,
        ids=np.concatenate([data.ids, fresh.ids[ins_rows]]),
        owner=np.concatenate([data.owner, fresh.owner[ins_rows]]),
        starts=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))


@dataclass
class Versions:
    """Every version of every intent, and the rounds it is current in:
    from `born` (-1: loaded before the backlog) up to, not including,
    `dies` (the round of the next write of its intent)."""

    ent: np.ndarray  # i64 [V]
    keys: np.ndarray  # i32 [V, cells]
    alt_lo: np.ndarray  # f32 [V]
    alt_hi: np.ndarray
    t_start: np.ndarray  # i64 [V]
    t_end: np.ndarray
    born: np.ndarray  # i64 [V]
    dies: np.ndarray  # i64 [V]


NEVER = np.iinfo(np.int64).max


def versions(data: gen.Intents, w: Writes) -> Versions:
    """The configuration's intents as loaded, then each put's version,
    in filing order."""
    n = len(data.ids)
    puts = w.kind != DELETE
    rows = w.row[puts]
    f = w.fresh
    cur = np.arange(n + int((w.kind == INSERT).sum()), dtype=np.int64)
    cur[n:] = -1
    born = np.concatenate([np.full(n, -1, np.int64), w.rnd[puts]])
    dies = np.full(len(born), NEVER, np.int64)
    v = n
    for e, k, rnd in zip(w.ent.tolist(), w.kind.tolist(), w.rnd.tolist()):
        if cur[e] >= 0:
            dies[cur[e]] = rnd
        if k == DELETE:
            cur[e] = -1
        else:
            cur[e] = v
            v += 1
    return Versions(
        ent=np.concatenate([np.arange(n, dtype=np.int64), w.ent[puts]]),
        keys=np.concatenate([data.keys, f.keys[rows]]),
        alt_lo=np.concatenate([data.alt_lo, f.alt_lo[rows]]),
        alt_hi=np.concatenate([data.alt_hi, f.alt_hi[rows]]),
        t_start=np.concatenate([data.t_start, f.t_start[rows]]),
        t_end=np.concatenate([data.t_end, f.t_end[rows]]),
        born=born, dies=dies)

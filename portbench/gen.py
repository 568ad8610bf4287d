"""What every data recipe shares: the run's random streams, the fixed
"now", the intents and queries as columns, and the two helpers that
give them their deployed form (UUID ids, level-13 DAR keys).

A configuration names its recipe (`portbench/recipes/<recipe>.py`),
which draws the intents and the traffic's queries from the seed with
these.  Every stream of numbers comes from `rng(seed, *stream)`, so one
seed gives the same inputs in every run, and each part (the data, the
batches, the check's sample) has its own stream whatever the others
draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HOUR = 3_600_000_000_000  # ns
NOW = 1_700_000_000_000_000_000  # the fixed "now" of every query (ns)
# stream tags of rng(): the data, the batches, the check's sample
DATA, BATCHES, CHECK = 0, 1, 2
LEVEL = 13  # the DSS's S2 cell level


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run: any whole seed (negative
    or past 64 bits folds into 0 .. 2**64-1)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def uuid4_ids(r: np.random.Generator, n: int) -> np.ndarray:
    """n random version-4 UUID strings (the DSS's entity ids), as a
    NumPy unicode array."""
    b = r.integers(0, 256, (n, 16), dtype=np.uint8)
    b[:, 6] = (b[:, 6] & 0x0F) | 0x40
    b[:, 8] = (b[:, 8] & 0x3F) | 0x80
    pairs = np.array([f"{v:02x}".encode() for v in range(256)], "S2")
    hexs = pairs[b].view("S1").reshape(n, 32)
    dash = np.full((n, 1), b"-", "S1")
    parts = [hexs[:, :8], dash, hexs[:, 8:12], dash, hexs[:, 12:16], dash,
             hexs[:, 16:20], dash, hexs[:, 20:]]
    return np.ascontiguousarray(np.hstack(parts)).view("S36").ravel() \
        .astype("U36")


def hilbert(x: np.ndarray, y: np.ndarray, order: int = LEVEL) -> np.ndarray:
    """Position of cell (x, y) along the Hilbert curve over a 2**order
    square (the curve S2 numbers a face's cells by)."""
    n = 1 << order
    x = np.asarray(x, np.int64).copy()
    y = np.asarray(y, np.int64).copy()
    d = np.zeros(x.shape, np.int64)
    s = n >> 1
    while s:
        rx = (x & s) > 0
        ry = (y & s) > 0
        d += s * s * ((3 * rx.astype(np.int64)) ^ ry.astype(np.int64))
        flip = ~ry & rx
        x = np.where(flip, n - 1 - x, x)
        y = np.where(flip, n - 1 - y, y)
        swap = ~ry
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        s >>= 1
    return d


def dar_keys(face: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The int32 DAR key of the level-13 cell (i, j) of S2 face `face`:
    the cell id's top 30 bits, face (3 bits), Hilbert position (26 bits)
    and the level's trailing 1.  S2 starts the curve of an odd face with
    its axes swapped."""
    d = hilbert(j, i) if face & 1 else hilbert(i, j)
    return ((face << 27) | (d << 1) | 1).astype(np.int32)


@dataclass
class Intents:
    """The live operational intents, column by column; intent i has the
    id `ids[i]`."""

    ids: np.ndarray  # U36 [n]
    keys: np.ndarray  # i32 [n, cells_per_intent], each row sorted
    alt_lo: np.ndarray  # f32 [n] metres
    alt_hi: np.ndarray  # f32 [n]
    t_start: np.ndarray  # i64 [n] ns
    t_end: np.ndarray  # i64 [n]
    owner: np.ndarray  # i32 [n]

    def records(self, record_cls) -> list:
        """The intents as the port's host records (`record_cls` is its
        `Record`), in index order."""
        return [
            record_cls(eid, self.keys[i], lo, hi, t0, t1, ow)
            for i, (eid, lo, hi, t0, t1, ow) in enumerate(zip(
                self.ids.tolist(), self.alt_lo.tolist(),
                self.alt_hi.tolist(), self.t_start.tolist(),
                self.t_end.tolist(), self.owner.tolist()))
        ]

    def index_of(self, ids: np.ndarray) -> np.ndarray:
        """The intent index of each id (-1 for an id no intent has)."""
        if not hasattr(self, "_order"):
            self._order = np.argsort(self.ids)
            self._sorted = self.ids[self._order]
        ids = np.asarray(ids, "U36")
        pos = np.searchsorted(self._sorted, ids).clip(0, len(self.ids) - 1)
        return np.where(self._sorted[pos] == ids, self._order[pos], -1)


@dataclass
class Queries:
    """A batch of queries, column by column."""

    keys: np.ndarray  # i32 [m, cells], each row sorted
    alt_lo: np.ndarray  # f32 [m]
    alt_hi: np.ndarray  # f32 [m]
    t_start: np.ndarray  # i64 [m]
    t_end: np.ndarray  # i64 [m]

    def __len__(self) -> int:
        return len(self.alt_lo)

    def take(self, idx) -> "Queries":
        return Queries(self.keys[idx], self.alt_lo[idx], self.alt_hi[idx],
                       self.t_start[idx], self.t_end[idx])

    @staticmethod
    def concat(parts) -> "Queries":
        return Queries(*(np.concatenate(cols) for cols in zip(
            *((p.keys, p.alt_lo, p.alt_hi, p.t_start, p.t_end)
              for p in parts))))

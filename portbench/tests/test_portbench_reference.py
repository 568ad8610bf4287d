"""The data recipe and the plain reference: the reference against a
brute-force scan, the recipe's keys against the DSS's own S2 keys, its
corridors contiguous, and the control's rounding."""

import numpy as np
import pytest

from portbench import check, gen
from portbench.recipes import corridors
from portbench.reference.conflict import (Reference, mismatches,
                                          to_bfloat16)

DATA = {"intents": 3000, "cells_per_intent": 8, "metro_side_cells": 8,
        "face": 4, "metro_corner": [1091, 3326], "alt_lo_m": [0, 3000],
        "band_m": [10, 600], "start_hours": [-4, 3], "hours": [1, 5],
        "owners": 65536}
QUERY = {"cells": 8, "band_m": 300.0, "alt_lo_m": [0, 3000],
         "start_hours": [-2, 1], "hours": 1}


def brute(it, q, now):
    out = []
    for i in range(len(q)):
        share = np.isin(it.keys, q.keys[i]).any(axis=1)
        ok = (share & (it.alt_hi >= q.alt_lo[i]) & (it.alt_lo <= q.alt_hi[i])
              & (it.t_end >= q.t_start[i]) & (it.t_start <= q.t_end[i])
              & (it.t_end >= now))
        out.append(np.flatnonzero(ok))
    return out


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5])
def test_reference_matches_brute_force(seed):
    it = corridors.intents(DATA, seed)
    q = corridors.queries(DATA, QUERY, gen.rng(seed, gen.BATCHES), 300)
    ref = Reference(it.keys, it.alt_lo, it.alt_hi, it.t_start, it.t_end)
    got = ref.answer(q, gen.NOW)
    want = brute(it, q, gen.NOW)
    assert sum(len(w) for w in want) > 0
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert mismatches(got, want) == 0


def test_same_seed_same_inputs():
    a, b = corridors.intents(DATA, 99), corridors.intents(DATA, 99)
    assert all(np.array_equal(x, y) for x, y in zip(
        (a.ids, a.keys, a.alt_lo, a.t_end), (b.ids, b.keys, b.alt_lo, b.t_end)))
    assert not np.array_equal(a.keys, corridors.intents(DATA, 100).keys)


@pytest.mark.parametrize("face", range(6))
def test_keys_are_the_dss_level13_dar_keys(face):
    from dss_tpu_torch.geo import s2cell

    r = np.random.default_rng(face)
    i, j = r.integers(0, 2**13, (2, 64))
    want = [int(s2cell.cell_to_dar_key(s2cell.cell_parent(np.uint64(
        s2cell.from_face_ij(face, int(a) << 17, int(b) << 17)), 13)))
        for a, b in zip(i, j)]
    assert gen.dar_keys(face, i, j).tolist() == want


def test_corridors_are_contiguous_and_inside_the_region():
    data = {**DATA, "metro_side_cells": 30}
    keys = corridors.corridor_keys(data, gen.rng(4, 0), 500, 8)
    table = corridors.region_keys(data)
    where = {int(k): (x, y) for (x, y), k in np.ndenumerate(table)}
    for row in keys:
        assert len(set(row.tolist())) == 8
        cells = [where[int(k)] for k in row]  # KeyError: outside
        seen, todo = {cells[0]}, [cells[0]]
        while todo:
            x, y = todo.pop()
            for n in ((x + 1, y), (x - 1, y), (x, y + 1), (x, y - 1)):
                if n in cells and n not in seen:
                    seen.add(n)
                    todo.append(n)
        assert len(seen) == 8


def test_ids_are_uuid4_and_map_back():
    it = corridors.intents(DATA, 7)
    assert len(set(it.ids.tolist())) == len(it.ids)
    assert all(s[14] == "4" and s[19] in "89ab" and len(s) == 36
               for s in it.ids[:50].tolist())
    pick = np.array([5, 0, 2999, 17])
    assert it.index_of(it.ids[pick]).tolist() == pick.tolist()
    assert it.index_of(np.array(["0" * 36]))[0] == -1


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.01171875, 2999.7, -3.3], np.float32)
    r = to_bfloat16(x)
    # bfloat16 keeps 8 significant bits: ties go to even
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.015625
    assert r[3] == 2992.0 and r[4] == np.float32(-3.296875)


def test_control_fails_the_check():
    it = corridors.intents(DATA, 3)
    q = corridors.queries(DATA, QUERY, gen.rng(3, gen.BATCHES), 2000)
    args = (it.keys, it.alt_lo, it.alt_hi, it.t_start, it.t_end)
    got = Reference(*args, "bfloat16").answer(q, gen.NOW)
    assert mismatches(got, Reference(*args).answer(q, gen.NOW)) > 0


def test_mismatch_counts_repeats_and_gaps():
    want = [np.array([1, 2, 3]), np.array([], np.int64), np.array([4])]
    assert mismatches([[3, 2, 1], [], [4]], want) == 0
    assert mismatches([[1, 2, 3, 3], [], [4]], want) == 1
    assert mismatches([[1, 2], [5], []], want) == 3


def test_check_sample_is_seeded_and_capped():
    a = check.sample(10000, 300, 12)
    assert len(a) == 300 and np.array_equal(a, check.sample(10000, 300, 12))
    assert np.array_equal(check.sample(200, 300, 12), np.arange(200))

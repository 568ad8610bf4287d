"""CudaSpatialIndex (device="cpu") against the reference TpuSpatialIndex
and MemorySpatialIndex, on real level-13 cells made with the port's
s2cell.  Same query_ids lists and max_owner_count, exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar.index import MemorySpatialIndex as RefMemoryIndex
from dss_tpu.dar.index import TpuSpatialIndex
from dss_tpu.geo import s2cell as ref_s2cell

from dss_tpu_torch.dar.index import CudaSpatialIndex, MemorySpatialIndex
from dss_tpu_torch.geo import s2cell

HOUR = 3_600_000_000_000
NOW = 1_700_000_000_000_000_000


@pytest.mark.parametrize("seed", [0, 1])
def test_s2cell_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-89.9, 89.9, 2000)
    lng = rng.uniform(-180, 180, 2000)
    for level in (None, 13, 5):
        a = s2cell.cell_id_from_latlng(lat, lng, level=level)
        b = ref_s2cell.cell_id_from_latlng(lat, lng, level=level)
        np.testing.assert_array_equal(a, b)
    cells = s2cell.cell_id_from_latlng(lat, lng, level=13)
    keys = s2cell.cell_to_dar_key(cells)
    np.testing.assert_array_equal(keys, ref_s2cell.cell_to_dar_key(cells))
    np.testing.assert_array_equal(s2cell.dar_key_to_cell(keys), cells)
    np.testing.assert_array_equal(s2cell.cell_level(cells), 13)


def _footprint(rng, lat0, lng0):
    """Level-13 cells of a small random patch (~1-3 km) near a point."""
    n = int(rng.integers(1, 12))
    lat = lat0 + rng.uniform(-0.02, 0.02, n)
    lng = lng0 + rng.uniform(-0.02, 0.02, n)
    return np.unique(s2cell.cell_id_from_latlng(lat, lng, level=13))


def test_index_matches_reference_indexes():
    rng = np.random.default_rng(21)
    port = CudaSpatialIndex(device="cpu", idle_fold_s=0, delta_capacity=200)
    tpu = TpuSpatialIndex(idle_fold_s=0, delta_capacity=200)
    mem = MemorySpatialIndex()
    ref_mem = RefMemoryIndex()
    indexes = (port, tpu, mem, ref_mem)
    centers = [(37.77, -122.42), (37.80, -122.27), (47.61, -122.33)]
    try:
        live = set()
        nonempty = 0
        for step in range(300):
            lat0, lng0 = centers[int(rng.integers(0, len(centers)))]
            if rng.random() < 0.75 or not live:
                i = int(rng.integers(0, 150))
                cells = _footprint(rng, lat0, lng0)
                alo = float(rng.uniform(0, 1000))
                t0 = NOW + int(rng.integers(-3, 3)) * HOUR
                bounded = step % 6 != 0
                args = (
                    alo if bounded else None,
                    alo + 150.0 if bounded else None,
                    t0, t0 + int(rng.integers(1, 4)) * HOUR,
                    int(rng.integers(0, 3)),
                )
                for ix in indexes:
                    ix.put(f"op{i}", cells, *args)
                live.add(f"op{i}")
            else:
                victim = sorted(live)[int(rng.integers(0, len(live)))]
                for ix in indexes:
                    ix.remove(victim)
                live.discard(victim)
            if step % 60 == 59:
                port.table.fold()
                tpu.table.fold()
            cells = _footprint(rng, lat0, lng0)
            alo = float(rng.uniform(0, 1000))
            q = dict(
                alt_lo=alo if step % 2 else None,
                alt_hi=alo + 300.0 if step % 2 else None,
                t_start=NOW - HOUR if step % 3 else None,
                t_end=NOW + HOUR if step % 3 else None,
                now=NOW + int(rng.integers(-2, 2)) * HOUR,
                owner_id=int(rng.integers(0, 3)) if step % 5 == 0 else None,
            )
            # the memory indexes list ids in insertion order, the DAR
            # indexes sorted: each pair must agree exactly
            want = ref_mem.query_ids(cells, **q)
            nonempty += bool(want)
            assert mem.query_ids(cells, **q) == want, step
            got = port.query_ids(cells, **q)
            assert got == tpu.query_ids(cells, **q) == sorted(want), step
            owner = int(rng.integers(0, 3))
            now = q["now"]
            want_n = ref_mem.max_owner_count(cells, owner, now=now)
            for ix in (port, tpu, mem):
                assert ix.max_owner_count(cells, owner, now=now) == want_n
        assert nonempty > 100  # the queries really found entities
        assert port.stats()["live_records"] == len(live)
        fence = port.clock_fence(cells)
        assert fence[2] == port.cell_clock.generation > 0
    finally:
        port.close()
        tpu.close()


def test_concurrent_query_ids_through_the_coalescer():
    """Concurrent callers of CudaSpatialIndex.query_ids are drained by
    its QueryCoalescer, as TpuSpatialIndex's are: the same sorted id
    lists, the coalescer's gauges in stats(), and a close() that stops
    the coalescer before the table."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(31)
    port = CudaSpatialIndex(device="cpu", idle_fold_s=0)
    tpu = TpuSpatialIndex(idle_fold_s=0)
    centers = [(37.77, -122.42), (37.80, -122.27)]
    try:
        for i in range(400):
            lat0, lng0 = centers[i % 2]
            cells = _footprint(rng, lat0, lng0)
            alo = float(rng.uniform(0, 1000))
            for ix in (port, tpu):
                ix.put(f"op{i}", cells, alo, alo + 200.0, NOW - HOUR,
                       NOW + HOUR, i % 3)
            if i == 300:
                port.table.fold()
                tpu.table.fold()
        qs = []
        for j in range(160):
            lat0, lng0 = centers[j % 2]
            alo = float(rng.uniform(0, 1000))
            qs.append((_footprint(rng, lat0, lng0), alo, alo + 300.0,
                       j % 4 if j % 5 == 0 else None))

        def ask(ix, q):
            cells, lo, hi, owner = q
            return ix.query_ids(cells, lo, hi, NOW - HOUR, NOW + HOUR,
                                now=NOW, owner_id=owner)

        with ThreadPoolExecutor(max_workers=24) as pool:
            got = list(pool.map(lambda q: ask(port, q), qs, timeout=60))
            want = list(pool.map(lambda q: ask(tpu, q), qs, timeout=60))
        assert got == want
        assert sum(map(len, got)) > 100
        st = port.stats()
        assert st["co_items"] + st["co_inline"] >= 1
        assert set(tpu.stats()) <= set(st)
        assert port.coalescer.stats()["co_queue_depth"] == 0
    finally:
        port.close()
        tpu.close()
    with pytest.raises(RuntimeError, match="closed"):
        port.query_ids(qs[0][0], now=NOW)

"""The port's QueryCoalescer against the reference's, on the CPU.

Each scenario runs twice on the same numpy-seeded data: once through
`dss_tpu.dar.coalesce.QueryCoalescer` over the reference DarTable, once
through `dss_tpu_torch.dar.coalesce.QueryCoalescer` over the port's
DarTable(device="cpu").  Answers, typed errors and the route counters
of stats() must agree.  Drains are made deterministic by holding the
pack stage (`_busy`, the flag an inline batch sets) until every caller
of a burst is queued, so a burst of N callers is exactly one drain.
Every test that starts threads bounds its waits.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu import chaos as ref_chaos
from dss_tpu import errors as ref_errors
from dss_tpu.dar import coalesce as ref_coalesce
from dss_tpu.dar import deadline as ref_deadline
from dss_tpu.dar.snapshot import DarTable as RefDarTable

from dss_tpu_torch import chaos, errors
from dss_tpu_torch.dar import coalesce, deadline
from dss_tpu_torch.dar.snapshot import DarTable

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
WAIT_S = 20.0

# (coalescer module, errors, chaos, deadline, table factory)
SIDES = {
    "ref": (ref_coalesce, ref_errors, ref_chaos, ref_deadline,
            lambda **kw: RefDarTable(**kw)),
    "port": (coalesce, errors, chaos, deadline,
             lambda **kw: DarTable(device="cpu", **kw)),
}


def _table(side, seed=3, n=400, key_space=60):
    """A folded table (L0 on the fused path) plus an overlay."""
    t = SIDES[side][4](idle_fold_s=0, delta_capacity=1 << 20)
    rng = np.random.default_rng(seed)
    for i in range(n):
        keys = np.unique(rng.integers(0, key_space, int(rng.integers(1, 6))))
        alo, ahi = sorted(rng.uniform(0, 3000, 2))
        t.upsert(f"e{i}", keys.astype(np.int32), float(alo), float(ahi),
                 NOW - HOUR, NOW + HOUR, i % 5)
        if i == n - 40:
            assert t.fold()
    return t


def _cases(seed, count, key_space=60):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, key_space, 3).astype(np.int32))
            for _ in range(count)]


def _wait(pred, what):
    end = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _burst(co, calls):
    """Queue every call behind the held pack stage, then release it.
    -> [(result, error)] in call order."""
    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = (fn(), None)
        except Exception as e:  # noqa: BLE001 — compared by the test
            out[i] = (None, e)

    with co._cond:
        co._busy = True
    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    _wait(lambda: co.stats()["co_queue_depth"] == len(calls), "the burst")
    with co._cond:
        co._busy = False
        co._cond.notify_all()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    return out


ROUTE_KEYS = ("co_batches", "co_items", "co_inline", "co_shed",
              "co_deadline_shed", "co_route_host_batches",
              "co_route_hostchunk_batches", "co_route_device_batches",
              "co_route_resident_batches", "co_device_loss_absorbed")


def _routes(co):
    _wait(lambda: co.stats()["co_inflight"] == 0, "the pipeline to drain")
    st = co.stats()
    return {k: st[k] for k in ROUTE_KEYS}


def test_stats_keys_match_reference():
    got = {}
    for side in SIDES:
        t = _table(side, n=50)
        co = SIDES[side][0].QueryCoalescer(t, resident=True)
        try:
            got[side] = set(co.stats())
        finally:
            co.close()
            t.close()
    assert got["ref"] <= got["port"]
    assert got["port"] - got["ref"] == {"co_res_graph_busy",
                                        "co_res_graph_captures"}


def test_concurrent_callers_same_sorted_ids():
    cases = _cases(11, 200)
    got = {}
    for side in SIDES:
        t = _table(side)
        co = SIDES[side][0].QueryCoalescer(t, min_batch=1, queue_depth=64)
        try:
            with ThreadPoolExecutor(max_workers=32) as pool:
                got[side] = list(pool.map(
                    lambda k, co=co: co.query(k, now=NOW), cases,
                    timeout=WAIT_S))
            serial = [t.query(k, now=NOW) for k in cases]
            assert got[side] == serial
        finally:
            co.close()
            t.close()
    assert got["port"] == got["ref"]
    assert sum(map(len, got["port"])) > 100  # the answers are not empty


@pytest.mark.parametrize("route", ["hostchunk", "device"])
def test_forced_route_counters_match(route):
    """One burst of 100 callers (owner filters on a third) is one drain.
    Seeded estimates force the route: a catastrophic device floor under
    a 50 ms SLO sends it to chunked host scans; no SLO and a
    catastrophic host chunk send it to the fused kernel (on the port,
    its plain version), past the 64-query host cutoff."""
    # a frozen clock: every caller's 50 ms headroom is whole at the drain
    seeds = (dict(slo_ms=50.0, est_floor_ms=10_000.0, est_item_ms=0.0,
                  est_chunk_ms=0.01, clock=lambda: 1000.0)
             if route == "hostchunk" else
             dict(slo_ms=0.0, est_chunk_ms=1e6))
    cases = _cases(12, 100)
    got, counts = {}, {}
    for side in SIDES:
        t = _table(side)
        co = SIDES[side][0].QueryCoalescer(
            t, inline=False, min_batch=64, queue_depth=64, **seeds)
        try:
            calls = [
                (lambda k=k, i=i, co=co: co.query(
                    k, 0.0, 3000.0, NOW - HOUR, NOW + HOUR, now=NOW,
                    owner_id=(i % 5 if i % 3 == 0 else None)))
                for i, k in enumerate(cases)
            ]
            out = _burst(co, calls)
            assert all(e is None for _, e in out), out
            got[side] = [r for r, _ in out]
            counts[side] = _routes(co)
            assert co.stats()["co_plan_" + route] == 1
        finally:
            co.close()
            t.close()
    assert got["port"] == got["ref"]
    assert counts["port"] == counts["ref"]
    want = {"hostchunk": ("co_route_hostchunk_batches", 1),
            "device": ("co_route_device_batches", 1)}[route]
    assert counts["port"][want[0]] == want[1]
    assert counts["port"]["co_batches"] == 1
    assert counts["port"]["co_items"] == 100


def test_full_queue_sheds_with_same_retry_after():
    """A queue of 2 (max_batch 1 x queue_depth 2) held full: the third
    caller is shed at once with OverloadedError (HTTP 429) and the same
    Retry-After horizon; the two admitted callers are then served."""
    shed, served = {}, {}
    for side in SIDES:
        mod, errs = SIDES[side][0], SIDES[side][1]
        t = _table(side, n=50)
        co = mod.QueryCoalescer(t, min_batch=1, max_batch=1, queue_depth=2,
                                admission_wait_s=0.0, inline=False)
        try:
            with co._cond:
                co._busy = True
            res = []
            ths = [threading.Thread(target=lambda: res.append(
                co.query(np.asarray([3], np.int32), now=NOW)))
                for _ in range(2)]
            for th in ths:
                th.start()
            _wait(lambda: co.stats()["co_queue_depth"] == 2, "a full queue")
            with pytest.raises(errs.OverloadedError) as ei:
                co.query(np.asarray([3], np.int32), now=NOW)
            shed[side] = (ei.value.code.value, ei.value.http_status,
                          ei.value.retry_after_s, co.stats()["co_shed"])
            with co._cond:
                co._busy = False
                co._cond.notify_all()
            for th in ths:
                th.join(WAIT_S)
            served[side] = res
        finally:
            co.close()
            t.close()
    assert shed["port"] == shed["ref"]
    code, status, retry, n_shed = shed["port"]
    assert status == 429 and n_shed == 1 and 0.0 < retry <= 5.0
    assert served["port"] == served["ref"] and len(served["port"]) == 2


def test_deadline_sheds_match():
    """Two DEADLINE_EXCEEDED sheds: a route deadline already spent at
    admission, and an SLO deadline that expires while queued (fake
    clock); a stale-ok caller in the same drain is still served."""
    got = {}
    for side in SIDES:
        mod, errs, _, dl, _ = SIDES[side]
        t = _table(side, n=50)
        clock = [1000.0]
        co = mod.QueryCoalescer(t, inline=False, min_batch=1,
                                queue_depth=64, slo_ms=20.0,
                                clock=lambda: clock[0])
        try:
            dl.set_route_deadline(clock[0] - 1.0)
            try:
                with pytest.raises(errs.StatusError) as ei:
                    co.query(np.asarray([3], np.int32), now=NOW)
            finally:
                dl.set_route_deadline(None)
            early = ei.value.code.value, ei.value.http_status

            def fresh():
                return co.query(np.asarray([3], np.int32), now=NOW)

            def stale():
                return co.query(np.asarray([3], np.int32), now=NOW,
                                allow_stale=True)

            with co._cond:
                co._busy = True
            out = [None, None]
            ths = [threading.Thread(target=lambda i=i, f=f: out.__setitem__(
                i, _call(f))) for i, f in enumerate((fresh, stale))]
            for th in ths:
                th.start()
            _wait(lambda: co.stats()["co_queue_depth"] == 2, "the queue")
            clock[0] += 10.0  # every SLO deadline long gone
            with co._cond:
                co._busy = False
                co._cond.notify_all()
            for th in ths:
                th.join(WAIT_S)
            (r0, e0), (r1, e1) = out
            got[side] = (early, r0, e0.code.value, e0.http_status, r1,
                         e1, _routes(co))
        finally:
            co.close()
            t.close()
    assert got["port"] == got["ref"]
    early, r0, code, status, r1, e1, counts = got["port"]
    assert early == (4, 504) and (code, status) == (4, 504) and r0 is None
    assert e1 is None and counts["co_deadline_shed"] == 2


def _call(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001
        return None, e


def test_injected_device_loss_absorbed_and_reserved():
    """An injected DeviceLostError at the cold dispatch seam is absorbed:
    the drain is re-served by forced host chunks with the same answers,
    and co_device_loss_absorbed counts it, on both sides."""
    cases = _cases(13, 100)
    got, counts = {}, {}
    for side in SIDES:
        mod, _, ch, _, _ = SIDES[side]
        t = _table(side)
        co = mod.QueryCoalescer(t, inline=False, min_batch=64,
                                queue_depth=64, est_chunk_ms=1e6)
        ch.install_plan({"events": [{"site": "device.dispatch",
                                     "action": "device_lost",
                                     "count": 1}]})
        try:
            out = _burst(co, [lambda k=k, co=co: co.query(k, now=NOW)
                              for k in cases])
            assert all(e is None for _, e in out), out
            got[side] = [r for r, _ in out]
            counts[side] = _routes(co)
            assert got[side] == [t.query(k, now=NOW) for k in cases]
        finally:
            ch.clear_plan()
            co.close()
            t.close()
    assert got["port"] == got["ref"]
    assert counts["port"] == counts["ref"]
    assert counts["port"]["co_device_loss_absorbed"] == 1
    assert counts["port"]["co_route_hostchunk_batches"] == 1


class _FailingTable:
    """A table whose device submit fails as a kernel wrapper does on a
    nonzero CUDA return; the forced host route still works."""

    def __init__(self, table):
        self._table = table

    def query_many_submit(self, *a, host_route=False, **kw):
        if not host_route:
            raise RuntimeError("fused_window_filter launch failed: "
                               "CUDA error 700")
        return self._table.query_many_submit(*a, host_route=True, **kw)

    def query_many_collect(self, pq):
        return self._table.query_many_collect(pq)


def test_real_device_error_reaches_callers():
    """A plain RuntimeError from submit is NOT a device loss: every
    caller of the drain gets it, nothing is re-served on the host."""
    got = {}
    for side in SIDES:
        mod, _, ch, _, _ = SIDES[side]
        inner = _table(side, n=50)
        co = mod.QueryCoalescer(_FailingTable(inner), inline=False,
                                min_batch=64, queue_depth=64,
                                est_chunk_ms=1e6)
        try:
            out = _burst(co, [lambda co=co: co.query(
                np.asarray([3], np.int32), now=NOW)] * 5)
            assert all(isinstance(e, RuntimeError) and r is None
                       for r, e in out), out
            assert not ch.is_device_loss(out[0][1])
            got[side] = ([str(e) for _, e in out], _routes(co))
        finally:
            co.close()
            inner.close()
    assert got["port"] == got["ref"]
    assert got["port"][1]["co_device_loss_absorbed"] == 0

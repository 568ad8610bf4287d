"""The port's push pipeline (dss_tpu_torch/push) against the reference's.

The cases of tests/test_push.py, each run as one scenario on both
packages (the reference's `storage="tpu"` store beside the port's
`storage="cuda"` store on device="cpu", which runs B1's plain version,
and both memory backends), with the reference test's own assertions
made on each and the two outcomes compared: matched ids, deliveries,
acks and parks, plans, and the stats key set.  Then three checks the
reference file lacks: MatchStage parity on a seeded subscription table,
empty_stats() against the reference's, and the port's server booted
with --push answering /aux/v1/push/status and delivering a webhook.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from datetime import timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import requests

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu import chaos as r_chaos
from dss_tpu import push as r_push
from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar.dss_store import DSSStore as RDSSStore
from dss_tpu.models import rid as r_ridm
from dss_tpu.models import scd as r_scdm
from dss_tpu.obs.metrics import MetricsRegistry as RMetrics
from dss_tpu.plan import costs as r_costs
from dss_tpu.plan import planner as r_planner
from dss_tpu.push import deliver as r_deliver

from dss_tpu_torch import chaos as p_chaos
from dss_tpu_torch import push as p_push
from dss_tpu_torch.clock import FakeClock as PFakeClock
from dss_tpu_torch.dar.dss_store import DSSStore as PDSSStore
from dss_tpu_torch.geo import covering
from dss_tpu_torch.models import rid as p_ridm
from dss_tpu_torch.models import scd as p_scdm
from dss_tpu_torch.obs.metrics import MetricsRegistry as PMetrics
from dss_tpu_torch.plan import costs as p_costs
from dss_tpu_torch.plan import planner as p_planner
from dss_tpu_torch.push import deliver as p_deliver

T0 = datetime.datetime(2026, 7, 1, 12, 0, 0, tzinfo=timezone.utc)
SID = "00000000-0000-4000-8000-0000000000%02x"

REF = SimpleNamespace(
    name="reference", chaos=r_chaos, push=r_push, deliver=r_deliver,
    FakeClock=RFakeClock, Metrics=RMetrics, ridm=r_ridm, scdm=r_scdm,
    costs=r_costs, planner=r_planner,
    store=lambda storage, clock: RDSSStore(
        storage="tpu" if storage == "device" else storage, clock=clock),
)
PORT = SimpleNamespace(
    name="port", chaos=p_chaos, push=p_push, deliver=p_deliver,
    FakeClock=PFakeClock, Metrics=PMetrics, ridm=p_ridm, scdm=p_scdm,
    costs=p_costs, planner=p_planner,
    store=lambda storage, clock: (
        PDSSStore(storage="cuda", device="cpu", clock=clock)
        if storage == "device" else PDSSStore(storage=storage, clock=clock)),
)
BOTH = (REF, PORT)


def both(scenario, *args):
    """Run scenario(ns, *args) on both packages; -> the port's outcome,
    asserted equal to the reference's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


@pytest.fixture(autouse=True)
def _clean_faults():
    for ns in BOTH:
        ns.chaos.clear_plan()
        ns.chaos.registry().reset_counters()
    yield
    for ns in BOTH:
        ns.chaos.clear_plan()
        ns.chaos.registry().reset_counters()


def cells_at(lat, lng, half=0.03):
    return covering.covering_polygon([
        (lat - half, lng - half), (lat - half, lng + half),
        (lat + half, lng + half), (lat + half, lng - half),
    ])


CELLS_A = cells_at(34.0, -118.0)
CELLS_B = cells_at(34.06, -118.0)
CELLS_FAR = cells_at(-33.9, 151.2)


def st(ns, **kw):
    base = dict(
        est_floor_ms=100.0, est_item_ms=0.01, est_chunk_ms=0.2,
        est_res_floor_ms=25.0, est_res_lat_ms=100.0,
        est_rq_floor_ms=2.0, est_rq_item_ms=0.01, chunk=64,
    )
    base.update(kw)
    return ns.planner.ModelState(**base)


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------------
# 1. planner: the rqmatch route
# ---------------------------------------------------------------------------


def test_rqmatch_candidates_exclude_stale_routes():
    def run(ns):
        cand = ns.planner.enumerate_candidates(
            ns.planner.BatchShape(n=32, rqmatch=True),
            st(ns, resident_ready=True, mesh_ready=True), None,
        )
        assert cand["rqmatch"] is not None
        assert cand["hostchunk"] is not None
        for route in ("cache", "inline", "mesh", "resident", "device"):
            assert cand[route] is None
        return {k: v for k, v in cand.items()}

    both(run)


def test_rqmatch_device_lost_routes_host():
    def run(ns):
        return ns.planner.decide(
            ns.planner.BatchShape(n=32, rqmatch=True),
            st(ns, device_ok=False), None,
        ).route

    assert both(run) == "hostchunk"


def test_rqmatch_headroom_escape():
    def run(ns):
        s = st(ns, est_chunk_ms=0.001)
        shape = ns.planner.BatchShape(n=32, rqmatch=True)
        return (ns.planner.decide(shape, s, 1.0).route,
                ns.planner.decide(shape, s, 100.0).route)

    assert both(run) == ("hostchunk", "rqmatch")


def test_rqmatch_cost_keys_isolated():
    def run(ns):
        cm = ns.costs.CostModel(floor_ms=100.0, item_ms=0.01)
        floor0, item0 = cm.est_floor_ms, cm.est_item_ms
        for _ in range(50):
            cm.observe_rqmatch(64, 4.0)
        assert cm.est_floor_ms == floor0 and cm.est_item_ms == item0
        assert cm.est_rq_floor_ms < floor0
        pred = cm.predict_rqmatch_ms(64)
        assert 0.0 < pred < 20.0
        return cm.est_rq_floor_ms, cm.est_rq_item_ms, pred

    both(run)


def test_rqmatch_state_defaults_fall_back_to_device_keys():
    def run(ns):
        s = st(ns, est_rq_floor_ms=0.0, est_rq_item_ms=0.0)
        want = ns.costs.predict_device_ms(s.est_floor_ms, s.est_item_ms, 10)
        assert s.predict_rqmatch_ms(10) == pytest.approx(want)
        return s.predict_rqmatch_ms(10)

    both(run)


def test_planner_observe_rqmatch_counter():
    def run(ns):
        pl = ns.planner.Planner()
        plan = pl.plan(ns.planner.BatchShape(n=8, rqmatch=True), st(ns), None)
        pl.observe_rqmatch(8, 3.0)
        return plan.route, pl.stats()["co_plan_rqmatch"]

    assert both(run) == ("rqmatch", 1)


# ---------------------------------------------------------------------------
# 2. queue: durable cursor/ack + QoS
# ---------------------------------------------------------------------------


def test_queue_fifo_and_ack():
    def run(ns):
        log = ns.push.DeliveryLog()
        n1 = log.enqueue("a", "http://a", {"k": 1})
        n2 = log.enqueue("a", "http://a", {"k": 2})
        t1 = log.take(timeout_s=0)
        t2 = log.take(timeout_s=0)
        out = [(n1, n2), [t1.body["k"], t2.body["k"]],
               log.take(timeout_s=0) is None,
               log.ack(t1.nid), log.ack(t2.nid), log.ack(t1.nid),
               log.depth(), log.stats()]
        log.close()
        return out

    out = both(run)
    assert out[0] == (1, 2) and out[1] == [1, 2]
    assert out[2:6] == [True, True, True, False] and out[6] == 0


def test_queue_emergency_preempts_bulk():
    def run(ns):
        log = ns.push.DeliveryLog()
        for i in range(3):
            log.enqueue("bulk-uss", "http://b", {"i": i}, qos="bulk")
        log.enqueue("em-uss", "http://e", {"i": 99}, qos="emergency")
        order = []
        while (n := log.take(timeout_s=0)) is not None:
            order.append((n.uss, n.qos, n.body["i"]))
        log.close()
        return order

    assert both(run)[0] == ("em-uss", "emergency", 99)


def test_queue_blocked_uss_rotated_past():
    def run(ns):
        log = ns.push.DeliveryLog()
        log.enqueue("dead", "http://d", {})
        log.enqueue("live", "http://l", {})
        n = log.take(blocked={"dead"}, timeout_s=0)
        out = (n.uss, log.depth())
        log.close()
        return out

    assert both(run) == ("live", 2)


def test_queue_depth_bound_sheds_bulk_not_emergency():
    def run(ns):
        log = ns.push.DeliveryLog(max_depth=2)
        out = [log.enqueue("u", "h", {}) for _ in range(3)]
        out.append(log.enqueue("u", "h", {}, qos="emergency"))
        out.append(log.stats()["dropped"])
        log.close()
        return out

    assert both(run) == [1, 2, None, 3, 1]


def test_queue_requeue_bumps_attempts():
    def run(ns):
        log = ns.push.DeliveryLog()
        log.enqueue("u", "h", {})
        n = log.take(timeout_s=0)
        log.requeue(n)
        again = log.take(timeout_s=0)
        out = (again.nid == n.nid, again.attempts, log.stats()["requeued"])
        log.close()
        return out

    assert both(run) == (True, 1, 1)


def _crash_log(ns, path):
    """The reference test's crash scenario, written by `ns`."""
    log = ns.push.DeliveryLog(path)
    log.register_hook("ussA", "http://a/notify", qos="emergency")
    n1 = log.enqueue("ussA", "http://a", {"k": 1})
    n2 = log.enqueue("ussA", "http://a", {"k": 2}, qos="emergency")
    n3 = log.enqueue("ussB", "http://b", {"k": 3})
    n4 = log.enqueue("ussB", "http://b", {"k": 4})
    log.ack(n1)
    log.park(n4, reason="max_attempts")
    log.sync()
    return (n1, n2, n3, n4)  # crash: the object is dropped unclosed


def _replayed(ns, path):
    log2 = ns.push.DeliveryLog(path)
    hook = log2.hook_of("ussA")
    pending = []
    while (n := log2.take(timeout_s=0)) is not None:
        pending.append((n.nid, n.uss, n.qos, n.body))
    seq = log2.seq
    log2.close()
    return hook, pending, seq > 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_queue_crash_replay_redelivers_unacked_only(tmp_path, writer):
    """enqueued - acked survives a crash; acked and parked never
    redeliver; hooks ride the same log.  The WAL is the reference's
    format: each package replays the log the other wrote."""
    w = REF if writer == "reference" else PORT
    path = str(tmp_path / "push.wal")
    n1, n2, n3, n4 = _crash_log(w, path)
    for ns in BOTH:
        hook, pending, seq_ok = _replayed(ns, path)
        assert hook == {"url": "http://a/notify", "qos": "emergency"}
        assert sorted(p[0] for p in pending) == [n2, n3] and seq_ok
        # the emergency band first, then bulk
        assert [p[2] for p in pending] == ["emergency", "bulk"]


def test_queue_taken_but_unacked_survives_crash(tmp_path):
    def run(ns):
        path = str(tmp_path / f"{ns.name}.wal")
        log = ns.push.DeliveryLog(path)
        nid = log.enqueue("u", "h", {"k": 1})
        first = log.take(timeout_s=0).nid
        log.sync()
        log2 = ns.push.DeliveryLog(path)
        again = log2.take(timeout_s=0).nid
        log2.close()
        return nid, first, again

    assert both(run) == (1, 1, 1)


def test_queue_bad_qos_rejected():
    for ns in BOTH:
        log = ns.push.DeliveryLog()
        with pytest.raises(ValueError, match="unknown qos band"):
            log.register_hook("u", "h", qos="ludicrous")
        log.close()


# ---------------------------------------------------------------------------
# 3. delivery: retry / breaker / parking
# ---------------------------------------------------------------------------


def _pool(ns, log, transport, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("breaker_reset_s", 0.05)
    return ns.push.DeliveryPool(log, transport=transport, **kw)


def test_pool_delivers_and_acks():
    def run(ns):
        log = ns.push.DeliveryLog()
        got = []
        pool = _pool(ns, log, lambda url, body, hdrs: got.append((url, body)))
        pool.start()
        log.enqueue("u", "http://u/hook", {"k": 1},
                    traceparent="00-aa-bb-01")
        assert _wait(lambda: pool.delivered == 1)
        out = (got, log.depth(), log.stats()["acked"], pool.stats()["parked"])
        pool.close()
        log.close()
        return out

    got, depth, acked, parked = both(run)
    assert got == [("http://u/hook", {"k": 1})]
    assert (depth, acked, parked) == (0, 1, 0)


def test_pool_traceparent_header_propagates():
    def run(ns):
        log = ns.push.DeliveryLog()
        seen = {}
        pool = _pool(ns, log, lambda url, body, hdrs: seen.update(hdrs))
        pool.start()
        tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
        log.enqueue("u", "h", {}, traceparent=tp)
        assert _wait(lambda: pool.delivered == 1)
        pool.close()
        log.close()
        return seen

    seen = both(run)
    assert seen["X-Request-Id"] == "0af7651916cd43dd8448eb211c80319c"
    assert seen["X-DSS-Notification-Id"] == "1"


def test_pool_breaker_opens_and_other_uss_drains():
    def run(ns):
        log = ns.push.DeliveryLog()
        calls = {"dead": 0, "live": 0}

        def transport(url, body, hdrs):
            uss = "dead" if "dead" in url else "live"
            calls[uss] += 1
            if uss == "dead":
                raise OSError("connection refused")

        pool = _pool(ns, log, transport, breaker_threshold=3,
                     breaker_reset_s=60.0)
        pool.start()
        for i in range(5):
            log.enqueue("dead", "http://dead/h", {"i": i})
        for i in range(5):
            log.enqueue("live", "http://live/h", {"i": i})
        assert _wait(lambda: pool.delivered == 5)
        assert _wait(lambda: pool.breakers.states().get("dead")
                     == ns.chaos.BREAKER_OPEN)
        settled = calls["dead"]
        assert settled >= 3
        time.sleep(0.1)
        assert calls["dead"] == settled  # open breaker: no more attempts
        out = (calls["live"], pool.delivered, pool.breakers.states(),
               log.stats()["acked"])
        pool.close()
        log.close()
        return out

    assert both(run) == (5, 5, {"dead": 2, "live": 0}, 5)


def test_pool_parks_at_max_attempts():
    def run(ns):
        log = ns.push.DeliveryLog()

        def transport(url, body, hdrs):
            raise OSError("always down")

        pool = _pool(ns, log, transport, max_attempts=3,
                     retry=ns.chaos.RetryPolicy(base_s=0.001, cap_s=0.002,
                                                seed=1),
                     breaker_threshold=100)
        pool.start()
        log.enqueue("u", "h", {"k": 1})
        assert _wait(lambda: pool.parked == 1)
        out = (log.depth(), pool.failures, pool.parked, pool.delivered,
               log.stats()["acked"])
        pool.close()
        log.close()
        return out

    assert both(run) == (0, 3, 1, 0, 0)


def test_pool_fault_site_push_deliver():
    def run(ns):
        ns.chaos.install_plan(ns.chaos.FaultPlan.from_dict({
            "seed": 7,
            "events": [{"site": "push.deliver", "match": "flaky",
                        "count": 2}],
        }))
        log = ns.push.DeliveryLog()
        got = []
        pool = _pool(ns, log, lambda url, body, hdrs: got.append(url),
                     retry=ns.chaos.RetryPolicy(base_s=0.001, cap_s=0.002,
                                                seed=1),
                     breaker_threshold=100)
        pool.start()
        log.enqueue("flaky", "http://f/h", {})
        assert _wait(lambda: pool.delivered == 1)
        out = (got, pool.failures,
               ns.chaos.registry().injected_by_site()["push.deliver"],
               log.stats()["requeued"])
        pool.close()
        log.close()
        ns.chaos.clear_plan()
        return out

    assert both(run) == (["http://f/h"], 2, 2, 2)


class _Receiver:
    """A stdlib HTTP server on a thread that records every POST."""

    def __init__(self, fail_first=0):
        self.got = []
        self.fail_left = fail_first
        rec = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if rec.fail_left > 0:
                    rec.fail_left -= 1
                    self.send_response(503)
                else:
                    rec.got.append((self.path, {
                        k.lower(): v for k, v in self.headers.items()
                    }, json.loads(body)))
                    self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_http_transport_posts_json_and_raises_on_non_2xx():
    """http_transport over real HTTP: a 2xx acks, a 503 raises; through
    a pool the 503 is retried and the body arrives once."""
    def run(ns):
        rx = _Receiver(fail_first=1)
        try:
            send = ns.deliver.http_transport(timeout_s=2.0)
            with pytest.raises(Exception):
                send(rx.url + "/hook", {"k": 0}, {"X-A": "1"})
            send(rx.url + "/hook", {"k": 1}, {"X-A": "1"})
            log = ns.push.DeliveryLog()
            pool = ns.push.DeliveryPool(
                log, workers=1, transport=send,
                retry=ns.chaos.RetryPolicy(base_s=0.001, cap_s=0.002,
                                           seed=1))
            pool.start()
            log.enqueue("u", rx.url + "/n", {"k": 2})
            assert _wait(lambda: pool.delivered == 1)
            pool.close()
            log.close()
            return [(p, h.get("content-type"), h.get("x-a"),
                     h.get("x-dss-notification-id"), b)
                    for p, h, b in rx.got]
        finally:
            rx.close()

    assert both(run) == [("/hook", "application/json", "1", None, {"k": 1}),
                         ("/n", "application/json", None, "1", {"k": 2})]


# ---------------------------------------------------------------------------
# 4. match: bit identity vs the host oracle
# ---------------------------------------------------------------------------


def mk_scd_sub(ns, id, owner="uss1", cells=None, *, alt_lo=None,
               alt_hi=None, hours=6, ops=True, csts=False, start=T0):
    return ns.scdm.Subscription(
        id=id, owner=owner, start_time=start,
        end_time=start + timedelta(hours=hours),
        altitude_lo=alt_lo, altitude_hi=alt_hi,
        base_url=f"https://{owner}.example.com",
        notify_for_operations=ops, notify_for_constraints=csts,
        cells=CELLS_A if cells is None else cells,
    )


def _seeded_store(ns, storage):
    clock = ns.FakeClock(T0)
    store = ns.store(storage, clock)
    store.scd.upsert_subscription(mk_scd_sub(ns, SID % 1, owner="uss1"))
    store.scd.upsert_subscription(
        mk_scd_sub(ns, SID % 2, owner="uss2", cells=CELLS_B))
    store.scd.upsert_subscription(
        mk_scd_sub(ns, SID % 3, owner="uss3", alt_lo=0.0, alt_hi=60.0))
    store.scd.upsert_subscription(
        mk_scd_sub(ns, SID % 4, owner="uss4", hours=1))  # expires early
    store.scd.upsert_subscription(
        mk_scd_sub(ns, SID % 5, owner="uss5", cells=CELLS_FAR))
    doomed, _ = store.scd.upsert_subscription(
        mk_scd_sub(ns, SID % 6, owner="uss6"))
    store.scd.delete_subscription(doomed.id, "uss6", doomed.version)
    return store, clock


NOW_NS = int(T0.timestamp() * 1e9)
QUERIES = [
    (CELLS_A, None, None, None, None),
    (CELLS_B, None, None, None, None),
    (CELLS_FAR, None, None, None, None),
    (CELLS_A, 100.0, 200.0, None, None),  # above sub 3's band
    (CELLS_A, 0.0, 50.0, None, None),  # inside it
    (CELLS_A, None, None,
     int((T0 + timedelta(hours=2)).timestamp() * 1e9),
     int((T0 + timedelta(hours=3)).timestamp() * 1e9)),  # sub 4 expired
]


@pytest.mark.parametrize("storage", ["memory", "device"])
def test_match_bit_identical_to_oracle(storage):
    def run(ns):
        store, _ = _seeded_store(ns, storage)
        stage = ns.push.MatchStage(store.scd._sub_index, health=store.health)
        got = stage.match_many(QUERIES, now_ns=NOW_NS)
        want = stage.oracle_many(QUERIES, now_ns=NOW_NS)
        assert got == want
        store.close()
        return got

    got = both(run)
    assert got[0] and SID % 6 not in got[0]  # tombstone filtered
    assert got[2] == [SID % 5]  # spatial isolation
    assert got[4] != got[3]  # the altitude band discriminates


def test_match_fault_absorbed_onto_oracle():
    def run(ns):
        store, _ = _seeded_store(ns, "device")
        stage = ns.push.MatchStage(store.scd._sub_index, health=store.health)
        q = [(CELLS_A, None, None, None, None)]
        want = stage.oracle_many(q, now_ns=NOW_NS)
        ns.chaos.install_plan(ns.chaos.FaultPlan.from_dict({
            "seed": 3, "events": [{"site": "push.match", "count": 1}],
        }))
        got = stage.match_many(q, now_ns=NOW_NS)
        assert got == want
        out = (got, stage.stats())
        ns.chaos.clear_plan()
        store.close()
        return out

    got, stats = both(run)
    assert stats["match_absorbed"] == 1


def test_match_feeds_stage_duration_histogram():
    def run(ns):
        store, _ = _seeded_store(ns, "memory")
        reg = ns.Metrics()
        stage = ns.push.MatchStage(store.scd._sub_index, health=store.health,
                                   metrics=reg)
        stage.match_many([(CELLS_A, None, None, None, None)] * 3,
                         now_ns=NOW_NS)
        snap = reg.stage_hist_snapshot()
        counts, sum_s, cnt = snap[("push", "push_match_ms")]
        assert sum_s > 0.0
        silent = ns.push.MatchStage(store.scd._sub_index, health=store.health)
        silent.match_many([(CELLS_A, None, None, None, None)], now_ns=NOW_NS)
        store.close()
        return sorted(snap), cnt, len(counts)

    keys, cnt, n_buckets = both(run)
    assert ("push", "push_match_ms") in keys and cnt == 1


@pytest.mark.parametrize("storage", ["memory", "device"])
def test_write_path_responses_unchanged_by_push(storage):
    def run(ns):
        plain = ns.store(storage, ns.FakeClock(T0))
        pushed = ns.store(storage, ns.FakeClock(T0))
        pushed.attach_push(ns.push.PushPipeline(
            workers=1, transport=lambda *a: None))
        for store in (plain, pushed):
            store.scd.upsert_subscription(
                mk_scd_sub(ns, SID % 1, owner="uss1"))
            store.scd.upsert_subscription(
                mk_scd_sub(ns, SID % 2, owner="uss2", cells=CELLS_B))
        op = ns.scdm.Operation(
            id=SID % 9, owner="writer", start_time=T0,
            end_time=T0 + timedelta(hours=1), altitude_lower=50.0,
            altitude_upper=120.0, state=ns.scdm.OperationState.ACCEPTED,
            cells=CELLS_A, subscription_id=SID % 1,
        )
        _, subs_plain = plain.scd.upsert_operation(dataclasses.replace(op), [])
        _, subs_push = pushed.scd.upsert_operation(dataclasses.replace(op), [])
        key = lambda s: (s.id, s.notification_index)  # noqa: E731
        assert sorted(map(key, subs_plain)) == sorted(map(key, subs_push))
        plain.close()
        pushed.close()
        return sorted(map(key, subs_push))

    assert both(run)


def _seeded_sub_table(ns, storage, seed, n=160):
    """A store with n SCD subscriptions drawn from a seed: covering
    slices of two neighbouring areas, open or bounded altitude bands,
    1-8 h windows starting up to 3 h either side of T0, a few deleted;
    and the rng's matching write volumes."""
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([CELLS_A, CELLS_B]))
    store = ns.store(storage, ns.FakeClock(T0))
    for i in range(n):
        lo = int(rng.integers(0, len(pool) - 4))
        cells = pool[lo: lo + int(rng.integers(1, 12))]
        band = rng.random() < 0.6
        alo = float(rng.uniform(0, 2000)) if band else None
        start = T0 + timedelta(minutes=int(rng.integers(-180, 180)))
        hours = int(rng.integers(1, 9))
        sub, _ = store.scd.upsert_subscription(mk_scd_sub(
            ns, str(uuid.UUID(int=1000 + i, version=4)), owner=f"uss{i % 7}",
            cells=cells, alt_lo=alo, alt_hi=None if alo is None else alo + 300,
            hours=hours, start=start,
        ))
        if i % 23 == 5 and start + timedelta(hours=hours) > T0:
            store.scd.delete_subscription(sub.id, sub.owner, sub.version)
    queries = []
    for _ in range(40):
        lo = int(rng.integers(0, len(pool) - 4))
        cells = pool[lo: lo + int(rng.integers(1, 40))]
        alo = float(rng.uniform(0, 2000)) if rng.random() < 0.5 else None
        t0 = (NOW_NS + int(rng.integers(-4, 6)) * 3_600_000_000_000
              if rng.random() < 0.5 else None)
        queries.append((cells, alo, None if alo is None else alo + 150,
                        t0, None if t0 is None else t0 + 3_600_000_000_000))
    return store, queries


@pytest.mark.parametrize("storage", ["memory", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_stage_parity_on_a_seeded_table(storage, seed):
    """MatchStage on a seeded subscription table: the port's rqmatch
    plans and ids equal the reference's MatchStage on the same table,
    and the oracle, batch by batch and one write at a time."""
    def run(ns):
        store, queries = _seeded_sub_table(ns, storage, seed)
        stage = ns.push.MatchStage(store.scd._sub_index, health=store.health)
        batched = stage.match_many(queries, now_ns=NOW_NS)
        singles = [stage.match(*q, now_ns=NOW_NS) for q in queries[:8]]
        assert batched == stage.oracle_many(queries, now_ns=NOW_NS)
        assert singles == batched[:8]
        plans = store.stats().get("dss_dar_scd_sub_co_plan_rqmatch", 0)
        store.close()
        return batched, stage.stats(), plans

    batched, stats, plans = both(run)
    assert sum(map(len, batched)) > 40
    assert stats["match_queries"] == 48
    assert plans == (0 if storage == "memory" else 9)


# ---------------------------------------------------------------------------
# 5. pipeline: store integration, QoS, health, federation ingest
# ---------------------------------------------------------------------------


def _pushed_store(ns, storage="device", **pipe_kw):
    store = ns.store(storage, ns.FakeClock(T0))
    pipe_kw.setdefault("workers", 2)
    pipe_kw.setdefault("transport", lambda *a: None)
    pipe = ns.push.PushPipeline(**pipe_kw)
    store.attach_push(pipe)
    return store, pipe


def _op(ns, state="Accepted", sub=SID % 1):
    return ns.scdm.Operation(
        id=SID % 9, owner="writer", start_time=T0,
        end_time=T0 + timedelta(hours=1), state=state,
        cells=CELLS_A, subscription_id=sub,
    )


def test_offer_routes_only_registered_hooks():
    def run(ns):
        got = []
        store, pipe = _pushed_store(
            ns, transport=lambda url, body, hdrs: got.append((url, body)))
        pipe.register_hook("uss1", "http://uss1/notify")
        store.scd.upsert_subscription(mk_scd_sub(ns, SID % 1, owner="uss1"))
        store.scd.upsert_subscription(mk_scd_sub(ns, SID % 2, owner="uss2"))
        store.scd.upsert_operation(_op(ns), [])
        assert pipe.drain(5.0)
        assert _wait(lambda: pipe.pool.delivered == 1)
        out = (got, pipe.skipped, pipe.log.stats())
        store.close()
        return out

    got, skipped, qstats = both(run)
    url, body = got[0]
    assert url == "http://uss1/notify" and body["trigger"] == "operations"
    assert body["entity"]["id"] == SID % 9
    assert body["subscription"]["notification_index"] == 1
    assert skipped == 1 and qstats["acked"] == 1


def test_emergency_operation_rides_emergency_band():
    def run(ns):
        store, pipe = _pushed_store(ns)
        bands = []
        orig = pipe.log.enqueue

        def spy(uss, target, body, *, qos="bulk", traceparent=""):
            bands.append(qos)
            return orig(uss, target, body, qos=qos, traceparent=traceparent)

        pipe.log.enqueue = spy
        pipe.register_hook("uss1", "http://uss1/notify", qos="bulk")
        store.scd.upsert_subscription(mk_scd_sub(ns, SID % 1, owner="uss1"))
        store.scd.upsert_operation(
            _op(ns, state=ns.scdm.OperationState.CONTINGENT), [])
        store.close()
        return bands

    assert both(run) == ["emergency"]


def test_constraint_notify_flag_respected():
    def run(ns):
        got = []
        store, pipe = _pushed_store(
            ns, transport=lambda url, body, hdrs: got.append(body))
        pipe.register_hook("uss1", "http://uss1/n")
        pipe.register_hook("uss2", "http://uss2/n")
        store.scd.upsert_subscription(
            mk_scd_sub(ns, SID % 1, owner="uss1", ops=True, csts=False))
        store.scd.upsert_subscription(
            mk_scd_sub(ns, SID % 2, owner="uss2", ops=False, csts=True))
        store.scd.upsert_constraint(ns.scdm.Constraint(
            id=SID % 8, owner="authority", start_time=T0,
            end_time=T0 + timedelta(hours=1), cells=CELLS_A,
        ))
        assert pipe.drain(5.0) and _wait(lambda: pipe.pool.delivered == 1)
        store.close()
        return [(b["trigger"], b["subscription"]["id"]) for b in got]

    assert both(run) == [("constraints", SID % 2)]


def test_rid_isa_write_fans_out():
    def run(ns):
        got = []
        store, pipe = _pushed_store(
            ns, transport=lambda url, body, hdrs: got.append(body))
        pipe.register_hook("uss2", "http://uss2/n")
        store.rid.insert_subscription(ns.ridm.Subscription(
            id="00000000-0000-4000-8000-00000000s001", owner="uss2",
            url="https://uss2.example.com/isas", cells=CELLS_A,
            start_time=T0, end_time=T0 + timedelta(hours=4),
        ))

        class ISA:
            id = "isa-1"
            owner = "uss1"
            ovn = ""
            cells = CELLS_A

        bumped = store.rid.update_notification_idxs_in_cells(
            CELLS_A, entity=ISA())
        assert pipe.drain(5.0) and _wait(lambda: pipe.pool.delivered == 1)
        plans = store.stats()["dss_dar_rid_sub_co_plan_rqmatch"]
        store.close()
        return [s.notification_index for s in bumped], got, plans

    idx, got, plans = both(run)
    assert idx == [1] and plans == 1
    assert got[0]["trigger"] == "rid" and got[0]["entity"]["id"] == "isa-1"


def test_pipeline_health_saturation_edge():
    def run(ns):
        store, pipe = _pushed_store(ns, max_depth=10)
        pipe.pool.close()  # deterministic depth: no workers draining
        pipe.register_hook("uss1", "http://u/n")
        for i in range(9):
            pipe.log.enqueue("uss1", "http://u/n", {"i": i})
        pipe._update_health()
        entered = (store.health.mode(), store.health.mode_name())
        while (n := pipe.log.take(timeout_s=0)) is not None:
            pipe.log.ack(n.nid)
        pipe._update_health()
        out = (entered, store.health.mode_name())
        store.close()
        return out

    entered, after = both(run)
    assert entered == (p_chaos.PUSH_DEGRADED, "push_degraded")
    assert after == "healthy"


def test_pipeline_stats_stable_key_set():
    def run(ns):
        store, pipe = _pushed_store(ns)
        assert set(pipe.stats()) == set(ns.push.empty_stats())
        bare = ns.store("memory", ns.FakeClock(T0))
        bare_keys = {k for k in bare.stats() if k.startswith("dss_push_")}
        assert bare_keys == set(ns.push.empty_stats())
        assert bare.freshness_status()["push"] is None
        status = store.freshness_status()["push"]
        keyset = (sorted(pipe.stats()),
                  sorted(k for k in store.stats() if k.startswith("dss_push_")),
                  sorted(status), sorted(status["match"]))
        bare.close()
        store.close()
        return keyset

    got = both(run)
    assert got[1] == got[0]


def test_empty_stats_equal_the_references():
    assert p_push.empty_stats() == r_push.empty_stats()
    assert list(p_push.empty_stats()) == list(r_push.empty_stats())
    port = PDSSStore(storage="memory")
    ref = RDSSStore(storage="memory")
    try:
        pk = [k for k in port.stats() if k.startswith("dss_push_")]
        rk = [k for k in ref.stats() if k.startswith("dss_push_")]
        assert pk == rk
        assert {k: port.stats()[k] for k in pk} == r_push.empty_stats()
    finally:
        port.close()
        ref.close()


def test_ingest_remote_matches_without_bump():
    def run(ns):
        got = []
        store, pipe = _pushed_store(
            ns, transport=lambda url, body, hdrs: got.append(body))
        pipe.register_hook("uss1", "http://uss1/n")
        stored, _ = store.scd.upsert_subscription(
            mk_scd_sub(ns, SID % 1, owner="uss1"))
        out = pipe.ingest_remote({
            "trigger": "operations",
            "entity": {"id": "remote-op", "owner": "remote-uss"},
            "cells": [int(c) for c in np.asarray(CELLS_A, np.uint64)],
            "origin": "eu-west",
        })
        assert pipe.drain(5.0) and _wait(lambda: pipe.pool.delivered == 1)
        after = store.scd.get_subscription(SID % 1, "uss1")
        res = (out, got, after.notification_index
               == stored.notification_index, pipe.fed_ingested)
        store.close()
        return res

    out, got, same_index, ingested = both(run)
    assert out == {"matched": 1, "enqueued": 1}
    assert got[0]["entity"]["origin"] == "eu-west"
    assert same_index and ingested == 1


def test_offer_forwards_to_federation_peers():
    def run(ns):
        store, pipe = _pushed_store(ns)
        pipe.pool.close()  # keep the pseudo-notification queued

        class FakeFed:
            region_id = "us-west"
            peers = {"eu-west": object()}

        store.federation = FakeFed()
        store.scd.upsert_subscription(mk_scd_sub(ns, SID % 1, owner="uss1"))
        store.scd.upsert_operation(_op(ns), [])
        n = pipe.log.take(timeout_s=0)
        out = (pipe.fed_forwarded, n.uss, n.target, n.body)
        store.federation = None
        store.close()
        return out

    fwd, uss, target, body = both(run)
    assert (fwd, uss, target) == (1, "@region:eu-west", "eu-west")
    assert body["origin"] == "us-west" and body["cells"]


# ---------------------------------------------------------------------------
# 6. the crash drill in miniature, and the exit
# ---------------------------------------------------------------------------


def test_worker_crash_zero_acked_loss(tmp_path):
    def run(ns):
        path = str(tmp_path / f"{ns.name}.wal")
        log = ns.push.DeliveryLog(path)
        received = []
        lock = threading.Lock()

        def transport(url, body, hdrs):
            with lock:
                received.append(body["i"])

        pool = _pool(ns, log, transport)
        pool.start()
        for i in range(50):
            log.enqueue("u", "http://u/n", {"i": i})
        _wait(lambda: pool.delivered >= 20)
        pool.close()  # SIGKILL stand-in: workers gone mid-queue
        log.sync()
        acked_before = log.stats()["acked"]
        log2 = ns.push.DeliveryLog(path)
        assert log2.depth() == 50 - acked_before
        pool2 = _pool(ns, log2, transport)
        pool2.start()
        assert _wait(lambda: log2.depth() == 0)
        pool2.close()
        log2.close()
        return sorted(set(received))

    assert both(run) == list(range(50))


def test_store_close_joins_the_delivery_workers():
    """close() stops and joins the pool before the store's indexes go:
    no delivery thread outlives the store."""
    store, pipe = _pushed_store(PORT)
    threads = list(pipe.pool._threads)
    assert threads and all(t.is_alive() for t in threads)
    store.close()
    assert not any(t.is_alive() for t in threads)
    assert pipe.pool._threads == []


def test_attach_twice_raises():
    store, pipe = _pushed_store(PORT, storage="memory")
    try:
        with pytest.raises(RuntimeError, match="already attached"):
            store.attach_push(PORT.push.PushPipeline(workers=1))
    finally:
        store.close()


def test_fanout_recipe_small():
    """The reference's fan-out recipe (bench.py _fanout_store) at a
    small size on the device backend: one ISA write matched against
    every subscription through the rqmatch route, every notification
    delivered and acked, nothing dropped or parked."""
    def run(ns):
        delivered = []
        dlock = threading.Lock()

        def transport(url, body, headers):
            with dlock:
                delivered.append(body["subscription"]["id"])

        store = ns.store("device", ns.FakeClock(T0))
        pipe = ns.push.PushPipeline(workers=2, transport=transport)
        store.attach_push(pipe)
        for u in range(4):
            pipe.register_hook(f"uss{u}", f"https://uss{u}.example/notify")
        area = np.unique(np.concatenate([CELLS_A, CELLS_B]))
        for k in range(96):
            lo = k % max(1, len(area) - 8)
            assert store.rid.insert_subscription(ns.ridm.Subscription(
                id=str(uuid.UUID(int=10_000 + k, version=4)),
                owner=f"uss{k % 4}", url=f"https://uss{k % 4}.example/n",
                cells=area[lo:lo + 8], start_time=T0,
                end_time=T0 + timedelta(hours=23),
                altitude_lo=0.0, altitude_hi=3000.0,
            )) is not None
        ids = []
        for _ in range(3):
            ids.append(sorted(s.id for s in store.rid
                              .update_notification_idxs_in_cells(area)))
        assert pipe.drain(10.0)
        assert _wait(lambda: pipe.pool.delivered == 3 * 96)
        ps = pipe.stats()
        out = (ids, sorted(delivered), ps["dss_push_acked_total"],
               ps["dss_push_dropped_total"], ps["dss_push_parked_total"],
               store.stats()["dss_dar_rid_sub_co_plan_rqmatch"])
        store.close()
        return out

    ids, delivered, acked, dropped, parked, plans = both(run)
    assert all(len(i) == 96 for i in ids) and len(delivered) == 3 * 96
    assert (acked, dropped, parked, plans) == (3 * 96, 0, 0, 3)


# ---------------------------------------------------------------------------
# 7. the server binary with --push
# ---------------------------------------------------------------------------


def test_server_boots_with_push_and_answers_status(tmp_path):
    """`python -m dss_tpu_torch.cmds.server --push` on the plain
    versions: a webhook registered over HTTP receives the ISA write's
    notification, /aux/v1/push/status and /metrics show it, and SIGTERM
    stops the process cleanly (delivery workers joined)."""
    from tests.e2e.conftest import free_port
    from tests.e2e.test_blackbox import isa_params

    rx = _Receiver()
    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("DSS_")}
    env.update(DSS_PUSH_WORKERS="2", DSS_RES_BATCH_BUCKETS="128",
               DSS_RES_WINDOW_BUCKETS="256", DSS_CO_RES_INFLIGHT="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--storage", "cuda",
         "--device", "cpu", "--insecure_no_auth", "--push", "--no_warmup",
         "--wal_path", str(tmp_path / "dss.wal"), "--shutdown_grace", "3"],
        cwd=str(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-3000:]
            try:
                if requests.get(f"{base}/healthy", timeout=1).ok:
                    break
            except requests.RequestException:
                pass
            assert time.monotonic() < deadline, "server never answered"
            time.sleep(0.1)
        r = requests.put(f"{base}/aux/v1/push/hooks/anonymous",
                         json={"url": rx.url + "/notify", "qos": "bulk"},
                         timeout=5)
        assert r.status_code == 200, r.text
        assert r.json() == {"uss": "anonymous", "url": rx.url + "/notify",
                            "qos": "bulk"}
        sub_id, isa_id = str(uuid.uuid4()), str(uuid.uuid4())
        r = requests.put(f"{base}/v1/dss/subscriptions/{sub_id}", json={
            "extents": isa_params()["extents"],
            "callbacks": {"identification_service_area_url":
                          "https://u2.example.com/isa"},
        }, timeout=10)
        assert r.status_code == 200, r.text
        r = requests.put(f"{base}/v1/dss/identification_service_areas/"
                         f"{isa_id}", json=isa_params(), timeout=10)
        assert r.status_code == 200, r.text
        subs = r.json()["subscribers"]
        assert subs[0]["subscriptions"][0]["notification_index"] == 1
        assert _wait(lambda: len(rx.got) == 1, 10.0)
        path, hdrs, body = rx.got[0]
        assert path == "/notify" and body["trigger"] == "rid"
        assert body["entity"]["id"] == isa_id
        assert body["subscription"] == {"id": sub_id,
                                        "notification_index": 1}
        # the receiver has the POST before the worker acks it
        status = f"{base}/aux/v1/push/status"
        assert _wait(lambda: requests.get(status, timeout=5).json()[
            "delivered"] == 1, 10.0)
        st = requests.get(status, timeout=5).json()
        assert st["delivered"] == 1 and st["queue"]["acked"] == 1
        assert st["hooks"] == {"anonymous": {"url": rx.url + "/notify",
                                             "qos": "bulk"}}
        assert st["match"]["rid_sub"]["match_queries"] >= 1
        m = requests.get(f"{base}/metrics", timeout=5).text
        assert "dss_push_delivered_total 1" in m
        assert "dss_dar_rid_sub_co_plan_rqmatch 1" in m
    finally:
        t0 = time.monotonic()
        proc.terminate()
        try:
            rc = proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
        rx.close()
    err = proc.stderr.read().decode(errors="replace")
    assert rc == 0 and time.monotonic() - t0 < 10, err[-3000:]
    assert "Traceback" not in err and "push pipeline: 2 delivery" in err

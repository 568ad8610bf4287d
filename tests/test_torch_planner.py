"""The port's plan layer (dss_tpu_torch/plan) against the reference's.

The same numpy-seeded draws of (BatchShape, ModelState, headroom) go
through both `decide`s, both drain caps and both Retry-After
throughputs: every Plan is equal field for field.  The live halves —
CostModel EWMAs and Planner counters — take the same observation
sequences and end in equal state, float for float.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from dss_tpu import plan as ref_plan
from dss_tpu.plan import costs as ref_costs

from dss_tpu_torch import plan
from dss_tpu_torch.plan import costs


def _draws(seed: int, count: int):
    """Seeded decision inputs over the full range of every estimate,
    pressure counter, availability flag and shape field.  -> (state
    kwargs, shape kwargs, headroom_ms)."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        floor = float(10 ** rng.uniform(-1.3, 2.7))
        st = dict(
            est_floor_ms=floor,
            est_item_ms=float(10 ** rng.uniform(-4, -1.3)),
            est_chunk_ms=float(10 ** rng.uniform(-2, 1.7)),
            est_res_floor_ms=float(max(0.02, floor * rng.uniform(0.02, 1.5))),
            est_res_lat_ms=float(max(0.02, floor * rng.uniform(0.1, 2.0))),
            est_rq_floor_ms=float(rng.choice([0.0, floor * rng.uniform(0.1, 2)])),
            est_rq_item_ms=float(rng.choice([0.0, 10 ** rng.uniform(-4, -1)])),
            chunk=int(rng.choice([16, 64, 128])),
            inflight_device=int(rng.integers(0, 5)),
            inflight_host_chunks=int(rng.integers(0, 40)),
            inflight_resident=int(rng.integers(0, 8)),
            resident_ready=bool(rng.integers(0, 2)),
            mesh_ready=bool(rng.integers(0, 2)),
            mesh_min=int(rng.choice([32, 64])),
            mesh_max=int(rng.choice([256, 1024])),
            host_only=bool(rng.random() < 0.2),
            boundary_gen=int(rng.integers(0, 4)),
            device_ok=bool(rng.random() < 0.85),
        )
        shape = dict(
            n=int(rng.integers(0, 4097)),
            all_stale=bool(rng.random() < 0.3),
            owner_scoped=bool(rng.random() < 0.3),
            inline=bool(rng.random() < 0.3),
            rqmatch=bool(rng.random() < 0.1),
        )
        headroom = (None if rng.random() < 0.3
                    else float(10 ** rng.uniform(-1, 3.3)))
        yield st, shape, headroom


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decide_identical_to_reference(seed):
    routes = set()
    for st, shape, headroom in _draws(seed, 2500):
        for allow_res in (True, False):
            for allow_mesh in (True, False):
                got = plan.decide(
                    plan.BatchShape(**shape), plan.ModelState(**st),
                    headroom, allow_resident=allow_res,
                    allow_mesh=allow_mesh,
                )
                want = ref_plan.decide(
                    ref_plan.BatchShape(**shape), ref_plan.ModelState(**st),
                    headroom, allow_resident=allow_res,
                    allow_mesh=allow_mesh,
                )
                assert got.to_dict() == want.to_dict(), (st, shape, headroom)
                routes.add(got.route)
    # the draws reach every route a drained batch can take
    assert {"inline", "hostchunk", "device", "resident", "mesh",
            "rqmatch"} <= routes


@pytest.mark.parametrize("seed", [3, 4])
def test_drain_cap_and_backlog_qps_identical(seed):
    p_port = plan.Planner()
    p_ref = ref_plan.Planner()
    for st, shape, headroom in _draws(seed, 2000):
        cur = max(1, shape["n"])
        s_port, s_ref = plan.ModelState(**st), ref_plan.ModelState(**st)
        assert plan.plan_drain_cap(cur, headroom, s_port) == \
            ref_plan.plan_drain_cap(cur, headroom, s_ref)
        assert p_port.backlog_qps(cur, s_port, headroom,
                                  all_stale=shape["all_stale"]) == \
            p_ref.backlog_qps(cur, s_ref, headroom,
                              all_stale=shape["all_stale"])
        for route in plan.ROUTES:
            assert p_port.route_qps(route, cur, s_port) == \
                p_ref.route_qps(route, cur, s_ref)
    assert plan.ROUTES == ref_plan.ROUTES
    assert plan.HEADROOM_SAFETY == ref_plan.HEADROOM_SAFETY


def _model_state(m) -> dict:
    return {k: getattr(m, k) for k in type(m).__slots__}


@pytest.mark.parametrize("seed", [5, 6])
def test_cost_model_updates_identical(seed):
    """The same observation stream (every observe_* kind, reseeds,
    outliers the winsorizer clamps) leaves both models in equal state,
    and both predict the same for every route."""
    rng = np.random.default_rng(seed)
    kw = dict(floor_ms=float(rng.uniform(1, 100)),
              item_ms=float(rng.uniform(0.001, 0.05)),
              chunk_ms=float(rng.uniform(0.05, 2)), chunk=64)
    m, r = costs.CostModel(**kw), ref_costs.CostModel(**kw)
    for step in range(600):
        kind = int(rng.integers(0, 5))
        n = int(rng.integers(1, 4097))
        t = float(10 ** rng.uniform(-1, 3))
        if kind == 0:
            m.observe_device(n, t), r.observe_device(n, t)
        elif kind == 1:
            m.observe_host(n, t), r.observe_host(n, t)
        elif kind == 2:
            lat = None if rng.random() < 0.3 else t * rng.uniform(1, 5)
            m.observe_resident(n, t, lat), r.observe_resident(n, t, lat)
        elif kind == 3:
            m.observe_rqmatch(n, t), r.observe_rqmatch(n, t)
        elif step % 50 == 0:
            seeds = dict(floor_ms=float(rng.uniform(0.1, 50)),
                         res_lat_ms=float(rng.uniform(0.1, 50)))
            m.reseed(**seeds), r.reseed(**seeds)
        assert _model_state(m) == _model_state(r)
        inflight = int(rng.integers(0, 4))
        for fn in ("predict_device_ms", "predict_resident_ms",
                   "predict_resident_latency_ms", "predict_rqmatch_ms",
                   "predict_host_ms"):
            assert getattr(m, fn)(n, inflight) == getattr(r, fn)(n, inflight)
        assert m.min_route_qps(n) == r.min_route_qps(n)
    assert m.device_obs and m.host_obs and m.resident_obs


def test_planner_counters_and_capture_identical():
    """Plans recorded through both Planners land in the same co_plan_*
    counters; capture() freezes equal states from equal models."""
    p_port = plan.Planner(floor_ms=5.0, chunk_ms=0.2)
    p_ref = ref_plan.Planner(floor_ms=5.0, chunk_ms=0.2)
    for st, shape, headroom in _draws(7, 800):
        pressure = {k: st[k] for k in (
            "inflight_device", "inflight_host_chunks", "inflight_resident",
            "resident_ready", "mesh_ready", "mesh_min", "mesh_max",
            "host_only", "boundary_gen", "device_ok")}
        s_port = p_port.capture(**pressure)
        s_ref = p_ref.capture(**pressure)
        assert dataclasses.asdict(s_port) == dataclasses.asdict(s_ref)
        got = p_port.plan(plan.BatchShape(**shape), s_port, headroom)
        want = p_ref.plan(ref_plan.BatchShape(**shape), s_ref, headroom)
        assert got.to_dict() == want.to_dict()
        if shape["n"] % 7 == 0:
            p_port.note_fallback(), p_ref.note_fallback()
        t = float(shape["n"]) / 100 + 1
        p_port.observe_device(shape["n"], t)
        p_ref.observe_device(shape["n"], t)
    assert p_port.stats() == p_ref.stats()

"""The self-tuning loop on the port, held to the reference.

Every case of tests/test_tune.py runs on the port's `dss_tpu_torch.tune`
(the reference test file compiled anew with its imports pointed at the
port).  Where the port's API takes `device=` (the host class a profile
delta is stamped with, `cuda` by default), the copy names the CPU:
`to_profile_delta(device="cpu")`, the rig's controller, `host_class`
and `profile_staleness`, and `autotune(device="cpu")` (whose
measure_device the reference case patches out, as it does for itself).

Then the two packages side by side, compared exactly (these are
deterministic; no tolerance):
- the tuner's vocabulary: KNOB_KEYS, STEP_LIMITS (a subset of
  KNOB_KEYS), HOT_KNOBS, KNOB_TO_CONFIGURE, KNOB_TO_STATE,
  empty_stats() and env_knobs();
- the same cumulative stage histograms give equal fit_stage fits and
  equal Observer windows;
- the same recorded decision trace gives an equal ShadowReport under
  the same knobs;
- bench.py's _TuneWorld fake-clock loop (the tune leg's flip and the
  tune-smoke leg's drill chain), rebuilt over each package's Planner,
  TuneController and chaos plan, gives the same event sequence and the
  same knob timeline, window by window.
Every test leaves both packages' decision hooks cleared.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from dss_tpu import chaos as r_chaos
from dss_tpu import plan as r_plan
from dss_tpu import tune as r_tune
from dss_tpu.obs import metrics as r_metrics
from dss_tpu.plan import autotune as r_autotune
from dss_tpu_torch import chaos as p_chaos
from dss_tpu_torch import plan as p_plan
from dss_tpu_torch import tune as p_tune
from dss_tpu_torch.obs import metrics as p_metrics
from dss_tpu_torch.plan import autotune as p_autotune
from tests.test_torch_region import port_copy

TESTS = Path(__file__).resolve().parent

PORT_CASES = port_copy("test_tune", extra={
    "    d = p.to_profile_delta()":
    '    d = p.to_profile_delta(device="cpu")',
    "            clock=lambda: self.clock,\n        )":
    '            clock=lambda: self.clock, device="cpu",\n        )',
    "    from dss_tpu.plan.autotune import host_class, profile_staleness\n":
    "    from functools import partial\n\n"
    "    from dss_tpu.plan import autotune as _at\n\n"
    '    host_class = partial(_at.host_class, device="cpu")\n'
    '    profile_staleness = partial(_at.profile_staleness, device="cpu")\n',
    "    prof = at.autotune()":
    '    prof = at.autotune(device="cpu")',
})
_COPIED = []
for _k, _fn in list(PORT_CASES.items()):
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = _fn
        _COPIED.append(_k)


@pytest.fixture(autouse=True)
def _no_decision_hook():
    """The decision hook is process-global in each package: clear both
    after every test (the copied rig leaves its controllers armed)."""
    yield
    r_plan.set_decision_hook(None)
    p_plan.set_decision_hook(None)
    r_chaos.clear_plan()
    p_chaos.clear_plan()


def test_every_reference_case_is_here():
    src = (TESTS / "test_tune.py").read_text()
    assert set(re.findall(r"^def (test_\w+)\(", src, re.M)) == set(_COPIED)
    assert len(_COPIED) == 24
    assert PORT_CASES["TuneController"] is p_tune.TuneController


# -- the vocabulary ---------------------------------------------------------


def test_the_same_knobs_maps_and_stats():
    assert p_autotune.KNOB_KEYS == r_autotune.KNOB_KEYS
    assert p_autotune.PROFILE_FORMAT == r_autotune.PROFILE_FORMAT
    assert p_tune.STEP_LIMITS == r_tune.STEP_LIMITS
    assert set(p_tune.STEP_LIMITS) <= set(p_autotune.KNOB_KEYS)
    assert p_tune.HOT_KNOBS == r_tune.HOT_KNOBS
    assert p_tune.KNOB_TO_CONFIGURE == r_tune.KNOB_TO_CONFIGURE
    assert p_tune.KNOB_TO_STATE == r_tune.KNOB_TO_STATE
    assert p_tune.TUNE_FORMAT == r_tune.TUNE_FORMAT
    assert p_tune.empty_stats() == r_tune.empty_stats()
    assert {k: type(v) for k, v in p_tune.empty_stats().items()} == {
        k: type(v) for k, v in r_tune.empty_stats().items()}
    for env in ({}, {"DSS_TUNE": "on", "DSS_TUNE_RING": "64",
                     "DSS_TUNE_GUARD_S": "x", "DSS_TUNE_DEADBAND": "0.1"}):
        assert p_tune.env_knobs(env=env) == r_tune.env_knobs(env=env)
    assert p_tune.__all__ == r_tune.__all__
    assert p_metrics.STAGE_BUCKETS == r_metrics.STAGE_BUCKETS


# -- observer fits ------------------------------------------------------------


def _rows(buckets, durations_ms):
    """Cumulative (counts, sum_s, cnt) as MetricsRegistry accumulates."""
    counts = [0] * len(buckets)
    total = 0.0
    for ms in durations_ms:
        s = ms / 1000.0
        for i, edge in enumerate(buckets):
            if s <= edge:
                counts[i] += 1
        total += s
    return tuple(counts), total, len(durations_ms)


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_fits_and_observer_windows_equal(seed):
    rng = np.random.default_rng(seed)
    buckets = r_metrics.STAGE_BUCKETS
    cum = {("search", "store_ms"): [], ("write", "store_ms"): [],
           ("search", "parse_ms"): []}
    snap = {}
    r_ob = r_tune.Observer(lambda: dict(snap), min_count=60)
    p_ob = p_tune.Observer(lambda: dict(snap), min_count=60)
    r_ob.prime()
    p_ob.prime()
    for w in range(6):
        for key, lst in cum.items():
            n = int(rng.integers(0, 200))
            lst.extend((rng.lognormal(0.5 + w * 0.3, 0.8, n)).tolist())
            snap[key] = _rows(buckets, lst)
        for key, (counts, sum_s, cnt) in snap.items():
            n_mean = float(rng.uniform(64, 4096))
            n_min = float(rng.uniform(1, 64))
            for kw in ({}, {"n_mean": n_mean, "n_min": n_min},
                       {"n_mean": n_mean}):
                r = r_tune.fit_stage(counts, sum_s, cnt, route=key[0],
                                     stage=key[1], **kw)
                p = p_tune.fit_stage(counts, sum_s, cnt, route=key[0],
                                     stage=key[1], **kw)
                assert dataclasses.asdict(p) == dataclasses.asdict(r)
        moments = {"store_ms": (float(rng.uniform(100, 900)),
                                float(rng.uniform(1, 50)))}
        rf, pf = r_ob.observe(moments), p_ob.observe(moments)
        assert {k: dataclasses.asdict(v) for k, v in pf.items()} == {
            k: dataclasses.asdict(v) for k, v in rf.items()}
        assert (p_ob.windows, p_ob.thin_windows) == (
            r_ob.windows, r_ob.thin_windows)


# -- shadow replay ------------------------------------------------------------


def _trace(plan_mod, tune_mod, sizes, headrooms, floor_ms):
    planner = plan_mod.Planner(floor_ms=floor_ms, item_ms=0.002,
                               chunk_ms=0.2, chunk=64)
    rec = tune_mod.DecisionRecorder(512)
    plan_mod.set_decision_hook(rec.record)
    try:
        for i, (n, h) in enumerate(zip(sizes, headrooms)):
            state = planner.capture(device_ok=True,
                                    resident_ready=bool(i % 3 == 0))
            planner.plan(plan_mod.BatchShape(n=int(n), all_stale=h is None),
                         state, h)
            if i % 5 == 0:
                planner.observe_device(int(n), floor_ms / 4 + 0.002 * n)
    finally:
        plan_mod.set_decision_hook(None)
    return rec


@pytest.mark.parametrize("seed", (4, 5))
def test_shadow_reports_equal_on_the_same_trace(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5000, 300)
    headrooms = [None if rng.random() < 0.3 else float(rng.uniform(2, 60))
                 for _ in sizes]
    r_rec = _trace(r_plan, r_tune, sizes, headrooms, 20.0)
    p_rec = _trace(p_plan, p_tune, sizes, headrooms, 20.0)
    assert [e[5:] for e in p_rec.entries()] == [e[5:] for e in
                                                r_rec.entries()]
    assert p_rec.route_mix() == r_rec.route_mix()
    assert p_rec.batch_moments() == r_rec.batch_moments()
    for knobs in ({}, {"DSS_CO_EST_FLOOR_MS": 3.0},
                  {"DSS_CO_EST_CHUNK_MS": 5.0},
                  {"DSS_CO_EST_RES_FLOOR_MS": 0.5,
                   "DSS_CO_EST_ITEM_MS": 0.0005},
                  {"DSS_CO_EST_RES_LAT_MS": 40.0, "DSS_CO_RES_RING": 8.0}):
        for tol in (0.0, 0.10):
            r = r_tune.shadow_eval(r_rec.entries(), knobs, p99_tol=tol)
            p = p_tune.shadow_eval(p_rec.entries(), knobs, p99_tol=tol)
            assert dataclasses.asdict(p) == dataclasses.asdict(r), knobs


# -- bench.py's _TuneWorld over each package ------------------------------------

PKGS = {
    "ref": dict(plan=r_plan, tune=r_tune, chaos=r_chaos,
                buckets=r_metrics.STAGE_BUCKETS, ctl={}),
    "port": dict(plan=p_plan, tune=p_tune, chaos=p_chaos,
                 buckets=p_metrics.STAGE_BUCKETS, ctl={"device": "cpu"}),
}
_RESEED = {
    "DSS_CO_EST_FLOOR_MS": "floor_ms",
    "DSS_CO_EST_ITEM_MS": "item_ms",
    "DSS_CO_EST_CHUNK_MS": "chunk_ms",
    "DSS_CO_EST_RES_FLOOR_MS": "res_floor_ms",
    "DSS_CO_EST_RES_LAT_MS": "res_lat_ms",
}


class TuneWorld:
    """bench.py's _TuneWorld (bench.py:4895) over one package: the real
    planner, cost model and controller, served latency from a fixed
    true-cost table, stage histograms in MetricsRegistry's shape."""

    def __init__(self, pkg, *, boot_floor_ms, true_floor_ms,
                 item_ms=0.002, chunk_ms=0.2, headroom_ms=16.0,
                 feed_ewma=True):
        self.pkg = PKGS[pkg]
        self.planner = self.pkg["plan"].Planner(
            floor_ms=boot_floor_ms, item_ms=item_ms, chunk_ms=chunk_ms,
            chunk=64)
        self.cost = self.planner.cost
        self.feed_ewma = feed_ewma
        self.true_floor_ms = float(true_floor_ms)
        self.true_item_ms = float(item_ms)
        self.true_chunk_ms = float(chunk_ms)
        self.headroom_ms = float(headroom_ms)
        self.buckets = self.pkg["buckets"]
        self._row = [0] * (len(self.buckets) + 2)
        self.clock = 0.0

    def true_ms(self, route, n):
        if route in ("device", "resident", "mesh"):
            return self.true_floor_ms + self.true_item_ms * n
        if route == "inline":
            return 0.05
        return -(-n // 64) * self.true_chunk_ms

    def serve(self, n):
        state = self.planner.capture(device_ok=True)
        plan = self.planner.plan(
            self.pkg["plan"].BatchShape(n=n, all_stale=True), state,
            self.headroom_ms)
        ms = self.true_ms(plan.route, n)
        if self.feed_ewma:
            if plan.route == "device":
                self.cost.observe_device(n, ms)
            elif plan.route == "hostchunk":
                self.cost.observe_host(n, ms)
        s = ms / 1000.0
        for i, b in enumerate(self.buckets):
            if s <= b:
                self._row[i] += 1
        self._row[-2] += s
        self._row[-1] += 1
        return plan.route, ms

    def window(self, sizes):
        lats, mix = [], {}
        for n in sizes:
            route, ms = self.serve(n)
            lats.append(ms)
            mix[route] = mix.get(route, 0) + 1
        lats.sort()
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))], mix

    def hist_provider(self):
        return {("search", "store_ms"): (
            tuple(self._row[:-2]), self._row[-2], self._row[-1])}

    def current_knobs(self):
        return {
            "DSS_CO_EST_FLOOR_MS": self.cost.est_floor_ms,
            "DSS_CO_EST_ITEM_MS": self.cost.est_item_ms,
            "DSS_CO_EST_CHUNK_MS": self.cost.est_chunk_ms,
            "DSS_CO_EST_RES_FLOOR_MS": self.cost.est_res_floor_ms,
            "DSS_CO_EST_RES_LAT_MS": self.cost.est_res_lat_ms,
        }

    def actuate(self, knobs):
        self.cost.reseed(**{_RESEED[k]: v for k, v in knobs.items()})

    def controller(self, **over):
        kw = dict(
            hist_provider=self.hist_provider, actuator=self.actuate,
            current_fn=self.current_knobs, interval_s=30.0, guard_s=30.0,
            min_count=100, deadband=0.25, p99_tol=0.10,
            rollback_frac=1.25, ring=512, clock=lambda: self.clock,
            env={}, **self.pkg["ctl"])
        kw.update(over)
        return self.pkg["tune"].TuneController(**kw)


def _sizes(window_idx, batches, flipped):
    lo, hi = (3072, 5120) if flipped else (64, 256)
    return [lo + ((window_idx * 7919 + i * 523) % (hi - lo + 1))
            for i in range(batches)]


def _flip_timeline(pkg, windows):
    """The tune leg's tuned arm (bench.py tune_leg): poisoned-high boot
    floor, a workload flip after two windows, a tick per window."""
    world = TuneWorld(pkg, boot_floor_ms=20.0, true_floor_ms=2.0)
    ctl = world.controller()
    ctl.start(thread=False)
    out = []
    try:
        for w in range(windows):
            p99, mix = world.window(_sizes(w, 150, w >= 2))
            world.clock += 30.0
            ev = ctl.tick()
            out.append((w, p99, mix, dict(world.current_knobs()), ev))
        return out, ctl.stats()
    finally:
        ctl.close()


def test_tune_world_flip_timelines_equal():
    r_tl, r_stats = _flip_timeline("ref", 18)
    p_tl, p_stats = _flip_timeline("port", 18)
    for r, p in zip(r_tl, p_tl):
        assert p == r, (r[0], r, p)
    assert len(p_tl) == len(r_tl) == 18
    assert p_stats == r_stats
    events = [t[4]["event"] for t in p_tl]
    assert "committed" in events  # the probe walked the floor and held
    assert p_tl[-1][3]["DSS_CO_EST_FLOOR_MS"] < 20.0


def _drill_chain(pkg):
    """bench.py tune_smoke_leg's phases B-D: a faulted apply, a bad
    estimate, a plausible lie rolled back by the guard window."""
    chaos = PKGS[pkg]["chaos"]
    world = TuneWorld(pkg, boot_floor_ms=40.0, true_floor_ms=40.0,
                      feed_ewma=False)
    ctl = world.controller(env={"DSS_CO_EST_FLOOR_MS": "40.0"})
    ctl.start(thread=False)
    out = []
    try:
        out.append(("baseline", world.window(_sizes(0, 150, True))))
        world.clock += 30.0
        out.append(("tick", ctl.tick()))
        chaos.install_plan(chaos.FaultPlan(
            [chaos.FaultEvent("tune.apply", "error", count=1)], seed=11))
        out.append(("faulted", ctl.inject({"DSS_CO_EST_FLOOR_MS": 3.0},
                                          reason="faulted apply")))
        chaos.clear_plan()
        out.append(("knobs", world.current_knobs()))
        out.append(("bad_est", ctl.inject({"DSS_CO_EST_CHUNK_MS": 5.0},
                                          reason="bad est knob")))
        out.append(("lie", ctl.inject({"DSS_CO_EST_FLOOR_MS": 3.0},
                                      reason="optimistic floor")))
        out.append(("bad_window", world.window(_sizes(1, 150, True))))
        world.clock += 30.0
        out.append(("guard", ctl.tick()))
        out.append(("knobs", world.current_knobs()))
        out.append(("recovered", world.window(_sizes(2, 150, True))))
        out.append(("stats", ctl.stats()))
        return out
    finally:
        chaos.clear_plan()
        ctl.close()


def test_tune_world_drill_chains_equal():
    r, p = _drill_chain("ref"), _drill_chain("port")
    assert p == r
    steps = dict((k, v) for k, v in p if k in ("faulted", "bad_est",
                                                "lie", "guard"))
    assert steps["faulted"]["event"] == "apply_failed"
    assert steps["bad_est"]["event"] == "shadow_rejected"
    assert steps["lie"]["event"] == "applied"
    assert steps["guard"]["event"] == "rollback"
    assert steps["guard"]["reason"] == "p99_regression"

"""The offline autotune sweep on the port, held to the reference.

Both packages side by side, on the CPU (the reference on JAX's CPU, the
port with `device="cpu"`, where B1's plain version answers):
- `scenario_shapes` is equal (the scenario generator and the covering
  are ports of the reference's);
- `capacity_vector`, `load_profile`, `apply_profile` and
  `profile_staleness` give equal results and raise alike on the same
  inputs;
- `host_class(device="cpu")` equals the reference's on JAX's CPU, so
  the shipped deploy/autotune/cpu-cpu-c2.json matches the same hosts in
  both packages, and it loads and applies identically;
- `autotune(quick=True, device="cpu")` emits a profile whose key set,
  knob key set and value types (nested too) equal the reference's quick
  profile; timings differ by design and are never compared;
- the resident measurement's depth ladder replays every submit through
  its one reserved graph-cache entry (no miss, no busy unit, no
  eviction), the deepest rung included;
- `autotune()` and `host_class()` without `device=` raise on a machine
  without a card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.plan import autotune as r_at
from dss_tpu_torch.ops import resident as p_resident
from dss_tpu_torch.plan import autotune as p_at

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "deploy" / "autotune" / "cpu-cpu-c2.json"


@pytest.mark.parametrize("kw", [
    dict(scale=0.02, duration_s=4.0),
    dict(),
    dict(seed=3, scale=0.05, duration_s=6.0, names=["corridors", "diurnal"]),
])
def test_scenario_shapes_equal(kw):
    assert p_at.scenario_shapes(**kw) == r_at.scenario_shapes(**kw)


def test_capacity_vector_equal_and_refuses_alike():
    a = {"capacity_weight": 60000.0, "capacity_basis": "scenario-mix"}
    b = {"capacity_weight": 59000.5, "capacity_basis": "scenario-mix"}
    legacy = {"capacity_weight": 122.0}
    np.testing.assert_array_equal(p_at.capacity_vector([a, b]),
                                  r_at.capacity_vector([a, b]))
    assert p_at.capacity_vector([legacy]).dtype == np.float64
    for bad, what in (([a, legacy], "mixed capacity_basis"),
                      ([], "no profiles")):
        for at in (p_at, r_at):
            with pytest.raises(ValueError, match=what):
                at.capacity_vector(bad)


def test_host_class_on_the_cpu_equals_the_reference():
    assert p_at.host_class(device="cpu") == r_at.host_class()
    assert p_at.host_class(device="cpu").startswith("cpu-cpu-c")
    assert p_at.default_profile_path("d", device="cpu") == (
        r_at.default_profile_path("d"))


def _profiles(tmp_path):
    """Profiles the two packages must read alike: the shipped one, a
    fresh stamped one from another host class, an unstamped one with a
    stray knob, a newer format and a file without knobs."""
    fresh = json.loads(SHIPPED.read_text())
    fresh.update(measured_at=1_700_000_000.0,
                 host_class=r_at.host_class())
    stray = {"host_class": "gpu-NVIDIA-H100-80GB-HBM3-c8",
             "measured_at": "not a time",
             "knobs": {"DSS_CO_EST_FLOOR_MS": 0.3, "PATH": "/x",
                       "DSS_SHM_DEPTH": 64}}
    paths = {}
    for name, prof in (("fresh", fresh), ("stray", stray),
                       ("newer", {"format": 2, "knobs": {}}),
                       ("noknobs", {"format": 1})):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(prof))
    paths["shipped"] = SHIPPED
    return paths


def test_profiles_load_apply_and_age_alike(tmp_path):
    for name, path in _profiles(tmp_path).items():
        if name in ("newer", "noknobs"):
            for at in (p_at, r_at):
                with pytest.raises(ValueError, match="format 2|no knobs"):
                    at.load_profile(str(path))
            continue
        r, p = r_at.load_profile(str(path)), p_at.load_profile(str(path))
        assert p == r
        for env in ({}, {"DSS_CO_EST_FLOOR_MS": "7", "DSS_SHM_DEPTH": "8"}):
            r_env, p_env = dict(env), dict(env)
            assert p_at.apply_profile(p, env=p_env) == (
                r_at.apply_profile(r, env=r_env))
            assert p_env == r_env
            assert set(p_env) <= set(env) | set(p_at.KNOB_KEYS)
        for now in (1_700_000_000.0, 1_700_000_000.0 + 40 * 86400.0):
            assert p_at.profile_staleness(p, now=now, device="cpu") == (
                r_at.profile_staleness(r, now=now))


def test_the_shipped_profile_matches_the_same_hosts(tmp_path):
    prof = p_at.load_profile(str(SHIPPED))
    st = p_at.profile_staleness(prof, device="cpu")
    assert st == r_at.profile_staleness(r_at.load_profile(str(SHIPPED)),
                                        now=None) | {"age_s": st["age_s"]}
    assert st["host_class_match"] == (
        r_at.host_class() == prof["host_class"])
    env = {}
    assert p_at.apply_profile(prof, env=env) == {
        k: str(v) for k, v in prof["knobs"].items()}
    # a save and a load are a round trip, in both packages' format
    out = p_at.save_profile(prof, str(tmp_path / "p" / "c.json"))
    assert r_at.load_profile(out) == prof


def _shape(x):
    """A profile's structure: keys and value types, nested."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    return type(x).__name__


def test_quick_profile_has_the_reference_shape():
    r = r_at.autotune(quick=True)
    p = p_at.autotune(quick=True, device="cpu")
    assert set(p) == set(r)
    assert set(p["knobs"]) == set(r["knobs"]) == set(p_at.KNOB_KEYS)
    assert _shape(p) == _shape(r)
    for k in ("format", "host_class", "quick", "fixture", "capacity_basis"):
        assert p[k] == r[k], k
    # the grids and the shape-derived knobs are not timings
    for k in ("DSS_RES_BATCH_BUCKETS", "DSS_RES_WINDOW_BUCKETS",
              "DSS_SHARD_RESULTS"):
        assert p["knobs"][k] == r["knobs"][k], k
    assert p["measurements"]["hit_concentration"] == (
        r["measurements"]["hit_concentration"])
    assert p["measurements"]["scenario"]["shapes"] == (
        r["measurements"]["scenario"]["shapes"])


def test_resident_ladder_replays_every_submit(monkeypatch):
    """measure_resident's ladder submits `d` batches before any collect:
    the one warmed entry holds a unit for each, so no submit misses,
    finds its entry busy or launches eagerly, and the reserved entry is
    never evicted (DSS_RES_AOT_CAP cannot take it mid-ladder)."""
    kernels = []

    class Recording(p_resident.ResidentKernel):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kernels.append(self)

    monkeypatch.setattr(p_resident, "ResidentKernel", Recording)
    cache = p_resident.graph_cache()
    evictions = cache.evictions
    table = p_at._fixture(2_000, 2_000, device="cpu")
    try:
        ft = table._state.snap.fast
        depths = (2, 4, 8, 16)
        res = p_at.measure_resident(ft, 2_000, depths=depths)
        (kern,) = kernels
        assert kern.misses == 0 and kern.busy == 0
        assert kern.hits == 1 + 4 + sum(depths)  # warm, latency, ladder
        assert kern.instances == max(depths)
        assert cache.evictions == evictions
        assert set(res["gap_ms_by_depth"]) == {str(d) for d in depths}
        assert res["inflight"] in depths
    finally:
        table.close()


def test_the_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: p_at.autotune(quick=True), p_at.host_class,
                 lambda: p_at.profile_staleness({})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()

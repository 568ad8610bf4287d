"""The cases of tests/test_auth.py, tests/test_metrics.py and
tests/test_log_format.py on the port's modules.

Each reference test file is compiled anew with its imports pointed at
the port (`dss_tpu.` -> `dss_tpu_torch.`), and every test function of
that copy is collected here under its own name, with its own fixtures
and assertions: JWT sign/verify and claims rules, scope validators,
key resolution and rotation, the signature cache (auth/); the metrics
registry's exposition (obs/metrics.py); and the WAL's format gate
(dar/wal.py).  The follower's log tail is the port's
`dar/follower._WalTail` (the reference's lives in
`parallel/replica.py`).  `test_region_log_compaction_carries_format`
drives the port's region log (region/log_server.py).

Then a few checks that hold the port's exposition and access log
against the reference's on the same observations.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest

from dss_tpu.obs import logging as r_logging
from dss_tpu.obs.metrics import MetricsRegistry as RMetrics
from dss_tpu.obs.metrics import stage_hist_delta as r_delta
from dss_tpu_torch.obs import logging as p_logging
from dss_tpu_torch.obs.metrics import MetricsRegistry, stage_hist_delta

TESTS = Path(__file__).resolve().parent
# module paths of the reference that live elsewhere in the port
MOVED = {"dss_tpu.parallel.replica": "dss_tpu_torch.dar.follower"}
LEFT_OUT = {}


def _port_copy(name: str) -> dict:
    """The reference test module `name`, compiled with its imports on
    the port -> its namespace."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in MOVED.items():
        src = src.replace(old, new)
    src = re.sub(r"\bdss_tpu\.", "dss_tpu_torch.", src)
    src = re.sub(r"\bfrom dss_tpu import\b", "from dss_tpu_torch import",
                 src)
    ns = {"__name__": f"tests.{name}_on_the_port", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    assert "dss_tpu." not in src.replace("dss_tpu_torch.", "")
    return ns


_COPIED = []
for _name in ("test_auth", "test_metrics", "test_log_format"):
    try:
        _ns = _port_copy(_name)
    except pytest.skip.Exception:  # test_auth without `cryptography`
        continue
    for _k, _fn in _ns.items():
        if _k.startswith("test_") and callable(_fn) and _k not in LEFT_OUT:
            assert _k not in globals(), _k
            globals()[_k] = _fn
            _COPIED.append(_k)


def test_the_copied_cases_are_all_here():
    want = set()
    for name in ("test_auth", "test_metrics", "test_log_format"):
        src = (TESTS / f"{name}.py").read_text()
        want |= set(re.findall(r"^def (test_\w+)\(", src, re.M))
    if "test_round_trip" not in _COPIED:  # test_auth skipped
        pytest.importorskip("cryptography")
    assert want - set(_COPIED) == set(LEFT_OUT)
    assert len(_COPIED) == 20


# -- the port's exposition and access log beside the reference's ---------------


def _observe(m):
    m.observe_request("GET", "/v1/dss/identification_service_areas/"
                      "dddddddd-dddd-4ddd-8ddd-ddddddddddd1", 200, 0.012)
    m.observe_request("PUT", "/dss/v1/operation_references/x", 409, 0.3)
    m.observe_stage("/v1/dss/identification_service_areas", "store_ms",
                    0.0004)
    m.observe_stage("/v1/dss/identification_service_areas", "odd_ms", 2.0)
    m.set_gauge("dss_dar_op_live_records", 42)
    m.set_gauge_vec("dss_shard_load", "shard", {"0": 1.5, "1": 2.0})
    m.set_info("dss_build_info", {"commit": "deadbeef"})


def test_exposition_equals_the_reference():
    r, p = RMetrics(proc="leader:1"), MetricsRegistry(proc="leader:1")
    _observe(r)
    _observe(p)
    assert p.render() == r.render()
    assert p.stage_hist_snapshot() == r.stage_hist_snapshot()
    assert p.stage_hist_front() == r.stage_hist_front()
    h0 = p.stage_hist_snapshot()
    _observe(p)
    _observe(r)
    assert stage_hist_delta(h0, p.stage_hist_snapshot()) == r_delta(
        h0, r.stage_hist_snapshot()
    )


def _shm_pair(tmp_path, nworkers=2):
    from dss_tpu.parallel import shmring as r_shm
    from dss_tpu_torch.parallel import shmring as p_shm

    return (
        (r_shm, r_shm.ShmRegion.create(str(tmp_path / "r.shm"),
                                       nworkers=nworkers, depth=2)),
        (p_shm, p_shm.ShmRegion.create(str(tmp_path / "p.shm"),
                                       nworkers=nworkers, depth=2)),
    )


def test_shm_stage_writer_equals_the_reference(tmp_path):
    """attach_stage_writer: every stage observation also lands in the
    process's shared block, and the blocks hold the same int64 words
    as the reference's on the same observations."""
    sides = _shm_pair(tmp_path)
    regs = []
    try:
        for (mod, region), cls in zip(sides, (RMetrics, MetricsRegistry)):
            m = cls(proc="worker-0:1")
            m.attach_stage_writer(mod.StageHistWriter(region, 0))
            _observe(m)
            m.observe_stage("/dss/v1/operation_references/{entityuuid}",
                            "service_ms", 0.3)
            # the leader's block (index nworkers) through a writer alone
            mod.StageHistWriter(region, 2).observe(
                "/v1/dss/identification_service_areas", "store_ms", 0.02)
            regs.append(region)
        (_, r_reg), (_, p_reg) = sides
        assert np.array_equal(np.asarray(p_reg._shist),
                              np.asarray(r_reg._shist))
        assert np.asarray(p_reg._shist).sum() > 0
    finally:
        for region in regs:
            region.close()


def test_shm_stage_aggregate_equals_the_reference(tmp_path):
    """set_stage_agg + stage_hist_front: the whole-front family (merged
    across the shm blocks, no process label) renders and reads back
    as the reference's."""
    sides = _shm_pair(tmp_path)
    regs, out = [], []
    try:
        for (mod, region), cls in zip(sides, (RMetrics, MetricsRegistry)):
            regs.append(region)
            ms = [cls(proc=f"worker-{i}:1") for i in range(2)]
            for i, m in enumerate(ms):
                m.attach_stage_writer(mod.StageHistWriter(region, i))
                m.set_stage_agg(lambda _r=region, _mod=mod:
                                _mod.shm_stage_hist(_r))
                _observe(m)
            ms[1].observe_stage("/v1/dss/subscriptions", "auth_ms", 0.001)
            out.append((ms[0].render(), ms[0].stage_hist_front(),
                        ms[1].stage_hist_snapshot()))
        assert out[1] == out[0]
        front = out[1][1]
        assert front[("search", "store_ms")][2] == 2
        assert 'dss_stage_duration_seconds_count{route="search",' \
            'stage="store_ms"} 2' in out[1][0]
    finally:
        for region in regs:
            region.close()


def test_json_log_lines_equal_the_reference(capsys):
    """configure_logging + log_fields write the same JSON lines."""
    out = []
    for mod in (r_logging, p_logging):
        mod.configure_logging("info", "json")
        mod.log_fields(mod.get_logger("dss.test"), logging.INFO, "request",
                       method="GET", status=200)
        line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        line.pop("ts")
        out.append(line)
    assert out[1] == out[0] == {
        "level": "info", "logger": "dss.test", "msg": "request",
        "method": "GET", "status": 200,
    }

"""The scenario generator on the port, held to the reference.

Every case of tests/test_scenario.py runs on the port's
`dss_tpu_torch.scenario` (the reference test file compiled anew with
its imports pointed at the port), and the two packages build the same
stream: for every scenario, at seeds 0, 7 and 13 and scales 0.02 and
0.05, `stream_digest` is equal, and so are the phases' names, request
counts and metadata.  Exact: the generator is a pure function of its
arguments.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from dss_tpu import scenario as r_scen
from dss_tpu_torch import scenario as p_scen
from tests.test_torch_region import port_copy

TESTS = Path(__file__).resolve().parent

PORT_CASES = port_copy("test_scenario")
_COPIED = []
for _k, _fn in list(PORT_CASES.items()):
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = _fn
        _COPIED.append(_k)


def test_every_reference_case_is_here():
    src = (TESTS / "test_scenario.py").read_text()
    assert set(re.findall(r"^def (test_\w+)\(", src, re.M)) == set(_COPIED)
    assert PORT_CASES["build_scenario"] is p_scen.build_scenario


def test_the_same_scenario_names():
    assert sorted(p_scen.SCENARIOS) == sorted(r_scen.SCENARIOS)


@pytest.mark.parametrize("seed", (0, 7, 13))
@pytest.mark.parametrize("name", sorted(r_scen.SCENARIOS))
def test_streams_equal_across_the_packages(name, seed):
    for scale in (0.02, 0.05):
        r = r_scen.build_scenario(name, seed, scale, 10.0)
        p = p_scen.build_scenario(name, seed, scale, 10.0)
        assert p_scen.stream_digest(p) == r_scen.stream_digest(r), (
            name, seed, scale)
        assert [(ph.name, len(ph.requests)) for ph in p.phases] == [
            (ph.name, len(ph.requests)) for ph in r.phases]
        assert p.meta == r.meta

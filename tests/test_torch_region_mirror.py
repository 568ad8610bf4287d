"""Region log replication on the port: every case of
tests/test_region_mirror.py on the port's log server, mirror and client.

The reference test file is compiled anew with its imports pointed at
the port (`dss_tpu.` -> `dss_tpu_torch.`, and its helpers from
tests/test_region.py taken from the port's copy of that file), and
each of its test functions is collected here under its own name:
quorum math, the persisted epoch rules, mirror catch-up across
compaction, promotion, fencing and client failover.

One change to a case: `test_promotion_fences_stale_primary` waits,
after the repoint, until the repointed mirror has adopted the promoted
primary's epoch before the stale primary writes.  Without that wait
the stale append races two pushes — the promoted mirror's refusal
(which demotes the stale primary) against the repointed mirror's ack,
still on the old epoch — and is acked when the ack wins; the reference's
copy of the case fails that way now and then.
"""

from __future__ import annotations

import re
from pathlib import Path

from tests.test_torch_region import port_copy

TESTS = Path(__file__).resolve().parent

_HELPERS = ("from tests.test_region import RegionServerThread, _crash_wal, "
            "wait_until")
_REPOINT = '''    r = requests.post(
        f"{m2.url}/repoint", json={"primary": m1.url}, timeout=5
    )
    assert r.status_code == 200
'''
_WAIT = _REPOINT + '''    # the repointed mirror is on the promoted epoch: the stale
    # primary's push can only be refused now (a condition, no sleep)
    wait_until(
        lambda: (
            requests.get(f"{m2.url}/status", timeout=5).json()["epoch"]
            == out["epoch"]
        ) or None
    )
'''

PORT_CASES = port_copy("test_region_mirror", extra={
    _HELPERS: _HELPERS.replace("tests.test_region ",
                               "tests.test_torch_region "),
    _REPOINT: _WAIT,
})

cluster = PORT_CASES["cluster"]  # the copied fixture: the port's servers

_COPIED = []
for _k, _fn in list(PORT_CASES.items()):
    if _k.startswith("test_") and callable(_fn):
        assert _k not in globals(), _k
        globals()[_k] = _fn
        _COPIED.append(_k)


def test_every_reference_case_is_here():
    src = (TESTS / "test_region_mirror.py").read_text()
    want = set(re.findall(r"^def (test_\w+)\(", src, re.M))
    assert want == set(_COPIED)
    assert len(_COPIED) == 27
    from dss_tpu_torch.region import mirror

    assert PORT_CASES["RegionNode"] is mirror.RegionNode

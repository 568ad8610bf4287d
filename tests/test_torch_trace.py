"""The port's tracing (dss_tpu_torch/obs/trace.py + stages.py) against
the reference's, through one traced coalesced query.

The same query goes through each package's QueryCoalescer under a
sampled trace, once over a stub table shaped like DarTable's
submit/collect split (the reference test's) and once over a real
DarTable; the recorded span trees must have the same span names in the
same nesting.  The W3C codec and the zero-cost disabled path are held
to the reference too.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import dss_tpu.ops  # noqa: F401  (x64 on before any jax array)
from dss_tpu.dar import coalesce as ref_coalesce
from dss_tpu.dar.snapshot import DarTable as RefDarTable
from dss_tpu.obs import stages as ref_stages
from dss_tpu.obs import trace as ref_trace

from dss_tpu_torch.dar import coalesce
from dss_tpu_torch.dar.snapshot import DarTable
from dss_tpu_torch.obs import stages, trace

NOW = 1_700_000_000_000_000_000
HOUR = 3_600_000_000_000
SIDES = {
    "ref": (ref_coalesce, ref_trace, ref_stages, lambda: RefDarTable(
        idle_fold_s=0)),
    "port": (coalesce, trace, stages, lambda: DarTable(
        device="cpu", idle_fold_s=0)),
}


@pytest.fixture(autouse=True)
def _trace_reset():
    """Tracing off with a fresh recorder before and after, in both
    packages (other tests rely on the zero-cost default)."""
    for tr in (trace, ref_trace):
        tr.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                     max_pending=1024)
    yield
    for tr in (trace, ref_trace):
        tr.configure(sample=0.0, slow_ms=0.0, ring=256, max_spans=256,
                     max_pending=1024)


class _FakePQ:
    def __init__(self, results):
        self.results = results

    def wait_device(self):
        time.sleep(0.001)

    def used_device(self):
        return True


class _FakeTable:
    def query_many_submit(self, keys, lo, hi, t0s, t1s, now=None,
                          owner_ids=None, host_route=False):
        return _FakePQ([[f"r{i}"] for i in range(len(keys))])

    def query_many_collect(self, pq):
        return pq.results


def _shape(node):
    """A span tree as nested (name, sorted children) tuples."""
    return (node["name"],
            tuple(sorted(_shape(c) for c in node["children"])))


def _traced_query(side, table):
    """One traced query through an inline=False coalescer -> (answer,
    span-tree shape, the caller's stage sink)."""
    mod, tr, st, _ = SIDES[side]
    tr.configure(sample=1.0)
    co = mod.QueryCoalescer(table, inline=False)
    sink = {}
    try:
        ctx = tr.new_trace()
        h = tr.SpanHandle(ctx, ctx.root_span_id)
        st.set_sink(sink)
        try:
            with tr.use(h):
                out = co.query(np.asarray([5, 7], np.int32), 0.0, 3000.0,
                               NOW - HOUR, NOW + HOUR, now=NOW)
        finally:
            st.set_sink(None)
        tr.finish_root(ctx, "http GET /search", 9.0, status=200)
    finally:
        co.close()
    tree = tr.recorder().find(ctx.trace_id)
    assert tree is not None
    return out, _shape(tree["root"]), set(sink)


@pytest.mark.parametrize("table", ["stub", "dartable"])
def test_same_span_tree_as_reference(table):
    got = {}
    for side in SIDES:
        if table == "stub":
            tab = _FakeTable()
        else:
            tab = SIDES[side][3]()
            rng = np.random.default_rng(2)
            for i in range(50):
                tab.upsert(f"e{i}", np.unique(rng.integers(0, 10, 3)).astype(
                    np.int32), 0.0, 1000.0, NOW - HOUR, NOW + HOUR, 0)
            tab.fold()
        try:
            got[side] = _traced_query(side, tab)
        finally:
            if table != "stub":
                tab.close()
    assert got["port"] == got["ref"]
    out, shape, sink = got["port"]
    names = {c[0] for c in shape[1]}
    for needed in ("admission", "queue_wait", "plan", "device.dispatch",
                   "coalesce.pack", "device.wait", "collect",
                   "coalesce_wait_ms"):
        assert needed in names, (needed, shape)
    assert sink == {"coalesce_wait_ms"}
    if table == "stub":
        assert out == ["r0"]


def test_traceparent_codec_matches_reference():
    rng = np.random.default_rng(9)
    alphabet = np.array(list("0123456789abcdef-zZ"))
    for _ in range(500):
        n = int(rng.integers(0, 60))
        raw = "".join(rng.choice(alphabet, n))
        assert trace.parse_traceparent(raw) == ref_trace.parse_traceparent(raw)
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    for sampled in (True, False):
        tp = trace.format_traceparent(tid, sid, sampled)
        assert tp == ref_trace.format_traceparent(tid, sid, sampled)
        assert trace.parse_traceparent(tp) == (tid, sid, sampled)


def test_untraced_query_allocates_nothing():
    co = coalesce.QueryCoalescer(_FakeTable(), inline=False)
    try:
        assert co.query(np.asarray([5], np.int32), now=NOW) == ["r0"]
    finally:
        co.close()
    assert trace.stats()["dss_trace_allocs_total"] == 0

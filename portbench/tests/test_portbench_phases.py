"""The program's phase spans on the harness's clock
(portbench/phases.py): an idle gap named by self cover, the spans of a
traced call of the cell's entry inside that call once moved onto
perf_counter, and the seven readers of the replica's phases over a
window of such calls, which read nothing where no phase was collected.
"""

import importlib
import time
from types import SimpleNamespace

import pytest
from conftest import TINY

from dss_tpu_torch.obs import trace
from portbench import device, gen, phases, run

CELL = "scd_mesh_1m.search64"
CALL = ("replica.pad", "mesh.pad", "mesh.launch", "mesh.wait",
        "mesh.decode", "replica.ids", "replica.sort", "replica.load")
READERS = ("replica_pad_share.bulk", "mesh_launch_share.bulk",
           "mesh_wait_share.bulk", "replica_decode_share.bulk",
           "replica_load_share.bulk", "replica_decode_ns_per_hit.bulk",
           "replica_unspanned_share.bulk")
SHARES = READERS[:5]


def test_a_gap_is_named_by_the_span_with_the_most_self_cover():
    call = [("query_batch", 0, 100)]
    # the harness's span alone: the name is the call's, as before
    assert phases.name_gap(call, 10, 60) == "query_batch"
    assert phases.name_gap(call, 200, 300) == "host"
    inner = call + [("replica.pad", 0, 5), ("mesh.decode", 20, 45),
                    ("replica.ids", 45, 70), ("replica.load", 95, 100)]
    # [10, 60): ids 15, decode 25, the call itself 5 + 0 past its phases
    assert phases.self_cover(inner, 10, 60) == {
        "query_batch": 10, "mesh.decode": 25, "replica.ids": 15}
    assert phases.name_gap(inner, 10, 60) == "mesh.decode"
    # a gap the phases leave mostly uncovered keeps the call's name
    assert phases.name_gap(inner, 70, 100) == "query_batch"
    # spans of one name add up
    assert phases.name_gap(inner + [("replica.ids", 0, 0.5)], 0, 60) == (
        "mesh.decode")


def test_the_clock_pair_maps_wall_ns_onto_perf_counter():
    wall, perf = phases.clock_pair()
    (name, a, b), = phases.on_perf([("x", wall + 2_000_000, 1.5)],
                                   (wall, perf))
    assert name == "x" and a == pytest.approx(perf / 1e9 + 0.002)
    assert b - a == pytest.approx(0.0015)
    # a pair read moments later tells the same offset, to well under a
    # call's length
    w2, p2 = phases.clock_pair()
    assert abs((w2 - wall) - (p2 - perf)) < 200_000


@pytest.fixture(scope="module")
def traced_calls():
    """Six traced calls of the cell's entry at the CPU's size -> (the
    harness's spans with the program's on its clock, the window, the
    slots the replica decoded, each call's (start, end, its program
    spans))."""
    cell = run.load_cell(CELL)
    cfg = cell["config"]
    cfg["data"].update(TINY["data"])
    recipe = importlib.import_module(f"portbench.recipes.{cfg['recipe']}")
    data = recipe.intents(cfg["data"], 11)
    entry = importlib.import_module(
        f"portbench.entries.{cfg['entry']}").Entry(cfg, data, "cpu")
    r = gen.rng(11, gen.BATCHES)
    t = cell["traffic"]
    args = [entry.prepare(recipe.queries(cfg["data"], t["query"], r,
                                         t["batch"])) for _ in range(3)]
    plain = [entry.query(a) for a in args]
    spans, calls, answers = device.Spans(), [], []
    hits0 = entry.rep.stats()["replica_ops_hits"]
    trace.configure(sample=1.0)
    try:
        t_open = time.perf_counter()
        for k in range(6):
            a = time.perf_counter()
            out, got = phases.collect(entry.query, args[k % 3])
            b = time.perf_counter()
            spans.add(entry.span, a, b)
            calls.append((a, b, got))
            for name, sa, sb in got:
                spans.add(name, sa, sb)
            answers.append(out)
        t_close = time.perf_counter()
    finally:
        trace.configure(sample=0.0)
        hits = entry.rep.stats()["replica_ops_hits"] - hits0
        entry.close()
    assert answers == plain * 2  # tracing changes no answer
    return spans, (t_open, t_close), hits, calls


def test_each_program_span_lies_inside_its_call(traced_calls):
    _, _, _, calls = traced_calls
    slack = 1e-6  # the recorder keeps durations to the microsecond
    for a, b, got in calls:
        assert tuple(n for n, _, _ in got) == CALL  # one tier
        assert all(a - slack <= sa <= sb <= b + slack for _, sa, sb in got)
        assert all(p[2] <= q[1] + slack for p, q in zip(got, got[1:]))


def _run(spans, window, hits):
    t_open, t_close = window
    return SimpleNamespace(
        spans=spans, entry_span="query_batch", t_open=t_open,
        t_close=t_close, window_s=t_close - t_open,
        counter_delta=lambda key: hits if key == "hits" else 0)


def test_the_seven_readers_split_the_calls(traced_calls):
    spans, window, hits, _ = traced_calls
    r = _run(spans, window, hits)
    got = {m: run.reader(m)(r) for m in READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    calls = sum(b - a for a, b in spans.of("query_batch"))
    assert sum(got[m] for m in SHARES) + got[
        "replica_unspanned_share.bulk"] == pytest.approx(
        100 * calls / r.window_s, abs=0.01)
    assert hits > 0 and got["replica_decode_ns_per_hit.bulk"] == (
        pytest.approx(1e9 * phases.seconds(r, phases.PHASES["decode"])
                      / hits))


def test_the_readers_read_nothing_without_program_spans(traced_calls):
    spans, window, hits, _ = traced_calls
    bare = device.Spans()
    for a, b in spans.of("query_batch"):
        bare.add("query_batch", a, b)
    r = _run(bare, window, hits)
    assert all(run.reader(m)(r) is None for m in READERS)

"""The program's phase spans inside the mesh replica's calls, on the
harness's clock, and what a traced run reads of them.

`ShardedReplica.query_batch` records flat spans that cover a call in
code order (`dss_tpu_torch/obs/trace.py`, PHASES below).  A traced call
runs under the tracer's collect mode (`collect`): its spans land in a
list, never in the recorder.  Their starts are wall-clock ns; a
`(time.time_ns(), time.perf_counter_ns())` pair read beside the call
(`clock_pair`) moves them onto `perf_counter` (`on_perf`), the clock of
the harness's spans, which the device trace's anchor places on the
profiler's (`portbench/device.py`).  One pair a call, not one a window:
the wall clock may be slewed against perf_counter while the window
runs.  An idle gap of the card is then named by the
span with the most self cover of it (`name_gap`): a call's own span
covers only what no phase inside it does, so with the call's span
alone the name is the call's.

The readers `portbench/metrics/{replica,mesh}_*.bulk.py` sum the
phases' seconds over the window (`share`), and what of the calls no
phase covers (`unspanned_share`).  They read `run.spans`, which holds
the program's spans by name only where a traced window collected them.
"""

from __future__ import annotations

import time

from dss_tpu_torch.obs import trace

# the phases of a call, by the layer's share that reads them
PHASES = {
    "pad": ("replica.pad", "mesh.pad"),
    "launch": ("mesh.launch",),
    "wait": ("mesh.wait",),
    "decode": ("mesh.decode", "replica.ids", "replica.sort"),
    "load": ("replica.load",),
}
NAMES = frozenset(n for names in PHASES.values() for n in names)
# collect mode keeps the spans off the recorder, so the id is only a tag
TRACE_ID = "706f727462656e6368000000000000ff"


def clock_pair(reads: int = 4) -> tuple:
    """-> (wall ns, perf_counter ns) read together: of `reads`
    back-to-back readings the one whose perf_counter reads around the
    wall clock lie closest, with their midpoint."""
    best = None
    for _ in range(reads):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall, (p0 + p1) // 2)
    return best[1], best[2]


def collect(call, *args) -> tuple:
    """call(*args) with tracing collected on this thread -> (its
    result, its spans as (name, start s, end s) on perf_counter).
    Tracing must be on (`trace.configure(sample=1.0)`)."""
    pair = clock_pair()
    tok = trace.begin_collect(TRACE_ID)
    try:
        out = call(*args)
    finally:
        spans = trace.end_collect(tok)
    return out, on_perf([(s[2], s[3], s[4]) for s in spans], pair)


def on_perf(spans, pair) -> list:
    """(name, start wall ns, ms) -> (name, start s, end s) on
    perf_counter, through `clock_pair`'s pair."""
    wall, perf = pair
    out = []
    for name, start_ns, ms in spans:
        a = (start_ns - wall + perf) / 1e9
        out.append((name, a, a + ms / 1e3))
    return out


def _union_length(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_cover(spans, a, b) -> dict:
    """{name: how much of [a, b) its spans cover and no shorter span
    inside one of them does}, over (name, start, end) spans in any one
    unit."""
    inside = [(n, max(a, sa), min(b, sb), sb - sa, sa, sb)
              for n, sa, sb in spans if min(b, sb) > max(a, sa)]
    cover = {}
    for n, ca, cb, length, sa, sb in inside:
        nested = [(xa, xb) for _, xa, xb, xlen, xsa, xsb in inside
                  if xlen < length and xsa >= sa and xsb <= sb]
        own = (cb - ca) - _union_length(
            [(max(ca, xa), min(cb, xb)) for xa, xb in nested
             if min(cb, xb) > max(ca, xa)])
        cover[n] = cover.get(n, 0) + own
    return cover


def name_gap(spans, a, b, default: str = "host") -> str:
    """The name whose spans have the most self cover of [a, b), or
    `default` where no span meets it."""
    cover = self_cover(spans, a, b)
    return max(cover, key=cover.get) if cover else default


def seconds(run, names) -> float:
    """Seconds of the window inside the spans of `names` (the program's
    phases are flat and disjoint, so their lengths add)."""
    total = 0.0
    for n, a, b in run.spans.items:
        if n in names:
            total += max(0.0, min(b, run.t_close) - max(a, run.t_open))
    return total


def collected(run) -> bool:
    """Whether the run holds the program's phase spans."""
    return any(n in NAMES for n, _, _ in run.spans.items)


def share(run, names):
    """% of the window inside the spans of `names`; None where the run
    holds no program span."""
    if not collected(run):
        return None
    return 100.0 * seconds(run, names) / run.window_s


def unspanned_share(run):
    """% of the window inside the harness's calls (`run.entry_span`)
    that no program phase covers; None where the run holds no program
    span."""
    calls = run.spans.of(run.entry_span)
    if not calls or not collected(run):
        return None
    inner = [(a, b) for n, a, b in run.spans.items if n in NAMES]
    return 100.0 * (sum(b - a for a, b in _clip(calls, run))
                    - _union_length(_clip(inner, run))) / run.window_s


def _clip(intervals, run) -> list:
    return [(max(a, run.t_open), min(b, run.t_close)) for a, b in intervals
            if min(b, run.t_close) > max(a, run.t_open)]

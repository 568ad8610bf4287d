"""Driver `churn`: rounds of writes, a sync and a chunk of searches,
back to back on one thread.

Set-up draws the write stream from the seed (`portbench/churn.py`: the
configuration's `backlog`, then `stream_rounds` rounds of the mix's
`round`), has the entry file the backlog and sync, and serializes every
round's writes as the log's lines.  A pool of `pool` chunks of `batch`
searches is drawn and prepared as in the driver `bulk`, and cycled.  A
round is three steps: the entry appends the round's lines to its log,
`sync()`s (the harness span `sync`) and answers the next chunk (the
span `query_batch`); so each chunk is answered at the state after every
write appended before it.  `warm_rounds` rounds run before the window;
the window closes when the round in flight at `--seconds` has returned.
A run that needs more rounds than the stream holds raises: it never
cycles the stream.  Of each chunk `check_per_batch` positions drawn
from the seed are kept for the check, with the round that answered it.

With `--trace 1` the port's tracing is on through the window, and each
step runs in its collect mode: the program's spans, with their
attributes and parents, land in `run.program_spans` as `Span`s on
perf_counter, which the readers `portbench/metrics/*.churn.py` read.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

from portbench import churn, gen
from portbench.drivers.bulk import PERMS


class Span(NamedTuple):
    """One of the program's spans on the harness's clock."""

    name: str
    start: float  # s, perf_counter
    end: float
    attrs: dict
    span_id: str
    parent: Optional[str]


def collect(call) -> tuple:
    """call() with the port's spans collected on this thread -> (its
    result, its spans as `Span`s).  Tracing must be on."""
    from dss_tpu_torch.obs import trace

    from portbench import phases

    wall, perf = phases.clock_pair()
    tok = trace.begin_collect(phases.TRACE_ID)
    try:
        out = call()
    finally:
        spans = trace.end_collect(tok)
    got = []
    for sid, parent, name, start_ns, ms, attrs in spans:
        a = (start_ns - wall + perf) / 1e9
        got.append(Span(name, a, a + ms / 1e3, attrs or {}, sid, parent))
    return out, got


def drive(run) -> None:
    t = run.traffic
    entry, spans = run.entry, run.spans
    r = gen.rng(run.seed, gen.BATCHES)
    run.pool = [run.recipe.queries(run.data, t["query"], r, t["batch"])
                for _ in range(t["pool"])]
    args = [entry.prepare(q) for q in run.pool]
    keep = gen.rng(run.seed, gen.CHECK).permuted(
        [range(t["batch"])] * PERMS, axis=1)[:, :t["check_per_batch"]]
    w = churn.draw(run.recipe, run.data, entry.data, run.cfg["backlog"],
                   t["round"], t["stream_rounds"], run.seed)
    run.writes = w
    entry.file_backlog(w)
    rounds = [None] + [entry.lines(w, k) for k in range(1, w.rounds + 1)]
    run.program_spans = []

    def step(k: int, chunk: int, traced: bool) -> tuple:
        """Round k: its writes, the sync, then the chunk's searches."""
        if k > w.rounds:
            raise RuntimeError(
                f"portbench: the write stream holds {w.rounds} rounds; "
                "the run needs more (raise the mix's stream_rounds)")
        entry.append(rounds[k])
        a = time.perf_counter()
        if traced:
            _, got = collect(entry.sync)
            run.program_spans += got
        else:
            entry.sync()
        b = time.perf_counter()
        if traced:
            answers, got = collect(lambda: entry.query(args[chunk]))
            run.program_spans += got
        else:
            answers = entry.query(args[chunk])
        c = time.perf_counter()
        return answers, a, b, c

    for k in range(1, t["warm_rounds"] + 1):
        step(k, (k - 1) % len(args), False)
    run.sync()

    traced = run.traced
    if traced:
        from dss_tpu_torch.obs import trace

        trace.configure(sample=1.0)
    deadline = run.open()
    seq = 0
    k = t["warm_rounds"]
    try:
        while True:
            k += 1
            i = seq % len(args)
            answers, a, b, c = step(k, i, traced)
            spans.add("sync", a, b)
            spans.add(entry.span, b, c)
            run.batches.append(i)
            run.attempted += len(answers)
            run.answered += len(answers)
            pos = keep[seq % PERMS]
            run.kept.append((i, pos, *entry.keep(answers, pos), k))
            seq += 1
            if c >= deadline:
                break
    finally:
        if traced:
            trace.configure(sample=0.0)
    run.close()

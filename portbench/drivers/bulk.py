"""Driver `bulk`: one dispatcher thread drives batches back to back.

A pool of `pool` batches of `batch` queries is made from the seed and
cycled, each prepared as the entry's deployed caller hands it over, so
the window holds only the entry's calls.  The window starts with the
first call and closes when the call in flight at `--seconds` has
returned: every query of the window is answered inside it.  Of each
batch, `check_per_batch` positions drawn from the seed are kept for
the check.
"""

from __future__ import annotations

import time

from portbench import gen

PERMS = 4096  # the seeded draws of kept positions, cycled


def drive(run) -> None:
    t = run.traffic
    entry, spans = run.entry, run.spans
    r = gen.rng(run.seed, gen.BATCHES)
    run.pool = [run.recipe.queries(run.data, t["query"], r, t["batch"])
                for _ in range(t["pool"])]
    args = [entry.prepare(q) for q in run.pool]
    keep = gen.rng(run.seed, gen.CHECK).permuted(
        [range(t["batch"])] * PERMS, axis=1)[:, :t["check_per_batch"]]
    for k in range(t["warm_batches"]):
        entry.query(args[k % len(args)])
    run.sync()

    deadline = run.open()
    seq = 0
    while True:
        i = seq % len(args)
        a = time.perf_counter()
        answers = entry.query(args[i])
        b = time.perf_counter()
        spans.add(entry.span, a, b)
        run.batches.append(i)
        run.attempted += len(answers)
        run.answered += len(answers)
        pos = keep[seq % PERMS]
        run.kept.append((i, pos, *entry.keep(answers, pos)))
        seq += 1
        if b >= deadline:
            break
    run.close()

"""replica_fold_ms.churn: the median ms of the window's minor folds:
the program's `replica.refresh` spans with `major` 0 (the delta tier's
ShardedDar packed, copied to the card, warmed and published), from a
traced window (portbench/metrics/_program.py)."""

import statistics

from portbench.metrics._program import of


def read(run):
    folds = of(run, "replica.refresh", major=0)
    if not folds:
        return None
    return 1e3 * statistics.median(b - a for a, b in folds)

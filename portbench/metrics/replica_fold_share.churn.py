"""replica_fold_share.churn: % of the window inside the program's
`replica.refresh` spans (every fold of a class: build, copies, warm-up,
publish), from a traced window (portbench/metrics/_program.py)."""

from portbench.metrics._program import share


def read(run):
    return share(run, "replica.refresh")

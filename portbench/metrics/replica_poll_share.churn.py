"""replica_poll_share.churn: % of the window inside the program's
`replica.poll` spans (the log's new lines read, parsed and applied to
the record map, the delta set and the shadow set), from a traced
window (portbench/metrics/_program.py)."""

from portbench.metrics._program import share


def read(run):
    return share(run, "replica.poll")

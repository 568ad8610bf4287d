"""replica_load_share.bulk: % of the window in replica.load: the load
record of each search. The program's spans on the harness's clock
(portbench/phases.py)."""

from portbench.phases import PHASES, share


def read(run):
    return share(run, PHASES["load"])

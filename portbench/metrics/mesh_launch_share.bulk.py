"""mesh_launch_share.bulk: % of the window in mesh.launch: the query
fields' host->device copies, K1 and K2 enqueued. The program's spans
on the harness's clock (portbench/phases.py)."""

from portbench.phases import PHASES, share


def read(run):
    return share(run, PHASES["launch"])

"""replica_pad_share.bulk: % of the window in replica.pad and mesh.pad:
the pads of a call (np.unique a query, the key-width and batch
buckets, the query fields). The program's spans on the harness's clock
(portbench/phases.py)."""

from portbench.phases import PHASES, share


def read(run):
    return share(run, PHASES["pad"])

"""replica_decode_share.bulk: % of the window in mesh.decode, replica.ids
and replica.sort: slots to Python lists, to entity ids (the shadow
drop) and the sorted id lists. The program's spans on the harness's
clock (portbench/phases.py)."""

from portbench.phases import PHASES, share


def read(run):
    return share(run, PHASES["decode"])

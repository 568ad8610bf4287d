"""mesh_wait_share.bulk: % of the window in mesh.wait: the host waiting
on K1 and K2, then the device->host copies. The program's spans on the
harness's clock (portbench/phases.py)."""

from portbench.phases import PHASES, share


def read(run):
    return share(run, PHASES["wait"])

"""replica_decode_ns_per_hit.bulk: ns of the decode phases (mesh.decode,
replica.ids, replica.sort) over the window, per slot the replica
decoded in it (its `replica_ops_hits` counter, every tier, before the
shadow drop).  None where the run holds no program span or no count."""

from portbench.phases import PHASES, collected, seconds


def read(run):
    hits = run.counter_delta("hits")
    if not hits or not collected(run):
        return None
    return 1e9 * seconds(run, PHASES["decode"]) / hits

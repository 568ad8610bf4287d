"""k1_roofline_share.bulk: K1 (`mesh_query_kernel`, csrc/mesh_query.cu)
against bounds.filter_bytes of the batch (on a 1x1 mesh with the data
in the base tier, one launch a batch)."""

from portbench.metrics._roofline import filter_bound, share


def read(run):
    return share(run, "mesh_query_kernel",
                 lambda r, i: filter_bound(r, i)["bytes"])

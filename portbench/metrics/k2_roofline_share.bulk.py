"""k2_roofline_share.bulk: K2 (`mesh_merge_kernel`, csrc/mesh_query.cu)
against bounds.merge_bytes of the batch's queries and distinct hits."""

from portbench import bounds
from portbench.metrics._roofline import filter_bound, share


def read(run):
    return share(run, "mesh_merge_kernel", lambda r, i: bounds.merge_bytes(
        len(r.pool[i]), filter_bound(r, i)["hits"]))

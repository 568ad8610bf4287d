"""Multi-device DAR sharding and multi-process serving.

The mesh route (`mesh`, `sharded`, `replica`): a ("dp", "sp") mesh of
local torch devices, where

    dp — query-batch data parallelism (each dp row answers a slice of
         the query batch),
    sp — spatial postings sharding (the sorted postings array is split
         into contiguous cell-key ranges, one per sp column; candidate
         sets are merged on the row's first device).

The EntityTable (attribute columns) is replicated — it is small
relative to postings and every shard needs random access to it.  One
device may fill several positions.  A mesh from `make_global_mesh`
spans the processes joined by `multihost.initialize` (its placement is
a `MeshPlacement`); `multihost.MultihostReplica` holds them in
lockstep.

The shared-memory front (`shmring`): N request workers share one
device-owner process over an mmap'd region (`ShmRegion`).
"""

from dss_tpu_torch.parallel.mesh import (
    Mesh,
    MeshPlacement,
    make_global_mesh,
    make_mesh,
    mesh_spans_processes,
    virtual_devices,
)
from dss_tpu_torch.parallel.sharded import (
    ShardedDar,
    imbalance_factor,
    shard_postings,
    sharded_conflict_query_batch,
    weighted_boundaries,
)
from dss_tpu_torch.parallel.shmring import (
    SHM_CLASSES,
    FenceMirror,
    RingFull,
    RingOversize,
    RingTimeout,
    ShmOwner,
    ShmRegion,
    ShmWorkerClient,
    StageHistWriter,
    WorkerFenceView,
    front_stats,
    shm_stage_hist,
)

__all__ = [
    "Mesh",
    "MeshPlacement",
    "make_global_mesh",
    "make_mesh",
    "mesh_spans_processes",
    "virtual_devices",
    "ShardedDar",
    "imbalance_factor",
    "shard_postings",
    "sharded_conflict_query_batch",
    "weighted_boundaries",
    "SHM_CLASSES",
    "FenceMirror",
    "RingFull",
    "RingOversize",
    "RingTimeout",
    "ShmOwner",
    "ShmRegion",
    "ShmWorkerClient",
    "StageHistWriter",
    "WorkerFenceView",
    "front_stats",
    "shm_stage_hist",
]

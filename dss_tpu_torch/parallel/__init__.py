"""Multi-process serving: the shared-memory front (`shmring`).

N request workers share one device-owner process over an mmap'd
region (`ShmRegion`).  The mesh route (`mesh`, `sharded`, `replica`)
comes with its own slice and is not here yet.
"""

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

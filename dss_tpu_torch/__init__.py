"""PyTorch/CUDA port of the DSS spatial index.

The `dss_tpu` package is the reference; this package answers the same
queries with the same results on an NVIDIA Hopper card.  It imports
`torch` and numpy only — never `jax`, and no module of `dss_tpu` — and
keeps its own copy of every helper it needs.

  ops.conflict     — the DAR sentinels (`INT32_MAX`, `NO_TIME_*`).
  ops.fused_filter — the fused window filter: a hand-written CUDA
                     kernel (csrc/fused_filter.cu) and its plain
                     PyTorch version.
  ops.fastpath     — `FastTable`: exact block columns on the device,
                     host window packing and hit decode.
  dar.*            — `DarTable` (tiered snapshots, overlay, folds),
                     `CudaSpatialIndex`, the coalescer and `DSSStore`.
  services, auth,  — the RID/SCD services, JWT auth, the REST app and
  api, cmds          the server binary (`python -m
                     dss_tpu_torch.cmds.server`).
  geo.s2cell       — the numpy S2 cell math the index needs.
  convert          — builds port objects from a reference table's
                     plain arrays.

Objects that hold device state take `device=` and default to
`torch.device("cuda")`; without a card that default raises instead of
running on the CPU.
"""

"""Mesh construction for the DAR query fabric.

Axes: ("dp", "sp") — query-batch data parallelism x spatial postings
sharding, as in the reference's `dss_tpu/parallel/mesh.py`.  The port's
`Mesh` is one controller over local `torch.device`s: a (dp, sp) grid
of positions, each naming the device that holds its postings shard and
runs its part of a query batch.

One device may fill several positions (a "virtual" mesh): that is the
port's form of the reference's virtual CPU devices, so one card runs a
1x8 or 2x4 mesh, shard after shard, and the CPU tests run one too.  A
mesh of this module never spans processes; the process-spanning mesh
(`make_global_mesh`, `MeshPlacement`) comes with the multihost slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dss_tpu_torch import errors


class Mesh:
    """A ("dp", "sp") grid of torch devices.  `.shape` is
    {"dp": dp, "sp": sp} and `.devices` the [dp, sp] object array, the
    two things the sharded DAR reads from a mesh."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        arr = np.empty(np.shape(devices), dtype=object)
        for ij in np.ndindex(arr.shape):
            arr[ij] = torch.device(devices[ij])
        if arr.ndim != 2:
            raise ValueError(f"a mesh is [dp, sp]; got shape {arr.shape}")
        if any(d.type == "cuda" for d in arr.flat) and not (
            torch.cuda.is_available()
        ):
            raise RuntimeError(
                "a cuda mesh position but torch.cuda.is_available() is "
                "False; use torch.device('cpu') positions to run the "
                "plain versions"
            )
        self.devices = arr
        self.shape: Dict[str, int] = {"dp": arr.shape[0], "sp": arr.shape[1]}

    def distinct_devices(self) -> List[torch.device]:
        """The devices of the mesh, each once, in position order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def row_groups(self, d: int) -> List[Tuple[torch.device, List[int]]]:
        """dp row `d`'s sp columns grouped by the device that holds them
        (devices in order of first appearance)."""
        groups: Dict[torch.device, List[int]] = {}
        for s, dev in enumerate(self.devices[d]):
            groups.setdefault(dev, []).append(s)
        return list(groups.items())

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.distinct_devices()]})")


def _factor(n: int) -> Tuple[int, int]:
    """Default (dp, sp) factoring: spatial sharding is the scaling
    dimension, but keep a dp=2 query-stream axis once there are >=4
    positions (the reference's v5e-8 default: dp=2 x sp=4)."""
    dp = 2 if (n >= 4 and n % 2 == 0) else 1
    return dp, n // dp


def local_devices() -> List[torch.device]:
    """Every card of this process; raises where there is none (the
    port never quietly runs a device path on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a cuda mesh requested but torch.cuda.is_available() is "
            "False; pass devices=[torch.device('cpu')] * n to run the "
            "plain versions"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    dp: Optional[int] = None,
    sp: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("dp", "sp") mesh over the first n_devices positions of
    `devices` (default: this process's cards).  A device listed several
    times fills several positions (`virtual_devices`)."""
    if devices is None:
        devices = local_devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = [torch.device(d) for d in list(devices)[:n_devices]]
    if dp is None and sp is None:
        dp, sp = _factor(n_devices)
    elif dp is None:
        dp = n_devices // sp
    elif sp is None:
        sp = n_devices // dp
    if dp * sp != n_devices or len(devices) != n_devices:
        raise ValueError(
            f"dp*sp = {dp}*{sp} != n_devices = {n_devices} "
            f"({len(devices)} positions given)"
        )
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp))


def virtual_devices(device, n: int) -> List[torch.device]:
    """`n` mesh positions on one device (the port's virtual devices)."""
    return [torch.device(device)] * int(n)


def mesh_spans_processes(mesh: Mesh) -> bool:
    """False: every mesh of this package lives in one process (the
    process-spanning mesh comes with the multihost slice)."""
    return False


class MeshPlacement:
    """The reference's process-spanning placement; not ported yet."""

    def __init__(self, *args, **kwargs):
        errors.later_slice("the process-spanning mesh (MeshPlacement)",
                           "multihost")


def make_global_mesh(*args, **kwargs):
    errors.later_slice("the process-spanning mesh (make_global_mesh)",
                       "multihost")

"""Mesh construction for the DAR query fabric.

Axes: ("dp", "sp") — query-batch data parallelism x spatial postings
sharding, as in the reference's `dss_tpu/parallel/mesh.py`.  The port's
`Mesh` is a (dp, sp) grid of positions, each naming the torch device
that holds its postings shard and runs its part of a query batch, and
the process that owns it.

One device may fill several positions (a "virtual" mesh): that is the
port's form of the reference's virtual CPU devices, so one card runs a
1x8 or 2x4 mesh, shard after shard, and the CPU tests run one too.

A mesh built by `make_global_mesh` after `multihost.initialize` spans
processes: every process holds the whole grid and its owner map, but
only its own positions carry a device (the reference's addressable
devices); the others are None.  The global position list is each
process's local positions, exchanged at `initialize` (`GlobalDevice`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class GlobalDevice(NamedTuple):
    """One position of the process-spanning device list: its process,
    its index among that process's positions, and its torch device
    (None on every other process)."""

    process_index: int
    id: int
    device: Optional[torch.device]


class SeamStats:
    """What a process-spanning mesh's queries moved across the process
    seam: collectives, bytes sent and received, the host-clock ms of
    the local shard work (to the host-staged copy) and of the
    collectives."""

    def __init__(self):
        self.gathers = 0
        self.sent_bytes = 0
        self.received_bytes = 0
        self.local_ms = 0.0
        self.gather_ms = 0.0

    def stats(self) -> dict:
        return {
            "dss_multihost_gathers": self.gathers,
            "dss_multihost_gather_sent_bytes": self.sent_bytes,
            "dss_multihost_gather_received_bytes": self.received_bytes,
            "dss_multihost_gather_local_ms": round(self.local_ms, 3),
            "dss_multihost_gather_ms": round(self.gather_ms, 3),
        }


class Mesh:
    """A ("dp", "sp") grid of torch devices.  `.shape` is
    {"dp": dp, "sp": sp}, `.devices` the [dp, sp] object array (None
    where another process owns the position) and `.owner` the [dp, sp]
    process index of each position.  `.group` is the torch.distributed
    group a process-spanning mesh's collectives run on (None: the
    default group) and `.seam` what they moved."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray, owner: Optional[np.ndarray] = None,
                 process_index: int = 0):
        arr = np.empty(np.shape(devices), dtype=object)
        if arr.ndim != 2:
            raise ValueError(f"a mesh is [dp, sp]; got shape {arr.shape}")
        owner = (np.full(arr.shape, process_index, np.int64)
                 if owner is None else np.asarray(owner, np.int64))
        if owner.shape != arr.shape:
            raise ValueError(f"owner {owner.shape} != mesh {arr.shape}")
        for ij in np.ndindex(arr.shape):
            mine = int(owner[ij]) == process_index
            if mine != (devices[ij] is not None):
                raise ValueError(
                    f"position {ij}: a device where process "
                    f"{process_index} owns it, and only there"
                )
            arr[ij] = torch.device(devices[ij]) if mine else None
        if any(d.type == "cuda" for d in arr.flat if d is not None) and not (
            torch.cuda.is_available()
        ):
            raise RuntimeError(
                "a cuda mesh position but torch.cuda.is_available() is "
                "False; use torch.device('cpu') positions to run the "
                "plain versions"
            )
        self.devices = arr
        self.owner = owner
        self.process_index = int(process_index)
        self.shape: Dict[str, int] = {"dp": arr.shape[0], "sp": arr.shape[1]}
        self.group = None
        self.seam = SeamStats()

    def distinct_devices(self) -> List[torch.device]:
        """This process's devices of the mesh, each once, in position
        order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d is not None and d not in out:
                out.append(d)
        return out

    def row_groups(self, d: int) -> List[Tuple[torch.device, List[int]]]:
        """dp row `d`'s sp columns on this process, grouped by the
        device that holds them (devices in order of first appearance)."""
        groups: Dict[torch.device, List[int]] = {}
        for s, dev in enumerate(self.devices[d]):
            if dev is not None:
                groups.setdefault(dev, []).append(s)
        return list(groups.items())

    def processes(self) -> List[int]:
        """The processes owning positions, in order."""
        return sorted({int(p) for p in self.owner.flat})

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.distinct_devices()]}, "
                f"processes={self.processes()})")


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
    return Mesh(arr.reshape(dp, sp), process_index=process_index())


def virtual_devices(device, n: int) -> List[torch.device]:
    """`n` mesh positions on one device (the port's virtual devices)."""
    return [torch.device(device)] * int(n)


# the process-spanning device list, set by multihost.initialize (the
# port's jax.distributed global state): (this process, [GlobalDevice])
_GLOBAL: Dict[str, object] = {}


def set_global_devices(process_index: int,
                       devices: Optional[Sequence[GlobalDevice]]) -> None:
    """Install (or, with None, drop) the process-spanning position list
    that `make_global_mesh` defaults to."""
    _GLOBAL.clear()
    if devices is not None:
        _GLOBAL.update(process_index=int(process_index),
                       devices=list(devices))


def process_index() -> int:
    """This process's index in the joined runtime (0 before or without
    one)."""
    return int(_GLOBAL.get("process_index", 0))


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh includes positions of more than one OS
    process (the "sp" all_gather crosses processes, and each process
    materializes only the shard rows it owns)."""
    return len(mesh.processes()) > 1


class MeshPlacement(NamedTuple):
    """A ("dp", "sp") mesh over GLOBAL positions plus the explicit
    host<->shard placement bookkeeping multi-host serving needs:
    which process owns which mesh coordinates, and which "sp" postings
    ranges this process can address (and therefore must fold/hold)."""

    mesh: Mesh
    dp: int
    sp: int
    # [dp, sp] process index owning each mesh coordinate
    owner: np.ndarray
    # process index -> sorted tuple of sp columns it owns >=1 coord of
    sp_by_process: Dict[int, Tuple[int, ...]]
    process_index: int
    num_processes: int

    @property
    def addressable_sp(self) -> Tuple[int, ...]:
        """The postings-shard columns THIS process folds and holds."""
        return self.sp_by_process.get(self.process_index, ())

    def describe(self) -> str:
        return " ".join(
            f"p{p}:sp{list(cols)}"
            for p, cols in sorted(self.sp_by_process.items())
        )


def _objects(items) -> np.ndarray:
    """A 1-D object array of `items` (numpy would unpack tuples)."""
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return out


def _positions(devices) -> Tuple[int, List[GlobalDevice]]:
    """(this process, the global position list): `devices` as given
    (plain devices are this process's), else the joined runtime's
    list, else this process's cards."""
    me = process_index()
    if devices is None:
        devices = _GLOBAL.get("devices")
        if devices is None:
            devices = local_devices()
    out = []
    for i, d in enumerate(devices):
        if isinstance(d, GlobalDevice):
            out.append(d)
        else:
            out.append(GlobalDevice(me, i, torch.device(d)))
    return me, out


def make_global_mesh(
    *,
    dp: Optional[int] = None,
    sp: Optional[int] = None,
    devices: Optional[Sequence] = None,
    processes: Optional[Sequence[int]] = None,
) -> MeshPlacement:
    """Build the ("dp", "sp") mesh over the GLOBAL position list (every
    process's positions, exchanged at multihost.initialize) with
    explicit placement.

    Positions are ordered (process_index, id) and laid out
    COLUMN-blocked per process: a process with k local positions owns
    k/dp whole, contiguous "sp" columns, filled down the dp axis.  A
    host then owns contiguous postings ranges, per-host folds touch one
    contiguous block, and the "sp" all_gather's inter-host hops are the
    process seam.  A dp that does not divide some process's local count
    would scatter that host's positions across columns other hosts also
    own — it FAILS LOUDLY instead.

    `processes` restricts the mesh to those processes' positions — the
    elastic-membership surface: the joined world is the provisioned
    slot pool, the mesh is the serving membership, and a join/leave is
    a new mesh over a different process subset.

    Defaults to dp=1 for a process-spanning mesh: the query batch is
    replicated to every process anyway, so the scaling dimension
    across hosts is the postings axis.
    """
    me, devices = _positions(devices)
    if processes is not None:
        allowed = {int(p) for p in processes}
        devices = [d for d in devices if d.process_index in allowed]
        if not devices:
            raise ValueError(
                f"no devices belong to member processes {sorted(allowed)}"
            )
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    n = len(devices)
    spans = len({d.process_index for d in devices}) > 1
    if dp is None and sp is None:
        dp, sp = (1, n) if spans else _factor(n)
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != n_devices = {n}")
    # column-blocked placement: walk processes in order, each filling
    # its local-count/dp whole columns top to bottom
    local_counts: Dict[int, int] = {}
    for d in devices:
        local_counts[d.process_index] = (
            local_counts.get(d.process_index, 0) + 1
        )
    if spans:
        bad = {p: k for p, k in local_counts.items() if k % dp != 0}
        if bad:
            raise ValueError(
                f"dp={dp} does not divide local device counts {bad}: "
                "per-host sp columns would be non-contiguous/shared "
                "(choose dp=1 or a dp dividing every host's devices)"
            )
    arr = np.empty((dp, sp), dtype=object)
    if not spans:
        # single process: plain row-major (any layout is local)
        arr = _objects(devices).reshape(dp, sp)
        col = sp
    else:
        col = 0
        for p in sorted(local_counts):
            pdevs = [d for d in devices if d.process_index == p]
            k = len(pdevs) // dp
            arr[:, col: col + k] = _objects(pdevs).reshape(dp, k)
            col += k
    if col != sp:
        raise AssertionError(f"placed {col} of {sp} sp columns")
    owner = np.asarray(
        [[d.process_index for d in row] for row in arr], dtype=np.int64
    )
    sp_by_process: Dict[int, Tuple[int, ...]] = {}
    for p in sorted({int(x) for x in owner.flat}):
        cols = sorted(
            {j for j in range(sp) if (owner[:, j] == p).any()}
        )
        sp_by_process[p] = tuple(cols)
    # the invariant the docstring promises: every column has ONE owner
    # and every process's columns form one contiguous run
    for p, cols in sp_by_process.items():
        if list(cols) != list(range(cols[0], cols[-1] + 1)):
            raise AssertionError(
                f"process {p} sp columns non-contiguous: {cols}"
            )
    if spans:
        for j in range(sp):
            if len({int(x) for x in owner[:, j]}) != 1:
                raise AssertionError(
                    f"sp column {j} spans processes: {owner[:, j]}"
                )
    local = np.empty((dp, sp), dtype=object)
    for ij in np.ndindex(arr.shape):
        local[ij] = arr[ij].device if int(owner[ij]) == me else None
    mesh = Mesh(local, owner=owner, process_index=me)
    return MeshPlacement(
        mesh=mesh,
        dp=dp,
        sp=sp,
        owner=owner,
        sp_by_process=sp_by_process,
        process_index=me,
        num_processes=len(sp_by_process),
    )

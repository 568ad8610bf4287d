"""Multi-host mesh: the process seam for the sharded DAR.

The reference scales one DSS Region across NODES by pointing every
instance at one CockroachDB cluster whose ranges span machines
(implementation_details.md:11-42).  This module is the process-spanning
form of the mesh route: N server processes (one per host) join a
single ("dp", "sp") mesh, each host folds and holds only its
addressable postings shards, and the query path's "sp" all_gather
crosses processes.

The port of the reference's `dss_tpu/parallel/multihost.py`.  Where the
reference joins `jax.distributed`, the port joins a
`torch.distributed.TCPStore` (its master in process 0, at the
coordinator's port) and a gloo process group over it:

  initialize(cfg) -> MultihostRuntime
      Joins the store and the group, with a finite collective timeout
      (a dead peer fails a collective instead of hanging it for the
      library's default half hour); liveness belongs to the barrier
      watchdog below, so peer loss DEGRADES serving instead of ending
      it.  Each process contributes its local mesh positions: its cards,
      or `cfg.dryrun_devices` virtual positions on `cfg.device` (so two
      processes share one card, or run on the CPU).  The collectives
      ride gloo on host-staged tensors, as the reference's dryrun rides
      gloo on its CPU devices.

  MultihostRuntime
      The coordination surface: KV pub/sub for the leader->follower
      command stream, named barriers, the peer-loss watchdog, and the
      `dss_multihost_*` gauge family.

  MultihostReplica
      The serving integration.  Process 0 (leader) serves traffic and
      paces the mesh; followers run `run_follower()` — a pump that
      replays the leader's command stream so every process issues the
      SAME collectives in the SAME order.  Two command kinds:

        refresh: the leader polls its log tail, then broadcasts the
            exact CUT (byte offset / entry index) it folded at;
            followers tail their own copy of the log TO THAT CUT and
            fold the identical record prefix (a routine refresh
            rebuilds only the per-class DELTA dar, a major compaction
            repacks the base; each host materializes only its shard
            rows).

        query: the leader broadcasts the padded query batch, then
            every member runs the same per-tier mesh queries; the "sp"
            all_gather merges per-shard hits across hosts and every
            process merges the whole answer.

      Degraded mode: a watchdog barrier timeout (or a collective
      failing mid-query) flips the survivor to LOCAL-ONLY serving —
      queries answer from the exact host-side record map immediately,
      and the next refresh rebuilds every class on a local mesh.  The
      group is never touched again after a failure (a collective with
      a dead peer fails or waits out its timeout, and tearing the
      group down blocks on the dead peer).  Results stay correct
      (every host tails the full log); only the memory scale-out is
      lost until the mesh re-forms.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from datetime import timedelta
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dss_tpu_torch.chaos import fault_point
from dss_tpu_torch.parallel import mesh as meshmod

log = logging.getLogger("dss.multihost")

# env-var fallbacks for the server flags (k8s downward-API friendly)
ENV_COORDINATOR = "DSS_JAX_COORDINATOR"
ENV_PROCESS_ID = "DSS_PROCESS_ID"
ENV_NUM_PROCESSES = "DSS_NUM_PROCESSES"
ENV_DRYRUN = "DSS_MULTIHOST_DRYRUN"

# exported gauge family (the reference's test_deploy_observability
# imports its copy)
MULTIHOST_METRICS = (
    "dss_multihost_processes",
    "dss_multihost_process_id",
    "dss_multihost_degraded",
    "dss_multihost_last_barrier_age_s",
    "dss_multihost_barrier_failures",
    "dss_multihost_refresh_bytes",
    "dss_multihost_commands",
    "dss_multihost_local_only",
    "dss_multihost_members",
    "dss_multihost_is_member",
)

# a collective (and a group's rendezvous) fails after this long, as a
# lockstep refresh gives up on its cut (MultihostReplica.cut_timeout_s)
COLLECTIVE_TIMEOUT_S = 30.0


class MultihostDegradedError(RuntimeError):
    """The process-spanning mesh lost a peer (barrier timeout or a
    cross-process collective failed); the caller must drop to
    local-only serving."""


class MultihostConfig(NamedTuple):
    coordinator: str  # host:port of process 0's store
    process_id: int
    num_processes: int
    # N virtual mesh positions on `device` per process (0 = one
    # position per card of `device`)
    dryrun_devices: int = 0
    init_timeout_s: float = 60.0
    # watchdog cadence: a barrier every interval; a peer missing one
    # for timeout_s flips serving to degraded local-only
    watchdog_interval_s: float = 1.0
    watchdog_timeout_s: float = 5.0
    # the device of this process's positions (cuda raises without a
    # card; cpu runs the plain versions)
    device: str = "cuda"

    @classmethod
    def from_flags(
        cls,
        coordinator: str = "",
        process_id: Optional[int] = None,
        num_processes: Optional[int] = None,
        dryrun_devices: int = 0,
        **kw,
    ) -> Optional["MultihostConfig"]:
        """Flags first, env fallbacks second; None when neither names
        a coordinator (single-process mode)."""
        coordinator = coordinator or os.environ.get(ENV_COORDINATOR, "")
        if process_id is None and os.environ.get(ENV_PROCESS_ID):
            process_id = int(os.environ[ENV_PROCESS_ID])
        if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
            num_processes = int(os.environ[ENV_NUM_PROCESSES])
        if not dryrun_devices and os.environ.get(ENV_DRYRUN):
            dryrun_devices = int(os.environ[ENV_DRYRUN])
        if not coordinator:
            return None
        if process_id is None or num_processes is None:
            raise ValueError(
                "multi-host mode needs process_id + num_processes "
                f"(flags or {ENV_PROCESS_ID}/{ENV_NUM_PROCESSES})"
            )
        return cls(
            coordinator=coordinator,
            process_id=int(process_id),
            num_processes=int(num_processes),
            dryrun_devices=int(dryrun_devices),
            **kw,
        )


class MultihostRuntime:
    """Handle on the joined multi-process runtime: coordination KV,
    barriers, the peer-loss watchdog, and the gauge family."""

    def __init__(self, cfg: MultihostConfig, store, watch_store,
                 local_devices: List[torch.device]):
        self.cfg = cfg
        self.process_id = cfg.process_id
        self.num_processes = cfg.num_processes
        self._store = store
        # the watchdog's own client: its barriers run on their own
        # thread while a mesh op holds the command stream's client
        self._watch_store = watch_store
        # this process's mesh positions (the degraded local mesh)
        self.local_devices = list(local_devices)
        self.port = store.port  # the bound coordinator port
        # what the process-spanning meshes' collectives moved
        self.seam = meshmod.SeamStats()
        self.closing = False
        self.degraded = False
        self.degraded_reason = ""
        self.refresh_bytes = 0  # tier bytes materialized via refreshes
        self.commands = 0  # command-stream length (leader==followers)
        self._barrier_failures = 0
        self._last_barrier_ok = time.monotonic()
        self._on_degraded: List[Callable[[], None]] = []
        self._watchdog: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    # -- coordination primitives ---------------------------------------------

    def kv_set(self, key: str, value: bytes) -> None:
        # chaos seam: the leader's refresh/command broadcast rides
        # this KV — an injected failure here is a refresh loss
        fault_point("multihost.refresh", detail=key)
        self._store.set(f"dssmh/{key}", value)

    def kv_get(self, key: str, timeout_s: float) -> bytes:
        """Blocks until some process sets the key (the pub/sub the
        command stream rides); raises on timeout."""
        k = f"dssmh/{key}"
        self._store.wait([k], timedelta(seconds=timeout_s))
        return self._store.get(k)

    def kv_delete(self, key: str) -> None:
        try:
            self._store.delete_key(f"dssmh/{key}")
        except Exception:  # noqa: BLE001 — GC is best-effort
            pass

    def barrier(self, name: str, timeout_s: float, store=None) -> None:
        # chaos seam: an injected barrier failure is a peer loss (the
        # watchdog's exception path -> mark_degraded, exactly as a
        # real missing process); a delay is a slow hop
        fault_point("multihost.barrier", detail=name)
        st = self._store if store is None else store
        st.set(f"dssmh-{name}/{self.process_id}", b"1")
        st.wait(
            [f"dssmh-{name}/{r}" for r in range(self.num_processes)],
            timedelta(seconds=timeout_s),
        )

    # -- degradation ----------------------------------------------------------

    def on_degraded(self, fn: Callable[[], None]) -> None:
        self._on_degraded.append(fn)

    def mark_degraded(self, reason: str) -> None:
        if self.degraded or self.closing:
            return
        self.degraded = True
        self.degraded_reason = reason
        log.error(
            "multihost mesh degraded (%s): dropping to local-only "
            "serving", reason,
        )
        for fn in list(self._on_degraded):
            try:
                fn()
            except Exception:  # noqa: BLE001 — degrade must not cascade
                log.exception("degradation callback failed")

    def ensure_healthy(self) -> None:
        if self.degraded:
            raise MultihostDegradedError(self.degraded_reason)

    # -- peer-loss watchdog ---------------------------------------------------

    def start_watchdog(self) -> None:
        """Heartbeat barrier on every process at the same cadence; a
        peer missing for watchdog_timeout_s flips degraded mode."""
        if self.num_processes < 2 or self._watchdog is not None:
            return
        stop = threading.Event()

        def loop():
            k = 0
            while not stop.is_set() and not self.closing:
                try:
                    self.barrier(f"hb-{k}", self.cfg.watchdog_timeout_s,
                                 store=self._watch_store)
                    self._last_barrier_ok = time.monotonic()
                except Exception as e:  # noqa: BLE001 — any failure = peer loss
                    if self.closing:
                        return
                    self._barrier_failures += 1
                    self.mark_degraded(
                        f"watchdog barrier hb-{k} failed: "
                        f"{type(e).__name__}"
                    )
                    return  # no peers left to heartbeat with
                if k:
                    # every process has passed hb-(k-1) once any passed
                    # hb-k: its key is garbage
                    try:
                        self._watch_store.delete_key(
                            f"dssmh-hb-{k - 1}/{self.process_id}")
                    except Exception:  # noqa: BLE001 — GC is best-effort
                        pass
                k += 1
                stop.wait(self.cfg.watchdog_interval_s)

        self._watchdog_stop = stop
        self._watchdog = threading.Thread(
            target=loop, name="dss-multihost-watchdog", daemon=True
        )
        self._watchdog.start()

    # -- lifecycle / stats ----------------------------------------------------

    def close(self) -> None:
        """Stop the watchdog.  The store and the group stay up until
        the process exits (a peer may still read the store, and
        tearing the group down blocks on a dead peer)."""
        self.closing = True
        if self._watchdog is not None:
            self._watchdog_stop.set()
            self._watchdog.join(
                timeout=self.cfg.watchdog_timeout_s + 1.0
            )
        meshmod.set_global_devices(0, None)

    def stats(self) -> dict:
        return {
            "dss_multihost_processes": self.num_processes,
            "dss_multihost_process_id": self.process_id,
            "dss_multihost_degraded": int(self.degraded),
            "dss_multihost_last_barrier_age_s": (
                round(time.monotonic() - self._last_barrier_ok, 3)
                if self._watchdog is not None
                else 0.0
            ),
            "dss_multihost_barrier_failures": self._barrier_failures,
            "dss_multihost_refresh_bytes": self.refresh_bytes,
            "dss_multihost_commands": self.commands,
        }


def local_positions(cfg: MultihostConfig) -> List[torch.device]:
    """This process's mesh positions: `dryrun_devices` virtual
    positions on `cfg.device`, else each card of `cuda` (or the one
    device named).  A cuda device without a card raises."""
    from dss_tpu_torch.ops.fastpath import resolve_device

    dev = resolve_device(cfg.device)
    if cfg.dryrun_devices:
        return meshmod.virtual_devices(dev, cfg.dryrun_devices)
    if dev.type == "cuda" and dev.index is None:
        return meshmod.local_devices()
    return [dev]


def initialize(cfg: MultihostConfig,
               on_bound: Optional[Callable[[int], None]] = None
               ) -> MultihostRuntime:
    """Join the process-spanning runtime: the coordination store
    (process 0 serves it on the coordinator's port; port 0 binds a free
    one, handed to `on_bound` before any peer is awaited, and kept as
    `runtime.port`), every process's mesh positions, and a gloo process
    group over the store.

    Differences from a stock `init_process_group`, all in service of
    serving availability:
      - a finite collective timeout (COLLECTIVE_TIMEOUT_S): a dead
        peer fails a collective, and the survivor degrades;
      - liveness belongs to the watchdog barrier, on a store client of
        its own;
      - the group is never destroyed: a degraded survivor must not
        block on dead peers at exit.
    """
    positions = local_positions(cfg)
    if dist.is_initialized():
        raise RuntimeError("multihost runtime already initialized")
    # a context on every card before any peer waits on this process:
    # creating one holds the interpreter for seconds, which would
    # starve the watchdog's heartbeat
    for dev in dict.fromkeys(positions):
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
    host, port = cfg.coordinator.rsplit(":", 1)
    host = host.strip("[]") or "127.0.0.1"
    timeout = timedelta(seconds=cfg.init_timeout_s)
    if cfg.process_id == 0:
        store = dist.TCPStore(host, int(port), cfg.num_processes, True,
                              timeout=timeout, wait_for_workers=False)
    else:
        store = dist.TCPStore(host, int(port), cfg.num_processes, False,
                              timeout=timeout)
    if on_bound is not None:
        on_bound(store.port)
    watch_store = dist.TCPStore(host, store.port, cfg.num_processes, False,
                                timeout=timeout)
    store.set(f"dssmh-devices/{cfg.process_id}",
              json.dumps([str(d) for d in positions]))
    devices = []
    for p in range(cfg.num_processes):
        names = json.loads(store.get(f"dssmh-devices/{p}"))
        devices += [
            meshmod.GlobalDevice(
                p, i, positions[i] if p == cfg.process_id else None)
            for i in range(len(names))
        ]
    dist.init_process_group(
        "gloo",
        store=dist.PrefixStore("dssmh-pg", store),
        rank=cfg.process_id,
        world_size=cfg.num_processes,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    meshmod.set_global_devices(cfg.process_id, devices)
    log.info(
        "multihost runtime up: process %d/%d via %s:%d, %d positions on "
        "%s",
        cfg.process_id, cfg.num_processes, host, store.port,
        len(positions), cfg.device,
    )
    return MultihostRuntime(cfg, store, watch_store, positions)


def member_group(members):
    """The collective group of the serving mesh's members.  Every
    process of the world calls this with the same members in the same
    order (torch.distributed.new_group), members or not."""
    return dist.new_group(
        ranks=list(members), timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    )


# -- command-stream encoding (leader -> followers over the KV store) ----------


def _encode_cmd(kind: str, arrays: Optional[dict] = None, **scalars) -> bytes:
    head = json.dumps({"kind": kind, **scalars}).encode()
    buf = io.BytesIO()
    np.savez(buf, **(arrays or {}))
    return len(head).to_bytes(4, "big") + head + buf.getvalue()


def _decode_cmd(raw: bytes):
    n = int.from_bytes(raw[:4], "big")
    head = json.loads(raw[4 : 4 + n].decode())
    arrays = {}
    if len(raw) > 4 + n:
        with np.load(io.BytesIO(raw[4 + n :]), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    return head, arrays


class MultihostReplica:
    """Process-spanning `ShardedReplica`: one replica per process over
    ONE global mesh, held in lockstep by the leader's command stream.

    Built as a wrapper (not a subclass) so the lockstep discipline has
    a single choke point: every mesh-touching entry (refresh, query)
    goes through the `_op_mu` lock, which serializes collectives
    process-wide and broadcasts the command before executing it
    locally.
    """

    def __init__(
        self,
        runtime: MultihostRuntime,
        placement,
        *,
        wal_path: Optional[str] = None,
        region_client=None,
        max_results: int = 512,
        warm_batches=(1,),
        tier_ratio: Optional[float] = None,
        cut_timeout_s: float = 30.0,
        members: Optional[tuple] = None,
    ):
        from dss_tpu_torch.parallel.replica import ShardedReplica

        self.runtime = runtime
        self.placement = placement
        self._cut_timeout_s = cut_timeout_s
        # elastic membership: the joined world is the provisioned slot
        # pool; `members` is the subset of processes whose positions
        # form the SERVING mesh.  A standby process (world member, not
        # mesh member) tails the log in lockstep — that IS its
        # snapshot+tail catch-up — and the next fold after a reform
        # cuts it into the boundary map.
        self._members = (
            tuple(sorted(set(members)))
            if members
            else tuple(range(runtime.num_processes))
        )
        if 0 not in self._members:
            raise ValueError("process 0 (the leader) must be a member")
        self._pending_members: Optional[tuple] = None
        self._dp = placement.dp
        self._attach(placement.mesh, member_group(self._members))
        self._inner = ShardedReplica(
            placement.mesh,
            wal_path=wal_path,
            region_client=region_client,
            max_results=max_results,
            warm_batches=warm_batches,
            tier_ratio=tier_ratio,
        )
        # one mesh op at a time, process-wide: the command stream IS
        # the global collective order, so local execution must follow
        # it strictly
        self._op_mu = threading.RLock()
        self._seq = 0  # leader: next command seq to publish
        # extension point: out-of-band command kinds a harness can
        # register (the dryrun's peer-kill rides this)
        self.extra_commands = {}
        self._local_only = False  # degraded: serve from local state
        self._local_rebuilt = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        runtime.on_degraded(self._on_peer_loss)
        runtime.start_watchdog()

    # -- shared helpers -------------------------------------------------------

    @property
    def mesh(self):
        return self._inner.mesh

    @property
    def members(self) -> tuple:
        return self._members

    @property
    def is_member(self) -> bool:
        """Is THIS process part of the serving mesh (vs a standby
        slot tailing the log awaiting a join)?"""
        return self.runtime.process_id in self._members

    def _attach(self, mesh, group) -> None:
        """A global mesh's collectives run on the members' group, and
        what they move counts on the runtime."""
        mesh.group = group
        mesh.seam = self.runtime.seam

    def _account_refresh_bytes(self) -> None:
        self.runtime.refresh_bytes = self._inner.device_bytes_built

    def _on_peer_loss(self) -> None:
        """Watchdog callback: flip to host-only serving NOW (correct —
        every process tails the full log), and let the refresh loop
        rebuild the dars on a local mesh."""
        self._local_only = True

    def _reset_tiers(self) -> None:
        """Force a full rebuild of every class at the next refresh
        (the mesh changed shape)."""
        inner = self._inner
        inner.reset_boundaries()
        with inner._mu:
            for c in inner._records:
                inner._base[c] = set()
                inner._delta[c] = {}
                inner._shadow[c] = set()
                inner._dirty[c] = True
            inner._snapshots = {c: None for c in inner._snapshots}

    def _degrade_rebuild_locked(self) -> None:
        """Re-home the replica on a local-only mesh and force a full
        rebuild of every class (the global mesh's shards are useless —
        their collectives would fail on dead peers)."""
        from dss_tpu_torch.parallel.mesh import make_mesh

        inner = self._inner
        local = self.runtime.local_devices
        inner.mesh = make_mesh(len(local), devices=local)
        # the old mesh's sp count is gone with the peers: the boundary
        # map (n_sp-1 split points) no longer applies
        self._reset_tiers()
        inner.refresh()
        self._local_rebuilt = True
        log.warning(
            "multihost replica re-homed on a local %s mesh "
            "(degraded local-only serving)", dict(inner.mesh.shape),
        )

    # -- leader side ----------------------------------------------------------

    def _broadcast(self, kind: str, arrays=None, **scalars) -> None:
        if self.runtime.num_processes < 2:
            return  # single-process mesh: nobody to pace
        payload = _encode_cmd(kind, arrays, **scalars)
        self.runtime.kv_set(f"cmd/{self._seq}", payload)
        self._seq += 1
        self.runtime.commands = self._seq
        # bound the store's footprint: followers are at most a few
        # commands behind (each blocks on seq order), so a long window
        # is already generous
        if self._seq > 4096:
            self.runtime.kv_delete(f"cmd/{self._seq - 4096}")

    def broadcast_control(self, kind: str, **scalars) -> None:
        """Publish an out-of-band command (must be registered in the
        followers' `extra_commands`)."""
        with self._op_mu:
            self._broadcast(kind, **scalars)

    def set_members(self, members) -> None:
        """Request a membership change (join and/or leave): the NEXT
        leader sync broadcasts a reform with the fold cut, every
        member re-homes on a mesh over the new member set, and the
        incoming process's lockstep log tail becomes its serving
        state.  Leader-side API."""
        m = tuple(sorted(set(int(p) for p in members)))
        if 0 not in m:
            raise ValueError("process 0 (the leader) must be a member")
        bad = [p for p in m if p >= self.runtime.num_processes]
        if bad:
            raise ValueError(
                f"members {bad} outside the provisioned world "
                f"(num_processes={self.runtime.num_processes})"
            )
        self._pending_members = m

    def _apply_reform(self, members: tuple) -> None:
        """Re-home the replica on a mesh over `members` (runs on every
        process, leader and follower alike, at the broadcast cut).
        Members rebuild every class major on the new mesh (each host
        materializes only its addressable shard rows); a process that
        left drops its device state and keeps tailing as standby."""
        from dss_tpu_torch.parallel.mesh import make_global_mesh

        inner = self._inner
        # every process of the world, at the same cut
        group = member_group(members)
        self._members = tuple(members)
        if self.is_member:
            placement = make_global_mesh(
                dp=self._dp, processes=self._members
            )
            self._attach(placement.mesh, group)
            self.placement = placement
            inner.mesh = placement.mesh
        self._reset_tiers()
        if self.is_member:
            inner.refresh(plan=False)
            self._account_refresh_bytes()
            log.info(
                "mesh reformed: members %s, placement %s",
                self._members, self.placement.describe(),
            )
        else:
            log.info(
                "left the serving mesh (members now %s); tailing as "
                "standby", self._members,
            )

    def _boundary_payload(self) -> dict:
        inner = self._inner
        return {
            "boundaries": (
                None
                if inner.boundaries is None
                else [int(x) for x in inner.boundaries]
            ),
            "bgen": inner.boundary_gen,
            # boundary-aware result capacity sized by the leader from
            # the post-rebalance predicted load: ships with the map so
            # every process builds identical result-slot shapes
            "sres": inner.shard_results_effective,
        }

    def sync(self) -> None:
        """Leader pacing: poll the tail to its current end, broadcast
        the exact cut (+ the rebalanced boundary map), fold in
        lockstep.  A pending membership change reforms the mesh at
        this fold boundary first.  Degraded: plain local sync."""
        with self._op_mu:
            inner = self._inner
            if self._local_only:
                if not self._local_rebuilt:
                    self._degrade_rebuild_locked()
                inner.sync()
                self._account_refresh_bytes()
                return
            if not self.runtime.is_leader:
                raise RuntimeError(
                    "followers are paced by run_follower(), not sync()"
                )
            inner.poll_once()
            if self._pending_members is not None:
                m, self._pending_members = self._pending_members, None
                if m != self._members:
                    cut = inner.tail_position()
                    try:
                        self._broadcast(
                            "reform",
                            cut=cut,
                            fp=inner.state_fingerprint(),
                            members=list(m),
                        )
                        self._apply_reform(m)
                    except MultihostDegradedError:
                        raise
                    except Exception as e:  # noqa: BLE001
                        if self._maybe_degrade_on(e):
                            return
                        raise
                    return
            # the rebalance decision is leader-only (followers apply
            # the broadcast boundaries verbatim); a boundary move
            # marks every class dirty, so the fold below ships it
            inner.plan_rebalance()
            with inner._mu:
                dirty = any(inner._dirty.values()) or any(
                    s is None for s in inner._snapshots.values()
                )
            if not dirty:
                return  # nothing to fold: no collectives, no command
            cut = inner.tail_position()
            try:
                self._broadcast(
                    "refresh",
                    cut=cut,
                    fp=inner.state_fingerprint(),
                    **self._boundary_payload(),
                )
                inner.refresh(plan=False)
            except MultihostDegradedError:
                raise
            except Exception as e:  # noqa: BLE001 — collective failure
                if self._maybe_degrade_on(e):
                    return
                raise
            self._account_refresh_bytes()

    def query_batch(
        self,
        keys_list,
        alt_lo,
        alt_hi,
        t_start,
        t_end,
        *,
        now,
        cls: str = "ops",
    ):
        inner = self._inner
        # paths that never touch the global mesh answer WITHOUT the
        # mesh-op lock: a follower's (or degraded survivor's) reads
        # must not queue behind an in-flight lockstep fold they take
        # no part in
        if not self.runtime.is_leader:
            # followers cannot initiate mesh collectives (only replay
            # them): their own read traffic answers exactly from the
            # host record map
            return inner.query_batch_host(
                keys_list, alt_lo, alt_hi, t_start, t_end,
                now=now, cls=cls,
            )
        if self._local_only:
            if not self._local_rebuilt:
                # mesh gone, local dars not rebuilt yet: answer
                # exactly from the host record map (no collectives)
                return inner.query_batch_host(
                    keys_list, alt_lo, alt_hi, t_start, t_end,
                    now=now, cls=cls,
                )
            # re-homed on a local mesh: ordinary single-process
            # replica queries, concurrency-safe by snapshot
            return inner.query_batch(
                keys_list, alt_lo, alt_hi, t_start, t_end,
                now=now, cls=cls,
            )
        with self._op_mu:
            if self._local_only:
                # degradation flipped while we waited for the lock
                return inner.query_batch_host(
                    keys_list, alt_lo, alt_hi, t_start, t_end,
                    now=now, cls=cls,
                )
            qkeys, alo, ahi, ts, te, now_arr = inner.pad_query_batch(
                keys_list, alt_lo, alt_hi, t_start, t_end, now=now
            )
            try:
                self._broadcast(
                    "query",
                    arrays={
                        "qkeys": qkeys, "alt_lo": alo, "alt_hi": ahi,
                        "t_start": ts, "t_end": te, "now": now_arr,
                    },
                    cls=cls,
                )
                rows = inner.query_padded(
                    cls, qkeys, alo, ahi, ts, te, now_arr
                )
                # leader-side load accounting (the planning input):
                # followers never record — the leader's map is the one
                # the broadcast boundaries come from
                for i, row in enumerate(rows):
                    inner.load.record(keys_list[i], len(row))
                return rows
            except Exception as e:  # noqa: BLE001 — collective failure
                if self._maybe_degrade_on(e):
                    return inner.query_batch_host(
                        keys_list, alt_lo, alt_hi, t_start, t_end,
                        now=now, cls=cls,
                    )
                raise

    def _maybe_degrade_on(self, e: Exception) -> bool:
        """A cross-process collective died under us (peer loss beat
        the watchdog to it): degrade instead of failing the caller."""
        if self.runtime.closing or self._local_only:
            return True
        log.error(
            "multihost mesh op failed (%s: %s); degrading",
            type(e).__name__, e,
        )
        self.runtime.mark_degraded(f"mesh op failed: {type(e).__name__}")
        return self._local_only  # set by the callback

    def query(self, *args, **kw):
        """Single-query surface (the /aux replica routes)."""
        return self._query_via_batch(*args, **kw)

    def _query_via_batch(
        self,
        keys,
        alt_lo=None,
        alt_hi=None,
        t_start=None,
        t_end=None,
        *,
        now,
        cls="ops",
        owner=None,
    ):
        from dss_tpu_torch.ops.conflict import NO_TIME_HI, NO_TIME_LO

        keys = np.asarray(keys, np.int32).ravel()
        if keys.size == 0:
            return []
        rows = self.query_batch(
            [keys],
            np.asarray(
                [-np.inf if alt_lo is None else alt_lo], np.float32
            ),
            np.asarray(
                [np.inf if alt_hi is None else alt_hi], np.float32
            ),
            np.asarray(
                [NO_TIME_LO if t_start is None else t_start], np.int64
            ),
            np.asarray(
                [NO_TIME_HI if t_end is None else t_end], np.int64
            ),
            now=now,
            cls=cls,
        )
        return self._inner.filter_owner(rows[0], cls, owner)

    # -- follower side --------------------------------------------------------

    def run_follower(self, poll_timeout_s: float = 1.0) -> None:
        """Replay the leader's command stream until stopped.  Returns
        normally on a stop command; raises MultihostDegradedError when
        the mesh degrades (the caller decides whether to keep serving
        local-only or exit)."""
        if self.runtime.is_leader:
            raise RuntimeError("run_follower() is for processes > 0")
        seq = 0
        inner = self._inner
        while not self._stop.is_set():
            try:
                raw = self.runtime.kv_get(f"cmd/{seq}", poll_timeout_s)
            except Exception:  # noqa: BLE001 — timeout or leader gone
                if self._stop.is_set():
                    return
                if self._local_only or self.runtime.degraded:
                    self._local_only = True
                    raise MultihostDegradedError(
                        self.runtime.degraded_reason or "leader lost"
                    )
                continue
            head, arrays = _decode_cmd(raw)
            seq += 1
            self.runtime.commands = seq
            kind = head["kind"]
            try:
                with self._op_mu:
                    if kind == "stop":
                        return
                    if kind == "refresh":
                        self._follower_refresh(
                            head["cut"],
                            head.get("fp"),
                            boundaries=head.get("boundaries"),
                            bgen=head.get("bgen", 0),
                            shard_results=head.get("sres"),
                        )
                    elif kind == "reform":
                        # membership change at the broadcast cut: tail
                        # there first (the joiner's snapshot+tail
                        # catch-up ends exactly at the cut), verify
                        # state, then re-home on the new member mesh
                        self._follower_tail_to(
                            head["cut"],
                            head.get("fp"),
                            # a reform rebuilds major from records on
                            # every process: tier bookkeeping (which a
                            # joining standby never accumulated) does
                            # not participate in the new shapes
                            content_only=True,
                        )
                        self._apply_reform(tuple(head["members"]))
                    elif kind == "query":
                        if self.is_member:
                            inner.query_padded(
                                head["cls"],
                                arrays["qkeys"],
                                arrays["alt_lo"],
                                arrays["alt_hi"],
                                arrays["t_start"],
                                arrays["t_end"],
                                arrays["now"],
                            )
                    elif kind in self.extra_commands:
                        self.extra_commands[kind](head)
            except MultihostDegradedError as e:
                self.runtime.mark_degraded(str(e))
                raise
            except Exception as e:  # noqa: BLE001 — collective failure
                self.runtime.mark_degraded(
                    f"follower replay failed: {type(e).__name__}"
                )
                raise MultihostDegradedError(str(e)) from e

    @staticmethod
    def _fp_content(fp: Optional[dict]) -> Optional[dict]:
        """The log-content half of a state fingerprint: applied counts
        and per-class record counts, WITHOUT the tier bookkeeping.  A
        standby process tails the log but never folds, so its
        delta/base/shadow split legitimately differs from the members'
        — yet its RECORDS must match exactly, and a reform rebuilds
        every class major from records alone."""
        if fp is None:
            return None
        return {
            "applied": fp.get("applied"),
            "apply_errors": fp.get("apply_errors"),
            "classes": {
                c: v[0] for c, v in fp.get("classes", {}).items()
            },
        }

    def _follower_tail_to(
        self, cut, leader_fp, content_only: bool = False
    ) -> None:
        """Tail to EXACTLY the leader's cut and verify state: both
        processes then hold the identical record prefix, so tier
        decisions, array shapes, and the resulting collective sequence
        all match.  The leader's state fingerprint is checked BEFORE
        any collective is issued — a divergent fold must degrade,
        never wedge the mesh with mismatched shapes.  `content_only`
        compares records, not tier bookkeeping (standby catch-up checks
        and reforms, where every class rebuilds major from the record
        map)."""
        inner = self._inner
        deadline = time.monotonic() + self._cut_timeout_s
        while inner.tail_position() < cut:
            inner.poll_once(limit=cut)
            if inner.tail_position() >= cut:
                break
            if time.monotonic() > deadline:
                raise MultihostDegradedError(
                    f"refresh cut {cut} unreachable (tail at "
                    f"{inner.tail_position()})"
                )
            time.sleep(0.01)
        if inner.tail_position() != cut:
            raise MultihostDegradedError(
                f"tail overshot the refresh cut ({cut} -> "
                f"{inner.tail_position()}): lockstep broken"
            )
        fp = inner.state_fingerprint()
        if content_only:
            fp, leader_fp = (
                self._fp_content(fp), self._fp_content(leader_fp)
            )
        if leader_fp is not None and fp != leader_fp:
            raise MultihostDegradedError(
                f"replica state diverged from leader at cut {cut}: "
                f"{fp} != {leader_fp}"
            )

    def _follower_refresh(
        self, cut, leader_fp, boundaries=None, bgen: int = 0,
        shard_results=None,
    ) -> None:
        """Tail to the cut, adopt the leader's boundary map verbatim
        (the load measurement lives on the leader — followers must
        never plan their own split or the mesh would build mismatched
        shard rows), then fold.  A standby (non-member) process stops
        after the tail: staying caught up IS its snapshot+tail
        readiness for a future join."""
        self._follower_tail_to(
            cut, leader_fp, content_only=not self.is_member
        )
        if not self.is_member:
            return
        inner = self._inner
        inner.apply_boundaries(boundaries, bgen,
                               shard_results=shard_results)
        inner.refresh(plan=False)
        self._account_refresh_bytes()

    # -- lifecycle / passthrough ----------------------------------------------

    def start(self, interval_s: float = 0.5) -> None:
        """Leader: background pacing loop (poll + broadcast + fold)."""
        self._interval_s = interval_s
        self._inner._interval_s = interval_s

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sync()
                except Exception:  # noqa: BLE001 — keep pacing alive
                    log.exception("multihost refresh failed")

        self._thread = threading.Thread(
            target=loop, name="multihost-replica", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self.runtime.closing = True
        self._stop.set()
        if (
            self.runtime.is_leader
            and not self._local_only
            and self.runtime.num_processes > 1
        ):
            try:
                with self._op_mu:
                    self._broadcast("stop")
            except Exception:  # noqa: BLE001 — peers may be gone
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._inner.close()

    def fresh(self, bound_s: Optional[float] = None) -> bool:
        if self._local_only:
            return False  # degraded: bounded-staleness contract broken
        if not self.is_member:
            return False  # standby slot: no mesh state to serve from
        return self._inner.fresh(bound_s)

    def staleness_s(self) -> float:
        return self._inner.staleness_s()

    def poll_once(self, limit=None) -> int:
        return self._inner.poll_once(limit=limit)

    def use_load(self, load) -> None:
        """Adopt the store's shared RangeLoad (leader serving path);
        see ShardedReplica.use_load."""
        self._inner.use_load(load)

    def stats(self) -> dict:
        out = self._inner.stats()
        out.update(self.runtime.stats())
        out["dss_multihost_local_only"] = int(self._local_only)
        out["dss_multihost_members"] = len(self._members)
        out["dss_multihost_is_member"] = int(self.is_member)
        out.update(self.runtime.seam.stats())
        return out

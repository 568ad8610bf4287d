"""Region log replication: quorum-acked mirrors + failover promotion.

The port of the reference's `dss_tpu/region/mirror.py`.  It removes the
region's single point of failure: the upstream DSS rides on
CockroachDB, so a Region survives losing any one node's process or disk
via Raft-replicated ranges (its concepts.md:23,
implementation_details.md:11-42).  Here the same property comes from a PRIMARY region log server
fanning every append out to N MIRROR processes and acking only at
`quorum` total durable copies.

Topology and life cycle:

  primary:  `region_server --quorum 2`
  mirrors:  `region_server --mirror_of http://primary:8090 \
                 --advertise_url http://me:8091`

  - Mirrors REGISTER with the primary (heartbeat, ~1 s) reporting
    their log head; the primary runs one ordered sender per mirror
    that pushes entries from that head (batched over one connection,
    so a mirror always applies contiguously).
  - A mirror behind compaction receives the primary's snapshot first
    (wholesale install), then the tail — the same snapshot+tail shape
    instances use to late-join.
  - An append is acked to the writer only once `quorum` copies exist
    (the primary's own WAL counts as one).  Quorum unreachable =>
    503, reported like an ambiguous network failure: the writer rolls
    back and its txn-id makes a retry dedup instead of double-append.
  - PROMOTION (`POST /promote`, or `region_server --promote`) turns a
    mirror into primary by bumping the log's persisted epoch
    generation.  Because acks require contiguous durable appends, the
    mirror with the MAX head provably holds every quorum-acked write
    — the runbook (docs/OPERATIONS.md) promotes that one.
  - FENCING: a mirror rejects /replicate pushes whose epoch
    generation is lower than (or tied with a different lineage than)
    its own adopted epoch; a primary seeing that rejection DEMOTES
    itself (writes answer 503 not-primary from then on).  With
    quorum >= 2 a demoted/stale primary can therefore never ack a
    write, converting split-brain into a detected client resync
    instead of corruption.  (quorum=1 keeps today's single-node
    semantics, split-brain risk included — documented.)

This module holds the node state machine + replication plumbing; the
HTTP endpoints live in region/log_server.py.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Dict, Optional

from aiohttp import web

from dss_tpu_torch import chaos
from dss_tpu_torch.obs.metrics import MetricsRegistry

log_ = logging.getLogger("dss.region.mirror")

REPL_BATCH = 64  # entries per /replicate push
HEARTBEAT_S = 1.0  # mirror -> primary register cadence
PRUNE_AFTER_S = 30.0  # drop mirrors silent for this long

# shared stack-wide backoff for the per-mirror sender loop (replaces
# the hand-rolled min(0.1 * 2**fails, 2.0) * (0.5+rand)): capped and
# jittered via ONE policy so a flapping mirror backs off exactly like
# every other transport in the stack, and its CURRENT backoff is
# exported (region_mirror_backoff_s) so the flap is visible before the
# lag alert fires
_SENDER_BACKOFF = chaos.RetryPolicy(
    base_s=0.1, cap_s=2.0, multiplier=2.0, jitter=0.5
)

# every metric name the region log server exports at /metrics —
# imported by tests/test_deploy_observability.py so dashboards and
# alert rules can only reference real series
REGION_SERVER_METRICS = (
    "region_is_primary",
    "region_quorum_size",
    "region_mirror_count",
    "region_mirror_lag_entries",
    "region_epoch_gen",
    "region_log_head",
    "region_log_base",
    "region_snapshot_index",
    "region_promotions_total",
    "region_demotions_total",
    "region_quorum_failures_total",
    "region_stale_primary_rejects_total",
    "region_replicated_entries_total",
    "region_mirror_backoff_s",
)


class _MirrorPeer:
    """Primary-side view of one registered mirror."""

    def __init__(self, url: str, head: int, epoch: str = ""):
        self.url = url
        self.acked_head = head  # entries known durably applied there
        self.epoch = epoch  # epoch the mirror last reported/acked under
        self.snap_acked = 0  # last snapshot index pushed for compaction
        self.wake = asyncio.Event()
        self.task: Optional[asyncio.Task] = None
        self.last_seen = time.monotonic()
        self.last_error: Optional[str] = None
        self.fails = 0  # consecutive push failures (backoff)
        self.backoff_s = 0.0  # current sender backoff (0 = healthy)


class RegionNode:
    """Role state machine (primary / mirror / demoted) + replication.

    All methods run on the server's event-loop thread; the only
    concurrency is between asyncio tasks, so plain attributes are
    safe."""

    def __init__(
        self,
        log,
        *,
        mirror_of: Optional[str] = None,
        advertise_url: Optional[str] = None,
        quorum: int = 1,
        repl_timeout_s: float = 5.0,
        auth_token: Optional[str] = None,
    ):
        self.log = log
        self.quorum = max(1, int(quorum))
        self.role = "mirror" if mirror_of else "primary"
        self.primary_url = mirror_of.rstrip("/") if mirror_of else None
        self.advertise_url = (
            advertise_url.rstrip("/") if advertise_url else None
        )
        self.repl_timeout_s = float(repl_timeout_s)
        self._auth = auth_token
        self._session = None
        self._hb_task: Optional[asyncio.Task] = None
        self.mirrors: Dict[str, _MirrorPeer] = {}
        # commit waiters: [entry_index, set(acked urls), future]
        self._waiters: list = []
        self.superseded_by: Optional[str] = None
        # set on demotion: this log may hold a diverged suffix (an
        # append that never reached quorum), so reads stay refused —
        # even after a repoint back to mirror — until the new primary's
        # first push resets the log under its epoch
        self.diverged = False
        # mirror-side: the primary head last seen (lag = that - ours)
        self.primary_head_seen = log.head
        self.promotions = 0
        self.demotions = 0
        self.quorum_failures = 0
        self.stale_rejects = 0
        self.replicated_entries = 0
        self._registry = MetricsRegistry()
        if (
            self.role == "primary"
            and self.quorum >= 2
            and getattr(log, "boot_rotation", False)
        ):
            # a REPLICATED primary that booted through a recovery
            # rotation must not resume primacy on its own: its log may
            # have regressed below quorum-acked entries that survive
            # only on mirrors, and a supervisor crash-loop would mint
            # generations that outrank a real promotion elsewhere.
            # It waits demoted (writes and reads refused, nothing
            # pushed) until an operator either confirms primacy
            # (--promote, ideally with min_head) or re-mirrors it.
            # quorum=1 keeps today's single-node auto-resume.
            self.role = "demoted"
            self.diverged = True
            log_.error(
                "boot after recovery rotation with quorum=%d: refusing "
                "primacy until confirmed — run `region_server --promote "
                "--addr :<port>` if this node should lead (check "
                "mirror heads first: promote the HIGHEST), or repoint/"
                "re-mirror it under the promoted primary",
                self.quorum,
            )

    # -- life cycle ---------------------------------------------------------

    async def start(self) -> None:
        import aiohttp

        headers = (
            {"Authorization": f"Bearer {self._auth}"} if self._auth else {}
        )
        self._session = aiohttp.ClientSession(headers=headers)
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop()
        )

    async def stop(self) -> None:
        tasks = [self._hb_task] + [
            m.task for m in self.mirrors.values() if m.task is not None
        ]
        for t in tasks:
            if t is not None:
                t.cancel()
        for t in tasks:
            if t is not None:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        if self._session is not None:
            await self._session.close()

    async def _post(self, url: str, payload: dict):
        import aiohttp

        from dss_tpu_torch.obs import trace as _trace

        # chaos seam: a dropped/delayed push reads exactly like a
        # flaky replication link (the sender loop backs off and
        # retries; quorum math and promotion fencing are unaffected —
        # tests/test_region_mirror.py pins this under injected flaps)
        await chaos.async_fault_point(
            "region.mirror.replicate", detail=url
        )
        t = aiohttp.ClientTimeout(total=self.repl_timeout_s)
        # propagate the active trace id across the replication hop
        # (usually absent — the sender is a background loop — but a
        # synchronous quorum push triggered under a traced request
        # keeps its id, and the receiver echoes it either way)
        tp = _trace.propagation_headers()
        async with self._session.post(
            url, json=payload, timeout=t, headers=tp or None,
        ) as r:
            try:
                body = await r.json()
            except Exception:
                body = {}
            return r.status, body if isinstance(body, dict) else {}

    # -- role / status ------------------------------------------------------

    def primary_hint(self) -> Optional[str]:
        """Best-known primary URL for 503 not-primary redirects."""
        if self.role == "primary":
            return self.advertise_url
        if self.role == "mirror":
            return self.primary_url
        return self.superseded_by

    def lag_entries(self) -> int:
        if self.role == "mirror":
            return max(0, self.primary_head_seen - self.log.head)
        if self.mirrors:
            return max(
                max(0, self.log.head - m.acked_head)
                for m in self.mirrors.values()
            )
        return 0

    def status(self) -> dict:
        return {
            "role": self.role,
            "diverged": self.diverged,
            "epoch": self.log.epoch,
            "head": self.log.head,
            "base": self.log.base,
            "snapshot_index": self.log.snapshot_index,
            "quorum": self.quorum,
            "primary": self.primary_hint(),
            "lag_entries": self.lag_entries(),
            "mirrors": {
                m.url: {
                    "acked_head": m.acked_head,
                    "lag": max(0, self.log.head - m.acked_head),
                    "last_seen_s_ago": round(
                        time.monotonic() - m.last_seen, 1
                    ),
                    "last_error": m.last_error,
                    "backoff_s": round(m.backoff_s, 3),
                }
                for m in self.mirrors.values()
            },
            "promotions": self.promotions,
            "demotions": self.demotions,
            "quorum_failures": self.quorum_failures,
            "stale_primary_rejects": self.stale_rejects,
        }

    def render_metrics(self) -> str:
        # prune here too: with no surviving mirror heartbeating, no
        # register call ever runs, and a dead-forever peer would keep
        # region_mirror_count inflated — hiding exactly the
        # under-provisioned-quorum state the alert watches for
        self._prune(time.monotonic())
        r = self._registry
        r.set_gauge("region_is_primary", 1.0 if self.role == "primary" else 0.0)
        r.set_gauge("region_quorum_size", self.quorum)
        r.set_gauge("region_mirror_count", len(self.mirrors))
        r.set_gauge("region_mirror_lag_entries", self.lag_entries())
        r.set_gauge("region_epoch_gen", self.log.epoch_generation)
        r.set_gauge("region_log_head", self.log.head)
        r.set_gauge("region_log_base", self.log.base)
        r.set_gauge("region_snapshot_index", self.log.snapshot_index)
        r.set_counter("region_promotions_total", self.promotions)
        r.set_counter("region_demotions_total", self.demotions)
        r.set_counter("region_quorum_failures_total", self.quorum_failures)
        r.set_counter(
            "region_stale_primary_rejects_total", self.stale_rejects
        )
        r.set_counter(
            "region_replicated_entries_total", self.replicated_entries
        )
        # the worst current sender backoff: nonzero means a mirror
        # link is flapping RIGHT NOW, before lag accumulates enough to
        # trip the lag alert
        r.set_gauge(
            "region_mirror_backoff_s",
            max(
                (m.backoff_s for m in self.mirrors.values()),
                default=0.0,
            ),
        )
        return r.render()

    # -- primary side: registration, fan-out, quorum ------------------------

    def register_mirror(self, url: str, head: int, epoch: str = "") -> None:
        url = url.rstrip("/")
        now = time.monotonic()
        m = self.mirrors.get(url)
        if m is None:
            m = _MirrorPeer(url, head, epoch)
            self.mirrors[url] = m
            m.task = asyncio.get_running_loop().create_task(
                self._sender_loop(m)
            )
            log_.info("mirror registered: %s at head %d", url, head)
        else:
            # the mirror's self-reported head is authoritative (it may
            # have restarted and truncated a torn tail) — and a head
            # that MOVED BACK (or an epoch change) voids any ack this
            # peer contributed to still-waiting commits: the entry it
            # acked may be in the tail it just lost
            if head < m.acked_head or epoch != m.epoch:
                self._revoke_acks(m)
            m.acked_head = head
            m.epoch = epoch
            m.last_seen = now
        # a heartbeat can carry the first proof an entry reached the
        # mirror (the push landed but its response was lost): resolve
        # waiters here too, or a quorum-satisfied commit() would sit
        # out the full replication timeout and 503
        self._on_ack(m)
        self._prune(now)
        m.wake.set()

    def _prune(self, now: float) -> None:
        for url in list(self.mirrors):
            m = self.mirrors[url]
            if now - m.last_seen > PRUNE_AFTER_S:
                if m.task is not None:
                    m.task.cancel()
                del self.mirrors[url]
                log_.warning("mirror pruned (silent %ds): %s",
                             int(PRUNE_AFTER_S), url)

    def notify_snapshot(self) -> None:
        """Primary compacted: nudge senders so mirrors compact too."""
        for m in self.mirrors.values():
            m.wake.set()

    async def commit(self, idx: int) -> bool:
        """Block until entry `idx` exists on `quorum` nodes (this
        primary's WAL counts as one) or the replication timeout hits.
        K=1 returns immediately — single-node behavior unchanged (the
        push to any registered mirrors still happens, async)."""
        self._prune(time.monotonic())  # silent mirrors must not count
        for m in self.mirrors.values():
            m.wake.set()
        need = self.quorum - 1
        if need <= 0:
            return True
        # only same-epoch mirrors count: a rejoining peer on another
        # epoch (a repointed ex-primary, say) may report an inflated
        # head from a DIVERGED log that does not hold this entry
        acked = {
            m.url
            for m in self.mirrors.values()
            if m.acked_head > idx and m.epoch == self.log.epoch
        }
        if len(acked) >= need:
            return True
        fut = asyncio.get_running_loop().create_future()
        waiter = [idx, acked, fut]
        self._waiters.append(waiter)
        try:
            ok = await asyncio.wait_for(fut, self.repl_timeout_s)
            # a False result means the waiters were failed (this node
            # was demoted mid-wait): never ack from a demoted primary
            return bool(ok) and self.role == "primary"
        except asyncio.TimeoutError:
            self.quorum_failures += 1
            return False
        finally:
            if waiter in self._waiters:
                self._waiters.remove(waiter)

    def _on_ack(self, m: _MirrorPeer) -> None:
        if m.epoch != self.log.epoch:
            return  # stale-epoch peer: its head is not ours to count
        need = self.quorum - 1
        for waiter in self._waiters:
            idx, acked, fut = waiter
            if m.acked_head > idx and m.url not in acked:
                acked.add(m.url)
                if len(acked) >= need and not fut.done():
                    fut.set_result(True)

    def _revoke_acks(self, m: _MirrorPeer) -> None:
        for _, acked, _ in self._waiters:
            acked.discard(m.url)

    def _fail_waiters(self) -> None:
        for _, _, fut in self._waiters:
            if not fut.done():
                fut.set_result(False)

    async def _sender_loop(self, m: _MirrorPeer) -> None:
        """Ordered push stream to ONE mirror: snapshot when it is
        below our compaction base, then contiguous entry batches from
        its acked head.  One task per mirror = per-mirror ordering."""
        while True:
            await m.wake.wait()
            m.wake.clear()
            try:
                await self._drain(m)
                m.fails = 0
                m.backoff_s = 0.0
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — keep the stream alive
                m.fails += 1
                m.last_error = repr(e)
                m.backoff_s = _SENDER_BACKOFF.backoff_s(m.fails - 1)
                await asyncio.sleep(m.backoff_s)
                if time.monotonic() - m.last_seen < PRUNE_AFTER_S:
                    m.wake.set()  # retry until the registry prunes it

    async def _drain(self, m: _MirrorPeer) -> None:
        log = self.log
        while self.role == "primary":
            if m.epoch != log.epoch:
                # epoch sync: a rejoining mirror on a different epoch
                # (e.g. the demoted ex-primary re-mirrored after a
                # failover) may hold a DIVERGED log even when its head
                # is not behind ours — an empty push makes it adopt
                # our epoch (resetting its log if the generation
                # advanced) and report its authoritative head back
                st, body = await self._post(
                    m.url + "/replicate",
                    {"epoch": log.epoch, "head": log.head, "entries": []},
                )
                if not self._accept(m, st, body):
                    return
                m.epoch = log.epoch
            if m.acked_head < log.base:
                snap = log.get_snapshot()
                if snap is None:
                    raise RuntimeError(
                        "mirror below base but no snapshot to send"
                    )
                if not await self._push_snapshot(m, *snap):
                    return
                continue
            if (
                m.snap_acked < log.snapshot_index
                and m.acked_head >= log.snapshot_index
                and log.get_snapshot() is not None
            ):
                # rolling compaction: the mirror has the entries, it
                # just needs the snapshot to compact its own WAL
                if not await self._push_snapshot(m, *log.get_snapshot()):
                    return
            if m.acked_head >= log.head:
                return
            batch = log.fetch_full(m.acked_head, REPL_BATCH)
            if batch is None:
                continue  # compacted under us; loop sends the snapshot
            n = len(batch)
            st, body = await self._post(
                m.url + "/replicate",
                {
                    "epoch": log.epoch,
                    "from": m.acked_head,
                    "entries": batch,
                    "head": log.head,
                },
            )
            if not self._accept(m, st, body):
                return
            if st == 200:
                self.replicated_entries += n

    async def _push_snapshot(self, m: _MirrorPeer, index, state) -> bool:
        st, body = await self._post(
            m.url + "/replicate",
            {
                "epoch": self.log.epoch,
                "snapshot": {"index": index, "state": state},
                "head": self.log.head,
            },
        )
        if self._accept(m, st, body) and st == 200:
            m.snap_acked = index
            return True
        return False

    def _accept(self, m: _MirrorPeer, st: int, body: dict) -> bool:
        """Common /replicate response handling -> keep draining?"""
        from dss_tpu_torch.region.log_server import epoch_gen

        if st == 200:
            # a 200 push proves the mirror is on OUR epoch (anything
            # else answers 409): stamp it before counting the ack
            m.epoch = self.log.epoch
            m.acked_head = int(body.get("head", m.acked_head))
            m.last_seen = time.monotonic()
            m.last_error = None
            self._on_ack(m)
            return True
        if st == 409 and body.get("error") == "stale_epoch":
            if epoch_gen(body.get("epoch")) > self.log.epoch_generation:
                # the mirror adopted a NEWER primary: we were
                # superseded by a promotion — step down
                self._demote(body.get("primary"))
            else:
                # a mirror from another lineage at our own (or lower)
                # generation: never push over it; operators re-mirror
                # it explicitly (runbook)
                m.last_error = "stale_epoch (diverged lineage)"
            return False
        if st == 409 and body.get("error") == "diverged_ahead":
            # the mirror's log extends past ours: WE are a regressed
            # (crash-rotated) primary and must not overwrite it.  Stop
            # pushing; with quorum >= 2 our appends can never ack, so
            # the operator promotes that mirror and re-mirrors us.
            m.last_error = (
                f"mirror ahead of us at head {body.get('head')} "
                "(regressed primary?) — not overwriting"
            )
            return False
        if st == 409 and "head" in body:
            # behind/ahead mismatch: the mirror's head is authoritative
            if int(body["head"]) < m.acked_head:
                self._revoke_acks(m)  # its tail regressed under us
            m.acked_head = int(body["head"])
            m.last_seen = time.monotonic()
            return True
        raise RuntimeError(f"replicate push -> {st}: {body}")

    def _demote(self, hint: Optional[str]) -> None:
        if self.role != "primary":
            return
        self.role = "demoted"
        self.demotions += 1
        self.superseded_by = hint
        self.diverged = True
        self._fail_waiters()
        log_.error(
            "DEMOTED: a higher-epoch primary exists%s; this node now "
            "refuses writes (re-mirror it under the new primary)",
            f" at {hint}" if hint else "",
        )

    # -- mirror side: apply, heartbeat, promotion ---------------------------

    async def handle_replicate(
        self, body: dict, peer_epoch: str, lock: asyncio.Lock
    ) -> web.Response:
        from dss_tpu_torch.region import log_server as ls

        log = self.log
        pg, myg = ls.epoch_gen(peer_epoch), log.epoch_generation
        if self.role != "mirror":
            # another primary is pushing at us.  If it is genuinely
            # newer we were superseded (step down); otherwise IT is
            # the stale one — rejecting makes it step down.
            if pg > myg:
                self._demote(None)
            else:
                self.stale_rejects += 1
            return web.json_response(
                {
                    "error": "stale_epoch",
                    "epoch": log.epoch,
                    "primary": self.advertise_url
                    if self.role == "primary" else self.superseded_by,
                },
                status=409,
            )
        if pg < myg or (pg == myg and peer_epoch != log.epoch):
            # lower generation, or a same-generation different-lineage
            # nonce (e.g. the old primary crash-rotated to the same
            # gen the promotion used): the incumbent adopted epoch
            # wins ties — reject, which demotes the stale primary
            self.stale_rejects += 1
            return web.json_response(
                {"error": "stale_epoch", "epoch": log.epoch}, status=409
            )
        if peer_epoch != log.epoch:
            if log.head > int(body.get("head", 0)):
                # our log extends PAST the pushing primary's: it is a
                # crash-restarted primary whose recovery rotation
                # outranks us but whose log REGRESSED (lost tail) —
                # wiping here would destroy entries that may be the
                # region's only surviving quorum-acked copies.
                # Refuse; the runbook resolves it (promote the
                # max-head mirror, re-mirror the regressed node).
                self.stale_rejects += 1
                log_.error(
                    "refusing epoch %s adoption: its head %s is behind "
                    "ours (%d) — a regressed primary must not wipe "
                    "this mirror (promote the max-head mirror instead)",
                    peer_epoch, body.get("head"), log.head,
                )
                return web.json_response(
                    {
                        "error": "diverged_ahead",
                        "head": log.head,
                        "epoch": log.epoch,
                    },
                    status=409,
                )
            # strictly newer generation, and the sender's log covers
            # ours: our un-acked suffix (if any) has a fork point we
            # cannot prove — drop local state and let the sender
            # stream the authoritative snapshot + tail (the
            # detected-resync contract)
            # read-block THROUGH the resync: between the wipe and the
            # snapshot+tail landing, this log is an empty stub — serving
            # it would read as "the region is empty" and make failing-
            # over instances reset to nothing.  Cleared below once our
            # head covers the head the primary is pushing.
            self.diverged = True
            async with lock:
                log.adopt_epoch(peer_epoch)
                plan = log.reset_empty()
                await ls._durable_rewrite(log, plan)
            log_.warning(
                "mirror reset: adopted primary epoch %s (log wiped, "
                "resyncing from snapshot+tail)", peer_epoch,
            )
        self.primary_head_seen = max(
            self.primary_head_seen, int(body.get("head", 0))
        )
        snap = body.get("snapshot")
        if snap is not None:
            try:
                index = int(snap["index"])
                state = snap["state"]
            except (KeyError, TypeError, ValueError):
                return web.json_response(
                    {"error": "malformed snapshot"}, status=400
                )
            async with lock:
                if index > log.head:
                    plan = log.install_snapshot(index, state)
                elif index > log.snapshot_index:
                    plan = log.put_snapshot(index, state)
                else:
                    plan = None  # stale/duplicate snapshot: ack as noop
                if plan is not None:
                    await ls._durable_rewrite(log, plan)
            if self.diverged and log.head >= int(body.get("head", 0)):
                self.diverged = False  # snapshot alone covered the head
            return web.json_response(
                {
                    "head": log.head,
                    "epoch": log.epoch,
                    "snapshot_index": log.snapshot_index,
                }
            )
        for ent in body.get("entries", []):
            try:
                idx, recs = int(ent[0]), list(ent[1])
                cells = ent[2] if len(ent) > 2 else None
                txn = ent[3] if len(ent) > 3 else None
            except (TypeError, ValueError, IndexError):
                return web.json_response(
                    {"error": "malformed entries"}, status=400
                )
            if log.apply_replicated(idx, recs, cells, txn) is None:
                return web.json_response(
                    {"error": "behind", "head": log.head,
                     "epoch": log.epoch},
                    status=409,
                )
        if self.diverged and log.head >= int(body.get("head", 0)):
            # caught up to the head the primary pushed under the
            # adopted epoch: the log is whole again, reads may resume
            self.diverged = False
        return web.json_response({"head": log.head, "epoch": log.epoch})

    async def _heartbeat_loop(self) -> None:
        while True:
            if (
                self.role == "mirror"
                and self.primary_url
                and self.advertise_url
            ):
                try:
                    st, body = await self._post(
                        self.primary_url + "/mirror/register",
                        {
                            "url": self.advertise_url,
                            "head": self.log.head,
                            "epoch": self.log.epoch,
                        },
                    )
                    if st == 200:
                        self.primary_head_seen = int(
                            body.get("head", self.primary_head_seen)
                        )
                    elif st == 503 and body.get("primary"):
                        # our primary is itself a mirror/demoted now:
                        # follow its hint to the real primary
                        self.repoint(str(body["primary"]))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — primary down is normal
                    log_.debug("mirror heartbeat failed: %r", e)
            await asyncio.sleep(HEARTBEAT_S * (0.75 + random.random() / 2))

    def repoint(self, primary_url: str) -> None:
        """Re-target this mirror at a different primary (the runbook's
        post-promotion step for surviving mirrors — no restart).  Also
        turns a DEMOTED ex-primary back into a mirror; any divergence
        its log holds is detected through the epoch on the next push
        (the new primary's sender resets it)."""
        self.primary_url = primary_url.rstrip("/")
        if self.role != "primary":
            self.role = "mirror"
        log_.info("mirror repointed to %s", self.primary_url)

    async def promote(self) -> dict:
        """Mirror -> primary: bump the persisted epoch generation (the
        fence that supersedes the old primary everywhere) and start
        accepting writes + mirror registrations."""
        self.log.rotate_epoch()
        self.role = "primary"
        self.primary_url = None
        self.superseded_by = None
        # promotion is the operator declaring THIS log the region's
        # truth (min_head is their guard): whatever suffix made it
        # "diverged" is now canon — clear the read block, or a
        # promoted ex-primary would 503 reads forever
        self.diverged = False
        self.promotions += 1
        log_.warning(
            "PROMOTED to primary at head %d, epoch %s",
            self.log.head, self.log.epoch,
        )
        return {
            "role": "primary",
            "epoch": self.log.epoch,
            "head": self.log.head,
        }

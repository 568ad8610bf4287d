"""The region log server: ordered durable batch log + write lease +
state snapshots + quorum-acked replication to mirror processes.

The port of the reference's `dss_tpu/region/log_server.py`: the same
endpoints, bodies and WAL records (through the port's `dar/wal.py`, the
reference's format), so either package's instances and mirrors speak to
either package's server.  It holds no device state.

The CRDB-cluster stand-in for a DSS Region (the upstream DSS's
README.md:22-49).  One asyncio process holds:

  - an append-only log of ENTRIES, persisted through WriteAheadLog so a
    restarted region recovers its full history.  Each entry is one
    writer transaction's whole record batch — shipping the txn boundary
    means tail readers apply a transaction atomically instead of
    record-by-record (the reference gets this from CRDB's atomic txn
    visibility);
  - a single TTL write lease; appends are fenced by the lease token,
    so a paused/partitioned writer whose lease expired cannot corrupt
    the order (the fencing-token pattern);
  - an optional state snapshot uploaded by an instance (the serialized
    store state as of entry index N).  Boot/late-join/resync fetch
    snapshot + tail instead of replaying from 0, and the log compacts
    entries below the snapshot index — bounded recovery, the role
    CRDB's range snapshots + raft log truncation play in the reference
    (implementation_details.md:11-42);
  - optionally, replication: a PRIMARY fans every append out to
    registered MIRROR processes and acks at `quorum` total copies
    (region/mirror.py), so the region survives losing the primary's
    process or disk — the role CRDB's Raft ranges play in the
    reference.  `--mirror_of` runs this process as a mirror: it serves
    reads, refuses writes with 503 not-primary, and can be promoted.

Endpoints (JSON over HTTP — the DCN transport stand-in):
  POST   /lease    {holder, ttl_s}        -> {token} | 409 {holder}
  DELETE /lease    {token}                -> {}
  POST   /append   {token, records}       -> {index} | 409
  GET    /records?from=N&limit=M          -> {entries: [[idx, [rec...]]
                                              ...], head: int}
                                           | 409 {snapshot_required,
                                              snapshot_index} when N
                                              predates compaction
  POST   /snapshot {index, state}         -> {} | 409 (stale index)
  GET    /snapshot                        -> {index, state} | 404
  GET    /healthy                            (JSON: role, head, lag)
  GET    /status                             role/epoch/quorum/mirrors
  GET    /metrics                            Prometheus exposition
  POST   /replicate                          primary->mirror push
  POST   /mirror/register                    mirror->primary heartbeat
  POST   /promote  {min_head?}               mirror -> primary
  POST   /repoint  {primary}                 re-target a mirror

Write endpoints on a mirror (or a demoted ex-primary) answer
`503 {"not_primary": true, "primary": <hint>}` — RegionClient fails
over on it.

Auth: when built with `auth_token`, every endpoint except /healthy and
/metrics requires `Authorization: Bearer <token>`.  The reference
secures inter-node CRDB traffic with node certificates
(implementation_details.md:13-17); a shared region secret is the
transport-agnostic analog — without it the log would be an
unauthenticated write surface into authoritative state.  Replication
peers present the same shared secret.
"""

from __future__ import annotations

import asyncio
import collections
import hmac
import json
import os
import time
from typing import List, Optional

from aiohttp import web

from dss_tpu_torch.dar.wal import FORMAT_RECORD_TYPE, WriteAheadLog

MAX_FETCH = 1000
MAX_LEASE_TTL_S = 60.0
# txn-id dedup window (entries); bounds the memory of retried appends
MAX_TXN_MEMORY = 4096

EPOCH_RECORD_TYPE = "__epoch__"
CLEAN_RECORD_TYPE = "__clean__"


def _new_nonce() -> str:
    import uuid as _uuid

    return _uuid.uuid4().hex[:16]


def epoch_gen(epoch) -> int:
    """Ordered generation prefix of a `"<gen>.<nonce>"` epoch string.
    Legacy bare-nonce epochs (pre-replication servers) order as
    generation 0, so any persisted epoch supersedes them."""
    if not epoch:
        return 0
    head = str(epoch).split(".", 1)[0]
    try:
        return int(head)
    except ValueError:
        return 0


def _epoch_nonce_of(epoch) -> str:
    s = str(epoch or "")
    return s.split(".", 1)[1] if "." in s else s


class RegionLog:
    def __init__(
        self,
        wal_path: Optional[str] = None,
        *,
        fsync: bool = False,
        mirror: bool = False,
        force_rotate: bool = False,
    ):
        # PERSISTED epoch `"<gen>.<nonce>"`, carried on every response.
        # Instances detect a changed epoch and resync to the log's
        # truth — the guard against a log that regressed (lost
        # unsynced acked entries, an operator-restored older WAL, or a
        # failover promotion), where index comparisons alone have
        # false-negative windows once new writes push the head back
        # past a stale reader's cursor.  The epoch lives in the WAL as
        # a record and rotates ONLY on:
        #   - recovery rotation: boot cannot prove the log retained
        #     every acked entry — a torn tail was truncated, or the
        #     previous run did not shut down cleanly (no __clean__
        #     marker at the tail: with fsync off, acked records may
        #     have been lost WITHOUT leaving a tear);
        #   - promotion of a mirror to primary (rotate_epoch()), which
        #     fences the demoted primary everywhere.
        # A CLEAN restart keeps the epoch, so it no longer fences
        # every writer and resyncs the whole fleet.  The flip side:
        # boot cannot detect an operator-restored OLDER backup that
        # was itself shut down cleanly — restores must pass
        # --rotate_epoch (force_rotate) as part of the procedure
        # (docs/OPERATIONS.md).  The generation
        # prefix makes epochs ordered: a mirror adopts a higher-gen
        # primary epoch (and resets to its log), while a lower-or-tied
        # gen from a different lineage is rejected as a stale primary.
        # Mirrors never self-rotate (their log is a copy; the PRIMARY
        # epoch is the authority they adopt), so a crashed mirror
        # can't leapfrog the primary's generation on reboot.
        self._wal = WriteAheadLog(wal_path, fsync=fsync)
        self._base = 0  # index of _entries[0] (entries below are compacted)
        self._entries: List[List[dict]] = []
        # per-entry cell footprint (frozenset of ints) or None
        # (unknown: conflicts with everything) — the serializability
        # basis for optimistic disjoint-cell appends
        self._footprints: List[Optional[frozenset]] = []
        self._etxns: List[Optional[str]] = []  # per-entry txn id
        self._txns: collections.OrderedDict = collections.OrderedDict()
        self._snap_index = 0
        self._snap_state: Optional[dict] = None
        self._epoch_gen = 0
        self._epoch_nonce: Optional[str] = None
        last_type = None
        for rec in self._wal.replay():
            t = rec.get("t")
            last_type = t
            if t == FORMAT_RECORD_TYPE:
                continue  # version gate runs inside replay()
            if t == EPOCH_RECORD_TYPE:
                self._epoch_gen = int(rec.get("gen", 0))
                self._epoch_nonce = str(rec.get("nonce", ""))
                continue
            if t == CLEAN_RECORD_TYPE:
                continue  # shutdown marker, not store state
            if t == "__snapshot__":
                self._snap_index = int(rec["index"])
                self._snap_state = rec["state"]
                self._base = int(rec.get("base", self._snap_index))
                self._entries = []
                self._footprints = []
                self._etxns = []
            elif t == "__entry__":
                self._entries.append(list(rec["recs"]))
                cells = rec.get("cells")
                self._footprints.append(
                    None if cells is None
                    else frozenset(int(c) for c in cells)
                )
                txn = rec.get("txn") or None
                self._etxns.append(txn)
                self._remember_txn(
                    txn, self._base + len(self._entries) - 1
                )
            else:
                # legacy flat record (pre-batch log): singleton entry
                self._entries.append([rec])
                self._footprints.append(None)
                self._etxns.append(None)
        clean_shutdown = last_type == CLEAN_RECORD_TYPE
        # True when THIS boot rotated an existing epoch (recovery /
        # forced restore rotation) — a replicated primary then refuses
        # primacy until an operator confirms it (region/mirror.py)
        self.boot_rotation = False
        had_epoch = self._epoch_nonce is not None
        if mirror:
            # a mirror's epoch is whatever the primary's is; until the
            # first adoption a fresh gen-0 epoch orders BELOW any
            # primary epoch, so the first /replicate push resets it
            if self._epoch_nonce is None:
                self._epoch_gen = 0
                self._epoch_nonce = _new_nonce()
        elif (
            self._epoch_nonce is None
            or force_rotate
            or self._wal.recovered_truncation
            or not clean_shutdown
        ):
            # force_rotate (--rotate_epoch) is the operator's half of
            # the regression guard: a WAL restored from a backup that
            # was SHUT DOWN CLEANLY carries a valid clean marker, so
            # boot alone cannot tell it from the live log — the
            # restore procedure must request the rotation that fences
            # readers of the lost suffix
            self.boot_rotation = had_epoch
            self.rotate_epoch()
        else:
            # boot stamp: re-persist the kept epoch so the previous
            # run's clean marker can never REMAIN the WAL tail across
            # this run's crash — without it, an fsync-off power loss
            # that wipes this run's entire unsynced tail would leave
            # the old marker at the tail and masquerade as a clean
            # shutdown, keeping the epoch over a regressed log
            self._persist_epoch()
        self._lease_holder: Optional[str] = None
        # random per-boot token base: with the epoch now surviving
        # clean restarts, the epoch fence no longer catches an integer
        # lease token colliding across a restart (the counter used to
        # reset to 0 every boot) — random 48-bit seeding makes a
        # cross-boot collision astronomically unlikely instead
        self._lease_token = int.from_bytes(os.urandom(6), "big")
        self._lease_expires = 0.0

    @property
    def epoch(self) -> str:
        return f"{self._epoch_gen}.{self._epoch_nonce}"

    @property
    def epoch_generation(self) -> int:
        return self._epoch_gen

    def rotate_epoch(self) -> str:
        """Bump the persisted epoch generation (recovery rotation or
        mirror promotion).  fsynced regardless of the append fsync
        setting: a promotion that fences the old primary must survive
        a crash of the new one."""
        self._epoch_gen += 1
        self._epoch_nonce = _new_nonce()
        self._persist_epoch()
        return self.epoch

    def adopt_epoch(self, epoch: str) -> bool:
        """Mirror-side: adopt the primary's epoch verbatim (persisted).
        Returns True when it changed."""
        gen, nonce = epoch_gen(epoch), _epoch_nonce_of(epoch)
        if (gen, nonce) == (self._epoch_gen, self._epoch_nonce):
            return False
        self._epoch_gen, self._epoch_nonce = gen, nonce
        self._persist_epoch()
        return True

    def _persist_epoch(self) -> None:
        self._wal.append(
            {
                "t": EPOCH_RECORD_TYPE,
                "gen": self._epoch_gen,
                "nonce": self._epoch_nonce,
            }
        )
        self._wal.sync()

    def _remember_txn(self, txn_id: Optional[str], idx: int) -> None:
        if not txn_id:
            return
        self._txns[txn_id] = idx
        self._txns.move_to_end(txn_id)
        while len(self._txns) > MAX_TXN_MEMORY:
            self._txns.popitem(last=False)

    @property
    def head(self) -> int:
        return self._base + len(self._entries)

    @property
    def base(self) -> int:
        return self._base

    @property
    def snapshot_index(self) -> int:
        return self._snap_index

    @property
    def lease_holder(self) -> Optional[str]:
        """Current holder if the lease is live, else None."""
        if self._lease_holder is None:
            return None
        if time.monotonic() >= self._lease_expires:
            return None
        return self._lease_holder

    def acquire(self, holder: str, ttl_s: float):
        now = time.monotonic()
        if self._lease_holder is not None and now < self._lease_expires:
            if self._lease_holder != holder:
                return None
            # re-acquire by the same holder extends the lease
        self._lease_token += 1
        self._lease_holder = holder
        self._lease_expires = now + ttl_s
        return self._lease_token

    def release(self, token: int) -> bool:
        if token != self._lease_token:
            return False
        self._lease_holder = None
        self._lease_expires = 0.0
        return True

    def append(
        self, token: int, records: List[dict], txn_id: Optional[str] = None
    ) -> Optional[int]:
        """Append one entry (= one txn's batch) -> its entry index, or
        None if the lease token is stale/expired (fenced).  A repeated
        txn_id returns the original index (client transport retries
        must not double-append) — checked BEFORE the fence, since the
        original append may have released the lease."""
        if txn_id and txn_id in self._txns:
            return self._txns[txn_id]
        if (
            token != self._lease_token
            or self._lease_holder is None
            or time.monotonic() >= self._lease_expires
        ):
            return None  # fenced: stale or expired lease
        idx = self.head
        rec = {"t": "__entry__", "recs": records}
        if txn_id:
            rec["txn"] = txn_id
        self._wal.append(rec)
        self._entries.append(list(records))
        self._footprints.append(None)  # lease appends: footprint unknown
        self._etxns.append(txn_id)
        self._remember_txn(txn_id, idx)
        return idx

    def append_optimistic(self, expected_head: int, records: List[dict],
                          cells, txn_id: Optional[str] = None) -> tuple:
        """Lease-free disjoint-cell append (the CRDB per-range write
        analog, the upstream DSS's implementation_details.md:11-42): the
        writer validated against log state at `expected_head` and
        declares the txn's cell footprint; the append lands iff no
        entry since then touches any of those cells (and no lease is
        live — lease holders assume exclusive append).

        -> ("ok", index) | (reason, None) with reason in
        {"lease_held", "behind", "ahead", "conflict"}."""
        if txn_id and txn_id in self._txns:
            return ("ok", self._txns[txn_id])
        if self.lease_holder is not None:
            return ("lease_held", None)
        if expected_head < self._base:
            return ("behind", None)
        if expected_head > self.head:
            return ("ahead", None)
        fp = frozenset(int(c) for c in cells)
        for i in range(expected_head - self._base, len(self._entries)):
            other = self._footprints[i]
            if other is None or (fp & other):
                return ("conflict", None)
        idx = self.head
        rec = {"t": "__entry__", "recs": records, "cells": sorted(fp)}
        if txn_id:
            rec["txn"] = txn_id
        self._wal.append(rec)
        self._entries.append(list(records))
        self._footprints.append(fp)
        self._etxns.append(txn_id)
        self._remember_txn(txn_id, idx)
        return ("ok", idx)

    def apply_replicated(
        self, idx: int, records: List[dict], cells,
        txn_id: Optional[str] = None,
    ) -> Optional[int]:
        """Mirror-side: append an entry pushed by the primary.  Only a
        CONTIGUOUS append (idx == head) lands — gaps mean the mirror is
        behind and must catch up first; idx < head is a duplicate the
        sender re-pushed (acked, not re-applied).  -> new head, or None
        on a gap."""
        if idx < self.head:
            return self.head  # duplicate push: already applied
        if idx != self.head:
            return None  # gap: sender must back up to our head
        rec = {"t": "__entry__", "recs": records}
        fp = None
        if cells is not None:
            fp = frozenset(int(c) for c in cells)
            rec["cells"] = sorted(fp)
        if txn_id:
            rec["txn"] = txn_id
        self._wal.append(rec)
        self._entries.append(list(records))
        self._footprints.append(fp)
        self._etxns.append(txn_id)
        self._remember_txn(txn_id, idx)
        return self.head

    def fetch(self, from_index: int, limit: int = MAX_FETCH):
        """-> list of [entry_index, records] starting at from_index, or
        None if from_index predates compaction (snapshot required)."""
        from_index = max(from_index, 0)  # no Python negative indexing
        if from_index < self._base:
            return None
        lo = from_index - self._base
        hi = min(len(self._entries), lo + limit)
        return [
            [self._base + i, self._entries[i]] for i in range(lo, hi)
        ]

    def fetch_full(self, from_index: int, limit: int = 64):
        """Replication form of fetch: [[idx, records, cells|None,
        txn_id|None], ...], or None when from_index predates
        compaction (the sender must push the snapshot first)."""
        if from_index < self._base:
            return None
        lo = max(from_index, 0) - self._base
        hi = min(len(self._entries), lo + limit)
        out = []
        for i in range(lo, hi):
            fp = self._footprints[i]
            out.append(
                [
                    self._base + i,
                    self._entries[i],
                    None if fp is None else sorted(fp),
                    self._etxns[i],
                ]
            )
        return out

    def rebuild_plan(self) -> dict:
        """Plan a full durable rewrite of the WAL from current
        in-memory state (epoch + snapshot + remaining entries) — used
        by compaction and by mirror snapshot installs/resets.  Run
        begin_compact in a worker thread, then finish_compact back on
        the event-loop thread."""
        head: List[dict] = [
            {
                "t": EPOCH_RECORD_TYPE,
                "gen": self._epoch_gen,
                "nonce": self._epoch_nonce,
            }
        ]
        if self._snap_state is not None:
            head.append(
                {
                    "t": "__snapshot__",
                    "index": self._snap_index,
                    "base": self._base,
                    "state": self._snap_state,
                }
            )
        for e, fp, tx in zip(self._entries, self._footprints, self._etxns):
            rec = {"t": "__entry__", "recs": e}
            if fp is not None:
                rec["cells"] = sorted(fp)
            if tx:
                rec["txn"] = tx
            head.append(rec)
        return {"head_records": head, "n_entries": len(self._entries)}

    def put_snapshot(self, index: int, state: dict):
        """Accept a state snapshot as of entry `index` and compact the
        in-memory entries below it.  Rejects indexes not in
        (snap_index, head] and non-dict state (an irreversible compact
        on a garbage snapshot would brick every future late-join).

        Returns a compaction plan for the durable rewrite (run
        begin_compact in a worker thread, then finish_compact back on
        the event-loop thread), or None if rejected."""
        if not isinstance(state, dict):
            return None
        if index <= self._snap_index or index > self.head:
            return None
        self._snap_index = index
        self._snap_state = state
        drop = index - self._base
        if drop > 0:
            self._entries = self._entries[drop:]
            self._footprints = self._footprints[drop:]
            self._etxns = self._etxns[drop:]
            self._base = index
        return self.rebuild_plan()

    def install_snapshot(self, index: int, state: dict):
        """Mirror-side: adopt the primary's snapshot WHOLESALE when
        behind compaction — local entries (all below the snapshot, or
        discarded by a divergence reset) are dropped and the log
        restarts at `index`.  Returns a rewrite plan, or None on
        malformed/regressive input."""
        if not isinstance(state, dict) or index < self.head:
            return None
        self._snap_index = index
        self._snap_state = state
        self._base = index
        self._entries = []
        self._footprints = []
        self._etxns = []
        return self.rebuild_plan()

    def reset_empty(self) -> dict:
        """Mirror-side divergence reset: drop ALL local log state (a
        higher-generation primary's log is authoritative; ours may
        contain a diverged suffix whose fork point we cannot prove).
        Returns the rewrite plan for the durable wipe."""
        self._base = 0
        self._entries = []
        self._footprints = []
        self._etxns = []
        self._snap_index = 0
        self._snap_state = None
        self._txns.clear()
        return self.rebuild_plan()

    def begin_compact(self, plan) -> Optional[dict]:
        """Phase 1 (worker thread, NO locks): stream the bulk of the
        compacted WAL — epoch + snapshot + entries captured by the
        plan — to a temp file and fsync it.  Appends keep landing in
        the live log meanwhile.  Returns the staging handle."""
        if self._wal.path is None:
            return None
        tmp = f"{self._wal.path}.compact.tmp"
        seq = 0
        fh = open(tmp, "w", encoding="utf-8")
        try:
            from dss_tpu_torch.dar import wal as _walmod

            # the rewrite carries the format version forward
            for rec in [_walmod.format_record()] + plan["head_records"]:
                seq += 1
                fh.write(
                    json.dumps(dict(rec, seq=seq), separators=(",", ":"))
                    + "\n"
                )
            fh.flush()
            os.fsync(fh.fileno())
        except BaseException:
            fh.close()
            os.remove(tmp)
            raise
        return {"tmp": tmp, "fh": fh, "seq": seq, "n": plan["n_entries"]}

    def finish_compact(self, staging: Optional[dict]) -> None:
        """Phase 2 (event-loop thread — the thread that owns ALL
        appends, so nothing can interleave): append the delta entries
        that arrived during phase 1, fsync the small tail, and swap the
        staged file over the live WAL."""
        if staging is None:
            return
        fh, seq = staging["fh"], staging["seq"]
        try:
            for e, fp, tx in zip(
                self._entries[staging["n"]:],
                self._footprints[staging["n"]:],
                self._etxns[staging["n"]:],
            ):
                seq += 1
                rec = {"t": "__entry__", "recs": e, "seq": seq}
                if fp is not None:
                    rec["cells"] = sorted(fp)
                if tx:
                    rec["txn"] = tx
                fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
            fh.close()
            self._wal.adopt(staging["tmp"], seq)
        except BaseException:
            try:
                fh.close()
            except Exception:
                pass
            if os.path.exists(staging["tmp"]):
                os.remove(staging["tmp"])
            raise

    def get_snapshot(self):
        if self._snap_state is None:
            return None
        return self._snap_index, self._snap_state

    def close(self):
        # clean-shutdown marker: its presence at the WAL tail is what
        # lets the next boot KEEP the epoch (nothing can have been
        # lost); a crash never writes it, so recovery rotation fires
        if self._wal.path is not None and self._wal._fh is not None:
            self._wal.append({"t": CLEAN_RECORD_TYPE})
            try:
                self._wal.sync()
            except OSError:
                pass  # marker is best-effort; absence only costs a resync
        self._wal.close()


async def _durable_rewrite(log: RegionLog, plan) -> None:
    """Two-phase durable WAL rewrite: bulk write + fsync in a worker
    thread (the loop keeps serving), small finish on the loop thread
    (which owns all appends, so nothing interleaves with the swap)."""
    staging = await asyncio.get_running_loop().run_in_executor(
        None, log.begin_compact, plan
    )
    log.finish_compact(staging)


def build_region_app(
    wal_path: Optional[str] = None,
    *,
    auth_token: Optional[str] = None,
    fsync: bool = False,
    mirror_of: Optional[str] = None,
    advertise_url: Optional[str] = None,
    quorum: int = 1,
    repl_timeout_s: float = 5.0,
    rotate_epoch: bool = False,
) -> web.Application:
    from dss_tpu_torch.region.mirror import RegionNode

    log = RegionLog(
        wal_path,
        fsync=fsync,
        mirror=bool(mirror_of),
        # mirrors never self-rotate (the primary epoch is adopted, and
        # a restored mirror WAL is reset by the first push anyway)
        force_rotate=rotate_epoch and not mirror_of,
    )
    node = RegionNode(
        log,
        mirror_of=mirror_of,
        advertise_url=advertise_url,
        quorum=quorum,
        repl_timeout_s=repl_timeout_s,
        auth_token=auth_token,
    )
    app = web.Application(client_max_size=256 * 1024 * 1024)
    app["region_log"] = log
    app["region_node"] = node
    # serializes concurrent durable rewrites: snapshot compactions,
    # mirror snapshot installs, divergence resets (appends never
    # block: the swap's finish phase runs on the loop thread, which
    # owns all appends)
    app["snapshot_lock"] = asyncio.Lock()

    from dss_tpu_torch.obs.logging import make_access_log_middleware

    # access log (trace= field included: the propagated X-Request-Id
    # IS the trace id, so grep-by-trace crosses into the region log's
    # process log) — outermost, so auth failures are logged too
    app.middlewares.append(
        make_access_log_middleware(logger_name="dss.region.access")
    )

    @web.middleware
    async def request_id_echo(request, handler):
        """Echo the propagated request/trace id on EVERY response —
        error responses included, which are exactly the ones an
        operator chasing a cross-process trace needs to correlate.
        The log server never MINTS ids: the DSS-instance hop owns the
        trace; an id-less request (curl, probes) stays id-less."""
        rid = request.headers.get("X-Request-Id")
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            if rid:
                e.headers["X-Request-Id"] = rid
            raise
        if rid:
            resp.headers["X-Request-Id"] = rid
        return resp

    app.middlewares.append(request_id_echo)

    @web.middleware
    async def auth_middleware(request, handler):
        if auth_token and request.path not in ("/healthy", "/metrics"):
            got = request.headers.get("Authorization", "")
            if not hmac.compare_digest(got, f"Bearer {auth_token}"):
                return web.json_response(
                    {"error": "missing or invalid region token"}, status=401
                )
        return await handler(request)

    app.middlewares.append(auth_middleware)

    def not_primary() -> web.Response:
        return web.json_response(
            {
                "error": "not primary",
                "not_primary": True,
                "primary": node.primary_hint(),
                "epoch": log.epoch,
            },
            status=503,
        )

    async def healthy(request):
        return web.json_response(
            {
                "status": "ok",
                "role": node.role,
                "head": log.head,
                "epoch": log.epoch,
                "lag_entries": node.lag_entries(),
            }
        )

    async def status(request):
        return web.json_response(node.status())

    async def metrics(request):
        return web.Response(
            text=node.render_metrics(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def lease_acquire(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            holder = str(body.get("holder", ""))
            ttl_s = float(body.get("ttl_s", 10.0))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        if not (0.0 < ttl_s <= MAX_LEASE_TTL_S):
            return web.json_response(
                {"error": f"ttl_s must be in (0, {MAX_LEASE_TTL_S}]"},
                status=400,
            )
        token = log.acquire(holder, ttl_s)
        if token is None:
            return web.json_response(
                {"holder": log.lease_holder}, status=409
            )
        # head rides along so a writer that is already current can skip
        # its catch-up fetch (one fewer round trip per write)
        return web.json_response(
            {"token": token, "head": log.head, "epoch": log.epoch}
        )

    async def lease_release(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            token = int(body.get("token", -1))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        log.release(token)
        return web.json_response({})

    async def append(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            token = int(body.get("token", -1))
            records = list(body.get("records", []))
            release = bool(body.get("release", False))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        client_epoch = body.get("epoch")
        if client_epoch is not None and client_epoch != log.epoch:
            # the lease token was granted by a previous boot/epoch: the
            # writer's validation basis may predate a regression or
            # failover — fence it like a stale token
            return web.json_response(
                {"error": "epoch fenced", "epoch": log.epoch}, status=409
            )
        txn_id = body.get("txn") or None
        idx = log.append(token, records, txn_id)
        if idx is None:
            return web.json_response({"error": "lease fenced"}, status=409)
        if not await node.commit(idx):
            # quorum unreachable: the entry is in OUR log but not on
            # enough mirrors to survive a failover — report it like an
            # ambiguous network failure (client rolls back; the tail
            # re-applies it if this log survives, and a txn-id retry
            # dedups instead of double-appending)
            return web.json_response(
                {
                    "error": "quorum unavailable",
                    "quorum": node.quorum,
                    "epoch": log.epoch,
                },
                status=503,
            )
        if release:
            # piggybacked release saves the writer a round trip; the
            # ack lets a new client detect an old server that ignored
            # the flag (and fall back to an explicit release)
            log.release(token)
        return web.json_response(
            {"index": idx, "released": release, "epoch": log.epoch}
        )

    async def append_optimistic(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            expected_head = int(body.get("expected_head", -1))
            records = list(body.get("records", []))
            cells = [int(c) for c in body.get("cells", [])]
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        if expected_head < 0:
            return web.json_response(
                {"error": "expected_head required"}, status=400
            )
        client_epoch = body.get("epoch")
        if client_epoch is not None and client_epoch != log.epoch:
            # the writer validated against a previous epoch's log,
            # whose history below expected_head may differ from ours:
            # refuse BEFORE anything lands; the lease-path retry's
            # epoch check forces the writer to resync + revalidate
            return web.json_response(
                {"error": "epoch", "reason": "epoch", "head": log.head,
                 "epoch": log.epoch},
                status=409,
            )
        txn_id = body.get("txn") or None
        status_, idx = log.append_optimistic(
            expected_head, records, cells, txn_id
        )
        if status_ != "ok":
            return web.json_response(
                {"error": status_, "reason": status_, "head": log.head},
                status=409,
            )
        if not await node.commit(idx):
            return web.json_response(
                {
                    "error": "quorum unavailable",
                    "quorum": node.quorum,
                    "epoch": log.epoch,
                },
                status=503,
            )
        return web.json_response({"index": idx, "epoch": log.epoch})

    async def records(request):
        if node.role == "demoted" or node.diverged:
            # a demoted ex-primary may hold a DIVERGED suffix: serving
            # it as reads would feed clients history the region lost.
            # Mirrors serve reads; a demoted node serves nothing until
            # the new primary's push resets its log (the `diverged`
            # flag outlives a repoint back to mirror for that reason).
            return not_primary()
        try:
            frm = int(request.query.get("from", 0))
            limit = min(int(request.query.get("limit", MAX_FETCH)), MAX_FETCH)
        except ValueError:
            return web.json_response(
                {"error": "malformed from/limit"}, status=400
            )
        entries = log.fetch(frm, limit)
        if entries is None:
            return web.json_response(
                {
                    "snapshot_required": True,
                    "snapshot_index": log.snapshot_index,
                    "epoch": log.epoch,
                },
                status=409,
            )
        return web.json_response(
            {"entries": entries, "head": log.head, "epoch": log.epoch}
        )

    async def snapshot_put(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            index = int(body["index"])
            state = body["state"]
        except (ValueError, TypeError, KeyError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        client_epoch = body.get("epoch")
        if client_epoch is not None and client_epoch != log.epoch:
            # a stale-epoch instance's state may contain entries this
            # (reborn) log lost: accepting it as the authoritative
            # snapshot would compact the CORRECT entries away and
            # poison every future resync/late-join
            return web.json_response(
                {"error": "epoch", "epoch": log.epoch}, status=409
            )
        async with app["snapshot_lock"]:
            plan = log.put_snapshot(index, state)
            if plan is None:
                return web.json_response(
                    {"error": "stale, out-of-range, or malformed snapshot"},
                    status=409,
                )
            await _durable_rewrite(log, plan)
        node.notify_snapshot()  # mirrors compact too (best-effort)
        return web.json_response({})

    async def snapshot_get(request):
        if node.role == "demoted" or node.diverged:
            return not_primary()
        snap = log.get_snapshot()
        if snap is None:
            return web.json_response({"error": "no snapshot"}, status=404)
        index, state = snap
        return web.json_response({"index": index, "state": state})

    # -- replication seam (region/mirror.py drives these) ------------------

    async def replicate(request):
        try:
            body = await request.json()
            peer_epoch = str(body.get("epoch", ""))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        return await node.handle_replicate(
            body, peer_epoch, app["snapshot_lock"]
        )

    async def mirror_register(request):
        if node.role != "primary":
            return not_primary()
        try:
            body = await request.json()
            url = str(body.get("url") or "")
            head = int(body.get("head", 0))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        if not url:
            return web.json_response({"error": "url required"}, status=400)
        node.register_mirror(url, head, str(body.get("epoch", "")))
        return web.json_response(
            {"epoch": log.epoch, "head": log.head, "quorum": node.quorum}
        )

    async def promote(request):
        try:
            body = await request.json()
        except (ValueError, TypeError, AttributeError):
            body = {}
        if node.role == "primary":
            return web.json_response(
                {"already_primary": True, "epoch": log.epoch,
                 "head": log.head}
            )
        min_head = body.get("min_head")
        if min_head is not None and log.head < int(min_head):
            return web.json_response(
                {
                    "error": "behind min_head",
                    "head": log.head,
                    "min_head": int(min_head),
                },
                status=409,
            )
        # under the rewrite lock: an in-flight compaction/install swaps
        # a WAL built from a pre-promotion plan over the live file,
        # which would silently drop the fsynced epoch record — the one
        # write whose loss un-fences the demoted primary
        async with app["snapshot_lock"]:
            out = await node.promote()
        return web.json_response(out)

    async def repoint(request):
        try:
            body = await request.json()
            primary = str(body.get("primary", ""))
        except (ValueError, TypeError, AttributeError):
            return web.json_response({"error": "malformed body"}, status=400)
        if node.role == "primary":
            return web.json_response(
                {"error": "primary cannot be repointed (demote it by "
                 "promoting a mirror, then restart it with --mirror_of)"},
                status=409,
            )
        if not primary:
            return web.json_response({"error": "primary required"}, status=400)
        node.repoint(primary)
        return web.json_response({"primary": primary, "role": node.role})

    async def on_startup(app):
        await node.start()

    async def on_cleanup(app):
        await node.stop()
        log.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    app.router.add_get("/healthy", healthy)
    app.router.add_get("/status", status)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/lease", lease_acquire)
    app.router.add_delete("/lease", lease_release)
    app.router.add_post("/append", append)
    app.router.add_post("/append_optimistic", append_optimistic)
    app.router.add_get("/records", records)
    app.router.add_post("/snapshot", snapshot_put)
    app.router.add_get("/snapshot", snapshot_get)
    app.router.add_post("/replicate", replicate)
    app.router.add_post("/mirror/register", mirror_register)
    app.router.add_post("/promote", promote)
    app.router.add_post("/repoint", repoint)
    return app

"""Synchronous client for the region log server (DSS-instance side).

The port of the reference's `dss_tpu/region/client.py`, on the standard
library's `http.client` (the reference rides `requests.Session`): every
thread keeps its own keep-alive connection to each endpoint, since the
tail poller and the writers call the client at once and an
`http.client` connection is not thread-safe.  A connection error, a
timeout or a malformed HTTP exchange takes exactly the paths the
reference takes for `requests.RequestException`.

Accepts one URL or a list (comma-separated string or list/tuple) —
the primary plus its mirrors.  Every request gets bounded, jittered
transport retry with endpoint failover: connection errors, 5xx, and
`503 not-primary` answers rotate to the next endpoint (following the
server's `primary` hint when it names a configured endpoint), so a
mirror hiccup or a failover in progress surfaces as a short stall
instead of an immediate error.  Appends carry a per-call txn id the
server dedups on, which is what makes retrying them safe (a retry of an
append that actually landed returns the original index instead of
double-appending).

Backoff rides the stack-wide shared policy (chaos/retry.py) and every
endpoint carries a circuit breaker: consecutive transport failures open
it (dss_breaker_state{remote} in /metrics), rotation prefers endpoints
whose breaker allows traffic, and all-breakers-open flips the store's
degradation ladder to REGION_LOG_DOWN — writes then shed 503 with the
breaker cooldown as an honest Retry-After while reads keep serving.
The breaker never hard-blocks the only available endpoint: on a
single-URL client an open breaker just means every attempt is a
half-open probe."""

from __future__ import annotations

import http.client
import json
import os
import ssl
import threading
import time
import urllib.parse
import uuid
import weakref
from typing import List, Optional, Tuple

from dss_tpu_torch import chaos
from dss_tpu_torch.obs import trace


class RegionError(RuntimeError):
    """Region log unreachable, lease unavailable, or append fenced."""


class OptimisticRejected(Exception):
    """The server definitively refused an optimistic append (cell
    conflict, live lease, or compacted history) — nothing was logged."""


class EpochChanged(RegionError):
    """The region log server's epoch changed since this client last
    saw it: the log may have regressed (a crash lost unsynced acked
    entries, or an operator restored an older WAL and — as the restore
    procedure requires — booted it with --rotate_epoch) or a mirror
    was promoted to primary, so locally-applied state can no longer be
    trusted as a prefix of the log.  Handlers must resync from the log's
    truth (adopt_epoch() + snapshot + tail); broad RegionError handlers
    that merely retry keep seeing this raised until someone adopts the
    new epoch."""


class SnapshotRequired(RegionError):
    """The requested log range was compacted away; fetch the snapshot
    and resume from its index."""


class TransportError(OSError):
    """One HTTP exchange failed below the status line: refused, reset,
    timed out, or not HTTP.  The reference's `requests.RequestException`."""


class Response:
    """A whole HTTP response: its status and body."""

    def __init__(self, status: int, body: bytes):
        self.status_code = status
        self.content = body

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        """The body as JSON; ValueError when it is not JSON."""
        return json.loads(self.content.decode("utf-8"))


class _Transport:
    """Keep-alive HTTP(S) connections, one per (thread, endpoint).

    A connection that fails is closed and dropped; a request on a
    reused keep-alive connection that the server had already closed
    (reset, or closed before the status line) is sent once more on a
    fresh one, as urllib3's pool does for a dropped connection."""

    def __init__(self, headers: dict):
        self._headers = dict(headers)
        self._local = threading.local()
        self._all = weakref.WeakSet()
        self._mu = threading.Lock()

    def _conns(self) -> dict:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        return conns

    def _open(self, scheme: str, netloc: str, timeout: float):
        if scheme == "https":
            conn = http.client.HTTPSConnection(
                netloc, timeout=timeout,
                context=ssl.create_default_context(),
            )
        elif scheme == "http":
            conn = http.client.HTTPConnection(netloc, timeout=timeout)
        else:
            raise TransportError(f"unsupported URL scheme {scheme!r}")
        with self._mu:
            self._all.add(conn)
        return conn

    def request(self, method: str, url: str, *, timeout: float,
                params=None, json=None, data=None, headers=None):
        parts = urllib.parse.urlsplit(url)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        if params:
            path += ("&" if parts.query else "?") + urllib.parse.urlencode(
                params)
        hdrs = dict(self._headers)
        if json is not None:
            import json as _json

            data = _json.dumps(json).encode()
            hdrs["Content-Type"] = "application/json"
        if headers:
            hdrs.update(headers)
        key = (parts.scheme, parts.netloc)
        conns = self._conns()
        conn = conns.get(key)
        while True:
            reused = conn is not None
            if not reused:
                conn = conns[key] = self._open(parts.scheme, parts.netloc,
                                               timeout)
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                conn.request(method, path, body=data, headers=hdrs)
                resp = conn.getresponse()
                body = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                conns.pop(key, None)
                if reused and isinstance(e, (http.client.RemoteDisconnected,
                                             BrokenPipeError,
                                             ConnectionResetError)):
                    conn = None
                    continue  # the server dropped an idle connection
                raise TransportError(f"{type(e).__name__}: {e}") from e
            if resp.will_close:
                conn.close()
                conns.pop(key, None)
            return Response(resp.status, body)

    def close(self) -> None:
        """Close every connection of every thread."""
        with self._mu:
            conns = list(self._all)
        for conn in conns:
            conn.close()


class RegionClient:
    def __init__(
        self,
        base_url,
        instance_id: Optional[str] = None,
        *,
        auth_token: Optional[str] = None,
        lease_ttl_s: float = 10.0,
        acquire_timeout_s: float = 10.0,
        http_timeout_s: float = 5.0,
        retry_deadline_s: float = 3.0,
        max_retries: int = 4,
        health=None,  # chaos.DegradationLadder: region_log_down signal
    ):
        if isinstance(base_url, (list, tuple)):
            urls = [str(u) for u in base_url]
        else:
            urls = str(base_url).split(",")
        self._urls = [u.strip().rstrip("/") for u in urls if u.strip()]
        if not self._urls:
            raise ValueError("RegionClient needs at least one URL")
        self._active = 0
        self.instance_id = instance_id or f"dss-{uuid.uuid4()}"
        self.lease_ttl_s = lease_ttl_s
        self.acquire_timeout_s = acquire_timeout_s
        self._timeout = http_timeout_s
        self._retry_deadline_s = retry_deadline_s
        self._max_retries = max_retries
        self._session = _Transport(
            {"Authorization": f"Bearer {auth_token}"} if auth_token else {}
        )
        # failover/retry observability (coordinator.stats -> /metrics)
        self.failovers = 0
        self.transport_retries = 0
        # the shared stack-wide backoff policy
        self._retry_policy = chaos.RetryPolicy(
            base_s=0.05, cap_s=0.5, multiplier=2.0, jitter=0.5
        )
        # per-endpoint circuit breakers: rotation prefers allowed
        # endpoints; all-open drives the degradation ladder
        self._breakers = chaos.BreakerRegistry(
            fail_threshold=3, reset_s=2.0
        )
        self._health = health
        # last ADOPTED server epoch vs last SEEN on the wire:
        # a mismatch raises EpochChanged until a resync site adopts
        self._epoch: Optional[str] = None
        self._seen_epoch: Optional[str] = None
        # current_epoch() probe memo: when the epoch is still unknown
        # (pre-bootstrap, or a client built only for fence consults),
        # at most one cheap single-attempt probe per validity window —
        # and none at all while the endpoint's breaker is open, so a
        # read-cache fence consult during a region-log outage fails
        # fast instead of stalling behind the transport retry ladder
        self._epoch_probe_at = float("-inf")
        self._epoch_probe_validity_s = float(
            os.environ.get("DSS_REGION_EPOCH_VALID_S", 0.5)
        )

    @property
    def base(self) -> str:
        """The endpoint requests currently target (moves on failover)."""
        return self._urls[self._active]

    @property
    def endpoints(self) -> List[str]:
        return list(self._urls)

    def close(self) -> None:
        """Close the keep-alive connections of every thread."""
        self._session.close()

    # -- transport: bounded jittered retry + endpoint failover --------------

    def _next_endpoint(self, hint: Optional[str], tried: set) -> None:
        """Move to the server-hinted primary when it is fresh, else the
        next endpoint not yet tried during this call — preferring
        endpoints whose circuit breaker allows traffic (an open
        breaker only deprioritizes: if every untried endpoint is open,
        the first one still gets the probe).  Hints outside
        the CONFIGURED list are ignored: a mirror left on its default
        loopback --advertise_url would otherwise permanently poison
        the rotation with a URL that is local to the wrong host."""
        if hint:
            hint = str(hint).rstrip("/")
            if hint in self._urls and hint not in tried:
                self._active = self._urls.index(hint)
                return
        n = len(self._urls)
        fallback = None
        for k in range(1, n + 1):
            cand = (self._active + k) % n
            if self._urls[cand] in tried:
                continue
            if self._breakers.get(self._urls[cand]).allow():
                self._active = cand
                return
            if fallback is None:
                fallback = cand
        self._active = (
            fallback if fallback is not None else (self._active + 1) % n
        )

    def _request(self, method: str, path: str, *, timeout=None, **kw):
        """One HTTP call; retries transport failures (connection
        errors, any 5xx, 503 not-primary) with jittered backoff and
        endpoint rotation, bounded by max_retries AND a wall-clock
        deadline (which never cuts off an endpoint's FIRST attempt —
        a hung primary must not spend the budget mirrors need).
        Returns any response with status < 500 — semantic
        statuses (200/401/404/409) are the caller's business.  Raises
        RegionError once the retry budget is spent."""
        deadline = time.monotonic() + self._retry_deadline_s
        attempts = max(self._max_retries, len(self._urls))
        tried: set = set()
        last = "unreachable"
        # propagate the caller's trace across the region hop (ONE id
        # end to end; the log server echoes it on every response,
        # errors included) and time the hop as a span
        tp = trace.propagation_headers()
        if tp:
            kw = dict(kw)
            hdrs = dict(kw.get("headers") or {})
            hdrs.update(tp)
            kw["headers"] = hdrs
        for attempt in range(attempts + 1):
            url = self._urls[self._active]
            hint = None
            try:
                # chaos seam: an injected error/partition here reads
                # exactly like a connection failure (retried, failed
                # over, breaker-counted); a delay models a slow link
                chaos.fault_point("region.client.request", detail=url)
                with trace.span("region.request", path=path):
                    r = self._session.request(
                        method, url + path,
                        timeout=timeout or self._timeout,
                        **kw,
                    )
            except (TransportError, chaos.FaultError) as e:
                last = f"{url}: {e}"
                r = None
            if r is not None:
                if r.status_code < 500:
                    self._breakers.get(url).record_success()
                    self._note_region_ok()
                    return r
                body = self._json(r)
                hint = body.get("primary")
                last = (
                    f"{url}: {r.status_code} "
                    f"{body.get('error', '')}".strip()
                )
            self._breakers.get(url).record_failure()
            if attempt >= attempts:
                break
            tried.add(url)
            if time.monotonic() >= deadline and len(tried) >= len(
                self._urls
            ):
                # the wall clock bounds RETRIES, not first attempts: a
                # hung (partitioned, not refusing) primary eats a full
                # http timeout, which can exceed the whole deadline —
                # every configured endpoint still gets one shot before
                # giving up, or multi-URL failover would never fire on
                # exactly the failure it exists for
                break
            before = self._active
            self._next_endpoint(hint, tried)
            self.transport_retries += 1
            if self._active != before:
                self.failovers += 1
            time.sleep(self._retry_policy.backoff_s(attempt))
        self._note_region_down(last)
        raise RegionError(f"region log {method} {path} failed: {last}")

    def _note_region_down(self, reason: str) -> None:
        """The whole retry budget burned without an answer: flip the
        degradation ladder once every endpoint's breaker is open (a
        single slow call must not page the region as down)."""
        if self._health is not None and self._breakers.all_open():
            self._health.enter(
                "region_log_down", f"region log unreachable: {reason}"
            )

    def _note_region_ok(self) -> None:
        if self._health is not None:
            self._health.exit("region_log_down")

    def set_health(self, ladder) -> None:
        """Attach the store's degradation ladder (dss_store wiring)."""
        self._health = ladder

    def breaker_states(self) -> dict:
        """endpoint -> 0 closed / 1 half-open / 2 open — the
        dss_breaker_state{remote} gauge family."""
        return self._breakers.states()

    def retry_after_s(self) -> float:
        """Honest Retry-After for writes shed during a region outage:
        the soonest any endpoint's breaker allows a probe (floor 0.5 s
        so clients cannot busy-poll a flapping link)."""
        return max(0.5, self._breakers.min_cooldown_s(default=1.0))

    def _check_epoch(self, body: dict) -> None:
        """Raise EpochChanged when the server's epoch moved off the
        adopted one.  Pre-epoch servers (no field) are tolerated —
        the mixed-version stance this client takes elsewhere."""
        ep = body.get("epoch")
        if ep is None:
            return
        self._seen_epoch = str(ep)
        if self._epoch is None:
            self._epoch = self._seen_epoch
        elif self._seen_epoch != self._epoch:
            raise EpochChanged(
                f"region log epoch changed ({self._epoch[:8]} -> "
                f"{self._seen_epoch[:8]}): log may have regressed"
            )

    def adopt_epoch(self) -> None:
        """Accept the latest seen epoch — call when (re)building local
        state from the log's current truth (resync/reset)."""
        if self._seen_epoch is not None:
            self._epoch = self._seen_epoch

    def current_epoch(self) -> str:
        """The epoch this client's local state is built against — the
        region component of the read cache's version fence: entries
        stamped under an older epoch (a promotion, a restored-backup
        rotation) can never be served after the flip.

        Known epoch -> pure local read (the hot path: every cache
        fence consult lands here).  Unknown epoch -> one memoized,
        breaker-gated, single-attempt /status probe per
        DSS_REGION_EPOCH_VALID_S window: entries stamped under the
        placeholder "" epoch would all be invalidated the moment the
        real epoch is adopted, so learning it early is worth ONE cheap
        probe — but never a retry ladder, and never any network at all
        while the breaker is open (a region outage must not stall the
        read path that exists to keep serving through it)."""
        if self._epoch is not None:
            return self._epoch
        now = time.monotonic()
        if now - self._epoch_probe_at < self._epoch_probe_validity_s:
            return ""
        self._epoch_probe_at = now
        url = self._urls[self._active]
        breaker = self._breakers.get(url)
        if not breaker.allow():
            return ""  # fail fast: the open breaker IS the answer
        try:
            chaos.fault_point("region.client.request", detail=url)
            r = self._session.request(
                "GET", url + "/status",
                timeout=min(self._timeout, 1.0),
            )
        except (TransportError, chaos.FaultError):
            breaker.record_failure()
            return ""
        if r.status_code >= 500:
            breaker.record_failure()
            return ""
        breaker.record_success()
        ep = self._json(r).get("epoch")
        if ep is not None:
            # first-seen adopts, exactly as _check_epoch would
            self._seen_epoch = str(ep)
            self._epoch = self._seen_epoch
        return self._epoch or ""

    @staticmethod
    def _json(r) -> dict:
        """Parse a response body, tolerating non-JSON error pages."""
        try:
            body = r.json()
        except ValueError:
            return {}
        return body if isinstance(body, dict) else {}

    @staticmethod
    def _field(body: dict, key: str, caster, what: str):
        """Extract+cast a required response field; any malformed server
        response surfaces as RegionError (-> 503 UNAVAILABLE), never as
        a bare KeyError/TypeError escaping as an internal 500."""
        try:
            return caster(body[key])
        except (KeyError, TypeError, ValueError) as e:
            raise RegionError(
                f"malformed region response ({what}): {e!r}"
            ) from e

    def acquire_lease(self) -> Tuple[int, Optional[int]]:
        """Blocking acquire with backoff; -> (fencing token, log head
        as of the grant — None from a pre-head server)."""
        deadline = time.monotonic() + self.acquire_timeout_s
        delay = 0.005
        while True:
            r = self._request(
                "POST", "/lease",
                json={
                    "holder": self.instance_id,
                    "ttl_s": self.lease_ttl_s,
                },
            )
            if r.status_code == 200:
                body = self._json(r)
                token = self._field(body, "token", int, "lease")
                try:
                    self._check_epoch(body)
                except EpochChanged:
                    # the grant is live on the server: release it so a
                    # failed post-epoch resync can't stall all writers
                    # for the lease TTL
                    self.release_lease(token)
                    raise
                head = body.get("head")
                return (
                    token,
                    None if head is None else int(head),
                )
            if r.status_code == 401:
                raise RegionError("region auth rejected (bad token)")
            if time.monotonic() >= deadline:
                raise RegionError(
                    f"region write lease unavailable "
                    f"(held by {self._json(r).get('holder')})"
                )
            time.sleep(delay)
            delay = min(delay * 2, 0.25)

    def release_lease(self, token: int) -> None:
        try:
            self._request("DELETE", "/lease", json={"token": token})
        except RegionError:
            pass  # lease expires on its own TTL

    def append(
        self, token: int, records: List[dict], *, release: bool = False
    ) -> int:
        """Append one entry (this txn's whole batch) -> its entry
        index.  release=True drops the lease in the same round trip.
        Raises RegionError if the lease was fenced (caller must
        converge via rollback + tail)."""
        r = self._request(
            "POST", "/append",
            json={
                "token": token,
                "records": records,
                "release": release,
                # epoch the lease was granted under: a reborn
                # server resets its lease counter, so an integer
                # token can collide across epochs — the server
                # refuses a mismatched epoch before anything lands
                "epoch": self._epoch,
                # idempotency key: a transport retry of an append
                # that landed returns the original index
                "txn": uuid.uuid4().hex,
            },
        )
        if r.status_code != 200:
            raise RegionError(f"region append fenced: {r.text}")
        body = self._json(r)
        if "index" not in body and "from_index" in body:
            # older server speaks 'from_index'; same mixed-version
            # tolerance as the 'released' shim below — without it a
            # committed append would be rolled back and 503'd
            body = dict(body, index=body["from_index"])
        idx = self._field(body, "index", int, "append")
        if release and not body.get("released"):
            # older server ignored the piggyback flag: release
            # explicitly so the lease doesn't leak for its full TTL
            self.release_lease(token)
        return idx

    def append_optimistic(
        self, expected_head: int, records: List[dict], cells
    ) -> int:
        """Lease-free disjoint-cell append -> entry index.  Raises
        OptimisticRejected when the server turns it down (conflict /
        lease held / behind compaction) — the caller rolls back and
        retries via the lease path; RegionError on network failures
        (the txn id lets the transport layer retry those safely)."""
        r = self._request(
            "POST", "/append_optimistic",
            json={
                "expected_head": expected_head,
                "records": records,
                "cells": sorted(int(c) for c in cells),
                # the epoch our validation basis came from: a
                # reborn (possibly regressed) log must refuse the
                # append outright — its history may differ below
                # expected_head, so the footprint check alone is
                # not a sound basis across epochs
                "epoch": self._epoch,
                "txn": uuid.uuid4().hex,
            },
        )
        if r.status_code == 409:
            body = self._json(r)
            raise OptimisticRejected(
                str(body.get("reason", "conflict"))
            )
        if r.status_code != 200:
            raise RegionError(
                f"optimistic append rejected: {r.status_code} {r.text}"
            )
        body = self._json(r)
        self._check_epoch(body)
        return self._field(body, "index", int, "append_optimistic")

    def fetch(
        self, from_index: int
    ) -> Tuple[List[Tuple[int, List[dict]]], int]:
        """-> ([(entry_index, [record, ...]), ...], head).  Raises
        SnapshotRequired when from_index predates log compaction."""
        r = self._request(
            "GET", "/records", params={"from": from_index}
        )
        body = self._json(r)
        self._check_epoch(body)
        if r.status_code == 409 and body.get("snapshot_required"):
            raise SnapshotRequired(
                f"log compacted up to {body.get('snapshot_index')}"
            )
        if r.status_code != 200:
            raise RegionError(f"region fetch failed: {r.status_code}")
        entries = self._field(body, "entries", list, "fetch")
        head = self._field(body, "head", int, "fetch")
        try:
            return (
                [(int(i), list(recs)) for i, recs in entries],
                head,
            )
        except (TypeError, ValueError) as e:
            raise RegionError(
                f"malformed region response (fetch entries): {e!r}"
            ) from e

    def get_snapshot(self) -> Optional[Tuple[int, dict]]:
        """-> (entry_index, state) of the latest snapshot, or None."""
        r = self._request("GET", "/snapshot")
        if r.status_code == 404:
            return None
        if r.status_code != 200:
            raise RegionError(
                f"region snapshot fetch failed: {r.status_code}"
            )
        body = self._json(r)
        return (
            self._field(body, "index", int, "snapshot"),
            self._field(body, "state", dict, "snapshot"),
        )

    def put_snapshot(
        self, index: int, state: dict = None, *, state_json: str = None
    ) -> bool:
        """Upload a state snapshot as of entry `index`.  False if the
        server rejected it as stale (another instance got there first).
        Pass state_json (pre-serialized) to avoid a second large JSON
        dump when the caller already serialized for size accounting."""
        ep = json.dumps(self._epoch)  # None -> null (pre-epoch servers)
        if state_json is not None:
            body = (
                '{"index":%d,"epoch":%s,"state":%s}'
                % (index, ep, state_json)
            ).encode()
        else:
            body = json.dumps(
                {"index": index, "epoch": self._epoch, "state": state},
                separators=(",", ":"),
            ).encode()
        r = self._request(
            "POST", "/snapshot",
            data=body,
            headers={"Content-Type": "application/json"},
            timeout=max(self._timeout, 30.0),
        )
        return r.status_code == 200

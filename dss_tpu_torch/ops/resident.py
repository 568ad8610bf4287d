"""Resident serving route: captured B1 calls and a persistent feeder loop.

The port of the reference's `dss_tpu/ops/resident.py`.  The fused query
path (ops/fastpath.py) pays per-call costs that have nothing to do with
the query itself: the wrapper's checks and allocations, the uploads of
the window list and query bounds, the launch, the pinned output
buffer.  This module cuts them with three parts:

  CAPTURED SHAPE BUCKETS (GraphCache / ResidentKernel) — at warm time
  (server boot, fold, or the first miss of a bucket) one B1 call is
  captured into a CUDA graph for each pow2 (window bucket, batch
  bucket) the serving path hits (ops/fastpath.py pow2_bucket): one
  host-to-device copy of the pinned window list and query bounds, the
  kernel, and one device-to-host copy of its flat output into pinned
  memory.  A replay is one graph launch.  The reference keys its
  executables by block count, because its columns are arguments; a
  graph bakes in the columns' device pointers, so an entry here belongs
  to one FastTable: the key is (table identity, window bucket, batch
  bucket, max_words).  An entry keeps the table's columns alive and
  is dropped when the table is (a fold replaced it), or by the LRU
  bound, so its memory goes back.

  STATIC BUFFERS — each entry owns `instances` replay units, each with
  its own pinned inputs, device inputs, output, pinned output copy and
  B1 scratch (the kernel's tile counter, epoch and statuses; the epoch
  advances on the device, so replays need no re-zeroing).  A unit is
  busy from its replay until collect() has decoded its pinned output,
  so results are never aliased; a hit on an entry whose units are all
  busy launches B1 eagerly instead and is counted (`busy`), and no one
  ever waits for a unit.

  THE RESIDENT LOOP (ResidentLoop) — a feeder thread owning a bounded
  host ring that the coalescer's pack stage enqueues drained batches
  into.  The feeder submits batch after batch onto the loop's own CUDA
  stream WITHOUT waiting for results (up to `max_inflight`
  outstanding), and a collector thread resolves them in order, so
  consecutive batches never serialize on a full round trip.

Capture runs on a background thread (compile_async) while other threads
serve, so it uses the thread-local capture mode: another thread's
allocation, event wait or cold-route launch is no capture error.  Every
buffer a graph touches, the scratch included, exists before the capture
begins, and one eager launch on the capture stream comes first.  An
entry allocates all its units' pinned and device buffers first, and
units are allocated and captured only under one cache-wide lock, so no
replay unit's pinned allocation ever overlaps a capture.  The units'
pinned buffers are registered host memory, outside PyTorch's caching
host allocator (see locked_host), and every capture runs on one
high-priority stream of the cache's, never a resident loop's stream.  A capture
that fails anyway is counted (`capture_failures`,
co_res_graph_capture_failures); its bucket launches B1 eagerly.

A grid warm (boot, fold, device recovery) reserves its keys: the LRU
bound never evicts a reserved entry, and it grows to the reserved count
plus MISS_HEADROOM entries (at most DSS_RES_AOT_CAP) for miss-driven
builds.  A table's reservations go with it when it dies.  The
reference's executables are shared between tables of equal block
count, so its grid for one store can be smaller; the port's is one per
table (`reference_grid_entries` counts the reference's for the same
tables).

On the CPU a GraphCache entry holds the same static buffers and
captures nothing: a replay runs the plain version into them.  Only a
caller that asks for the CPU reaches that path; on the card a replay
is a graph launch, and a miss or a busy entry an eager kernel launch.

The loop plugs into the deadline router (dar/coalesce.py) as a third
route candidate with its own cost-model key (`est_res_floor_ms`).
"""

from __future__ import annotations

import gc
import itertools
import os
import queue as _queue
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dss_tpu_torch.chaos import fault_point
from dss_tpu_torch.ops import fused_filter as ff


def _env_buckets(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return tuple(
        sorted({int(x) for x in raw.split(",") if x.strip()})
    )


def batch_bucket_grid() -> Tuple[int, ...]:
    """Default batch-axis buckets to warm (DSS_RES_BATCH_BUCKETS): the
    coalescer's drain sizes land in pow2 buckets >= 16; the grid covers
    the post-host-cutoff sizes the device routes actually see.  Unwarmed
    buckets are not wrong — they launch B1 eagerly and show up in the
    miss counters, which is how operators size this grid."""
    return _env_buckets("DSS_RES_BATCH_BUCKETS", (128, 512, 2048, 4096))


def window_bucket_grid() -> Tuple[int, ...]:
    """Default window-axis buckets to warm (DSS_RES_WINDOW_BUCKETS).
    Window counts scale with batch x covering width x postings-run
    spread; the pow2 rule is pow2_bucket (ops/fastpath.py)."""
    return _env_buckets(
        "DSS_RES_WINDOW_BUCKETS", (256, 1024, 4096, 16384, 65536)
    )


# LRU room for miss-driven entries beside the reserved warm grids
MISS_HEADROOM = 32


def reference_grid_entries(tables) -> int:
    """The entries the reference's AotCache would build to warm the
    default grid for these FastTables: one per (block count, window
    bucket, batch bucket), where the port builds one per table."""
    return (len({int(ft.n_blocks) for ft in tables})
            * len(batch_bucket_grid()) * len(window_bucket_grid()))


def max_words_for(window_bucket: int) -> int:
    """submit() auto-sizes the compacted-hit-word buffer to
    pow2_bucket(nw, lo=2^16); for every window bucket <= 2^16 that is
    the constant 2^16, above it the bucket itself."""
    return max(1 << 16, int(window_bucket))


def locked_host(nbytes: int) -> torch.Tensor:
    """Zeroed host memory page-locked with cudaHostRegister, as a uint8
    tensor, outside PyTorch's caching host allocator.  That allocator,
    when a pinned block is freed, records an event on every stream the
    block was copied on, and queries such events at later pinned
    allocations.  A freed replay unit's capture stream may be capturing
    on another thread by then: the event joins that capture, and the
    next pinned allocation anywhere fails querying it ("invalid
    argument").  Registered memory takes no part in that bookkeeping.
    It is unregistered when the buffer is garbage."""
    page = 4096
    raw = np.zeros(nbytes + page, np.uint8)
    off = (-raw.ctypes.data) % page
    buf = raw[off:off + nbytes]
    ptr = buf.ctypes.data
    rt = torch.cuda.cudart()
    torch.cuda.check_error(rt.cudaHostRegister(ptr, nbytes, 0))
    weakref.finalize(raw, rt.cudaHostUnregister, ptr)
    return torch.from_numpy(buf)


class _Instance:
    """One replay unit of a GraphCache entry: pinned inputs (window
    list, then the four query-bound vectors, in one buffer), their
    device twin, B1's output and its pinned copy, B1's scratch, and the
    captured graph (None on the CPU).  On the card the pinned buffers
    are registered host memory (locked_host)."""

    __slots__ = ("entry", "cols", "mw", "h_in", "h_views", "d_in",
                 "d_views", "out", "host", "scratch", "graph", "busy")

    def __init__(self, entry, cols, wb: int, bb: int, mw: int, device):
        self.entry = entry
        self.cols = cols  # the table's (b_alo, b_ahi, b_t0, b_t1)
        self.mw = mw
        self.busy = False
        self.graph = None
        cuda = device.type == "cuda"
        parts = ((torch.int32, (2, wb)), (torch.float32, (bb,)),
                 (torch.float32, (bb,)), (torch.int64, (bb,)),
                 (torch.int64, (bb,)))
        nbytes = sum(int(np.prod(shape)) * dt.itemsize for dt, shape in parts)
        # zeroed: pad windows (meta 0) match nothing, so the warm-up
        # launch before a capture reads a well-formed empty batch
        self.h_in = (locked_host(nbytes) if cuda
                     else torch.zeros(nbytes, dtype=torch.uint8))
        self.d_in = (torch.zeros(nbytes, dtype=torch.uint8, device=device)
                     if cuda else self.h_in)
        self.h_views = self._views(self.h_in, parts)
        self.d_views = self._views(self.d_in, parts)
        self.out = torch.zeros(1 + 2 * mw, dtype=torch.int32, device=device)
        self.host = (locked_host(4 * (1 + 2 * mw)).view(torch.int32)
                     if cuda else self.out)
        self.scratch = ff.new_scratch(device, -(-wb // ff.TILE_WINDOWS))

    @staticmethod
    def _views(buf, parts):
        views, off = [], 0
        for dt, shape in parts:
            n = int(np.prod(shape)) * dt.itemsize
            views.append(buf[off:off + n].view(dt).view(shape))
            off += n
        return views

    def _call(self) -> None:
        """Upload, B1, download on the current stream: what a replay
        runs."""
        self.d_in.copy_(self.h_in, non_blocking=True)
        ff.fused_window_filter(*self.cols, *self.d_views, max_words=self.mw,
                               out=self.out, scratch=self.scratch)
        self.host.copy_(self.out, non_blocking=True)

    def capture(self, stream) -> None:
        """One eager call on the capture stream, then the capture of the
        same call (thread-local mode: other threads keep serving).  The
        cyclic collector is off while it captures: a dead table's units
        sit in a cycle with their entry, and freeing one (its graph, its
        registered buffers) on this thread mid-capture invalidates the
        capture.  Captures hold the cache's build lock, so no two
        overlap here."""
        dev = self.out.device
        # the buffers were zeroed on this thread's current stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            self._call()
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._call()
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        self.graph = graph

    def replay(self, wins, q_alo, q_ahi, q_t0, q_t1):
        """Run one batch (numpy, padded to this unit's buckets) ->
        (flat output on the host, the event that marks it ready or
        None)."""
        for view, a in zip(self.h_views, (wins, q_alo, q_ahi, q_t0, q_t1)):
            view.numpy()[...] = a
        if self.graph is None:  # the CPU: the plain version, no graph
            ff.fused_window_filter(*self.cols, *self.d_views,
                                   max_words=self.mw, out=self.out)
            return self.host, None
        self.graph.replay()
        event = torch.cuda.Event()
        event.record()
        with ff.COUNT_LOCK:
            ff.fused_window_filter.graph_replays += 1
        return self.host, event

    def release(self) -> None:
        self.entry.release(self)


class _Entry:
    """A GraphCache entry: the replay units of one key."""

    __slots__ = ("lock", "units")

    def __init__(self, lock):
        self.lock = lock
        self.units = []

    def acquire(self) -> Optional[_Instance]:
        with self.lock:
            for u in self.units:
                if not u.busy:
                    u.busy = True
                    return u
        return None

    def release(self, unit: _Instance) -> None:
        with self.lock:
            unit.busy = False


class GraphCache:
    """Process-wide cache of captured B1 calls.

    Key: (table token, window bucket, batch bucket, max_words), the
    token naming one FastTable for its lifetime.  compile() is
    idempotent and thread-safe.  Entries are evicted by last use past
    `max_entries` (DSS_RES_AOT_CAP, the reference's name for the same
    bound on its executables) and dropped at once when their
    table is garbage (a fold replaced it).  Reserved keys (a warmed
    grid) are never evicted; the bound is then the larger of
    `max_entries` and the reserved count plus MISS_HEADROOM (at most
    `max_entries`)."""

    def __init__(self, max_entries: Optional[int] = None):
        self._lock = threading.RLock()
        self._entries: Dict[tuple, _Entry] = {}
        self._max = (
            int(os.environ.get("DSS_RES_AOT_CAP", "128"))
            if max_entries is None
            else int(max_entries)
        )
        self._use: Dict[tuple, int] = {}
        self._reserved: set = set()
        # held while units are allocated and while they are captured:
        # a pinned allocation never overlaps another thread's capture
        self._build_lock = threading.Lock()
        # the one stream every capture runs on (made under the build
        # lock), from the high-priority pool: no resident loop's
        # stream (the default-priority pool) is ever the one capturing
        self._capture_streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._tick = 0
        self._tokens: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._next_token = itertools.count(1)
        self.evictions = 0
        self.dropped = 0  # entries of tables that died
        self.compiles = 0  # entries built
        self.captures = 0  # CUDA graphs captured (0 on the CPU)
        self.capture_failures = 0  # builds that raised (eager launches)
        self.capture_ms_total = 0.0
        # background capture thread: misses schedule their bucket here
        # so the NEXT batch in the same bucket hits
        self._pending: "deque[tuple]" = deque()
        self._pending_keys: set = set()
        self._compiler: Optional[threading.Thread] = None

    def _token(self, ft) -> int:
        with self._lock:
            tok = self._tokens.get(ft)
            if tok is None:
                tok = next(self._next_token)
                self._tokens[ft] = tok
                weakref.finalize(ft, self._drop_token, tok)
            return tok

    def _drop_token(self, tok: int) -> None:
        with self._lock:
            for k in [k for k in self._entries if k[0] == tok]:
                del self._entries[k]
                self._use.pop(k, None)
                self.dropped += 1
            self._reserved = {k for k in self._reserved if k[0] != tok}

    def key_for(self, ft, window_bucket: int, batch_bucket: int,
                max_words: int) -> tuple:
        return (
            self._token(ft), int(window_bucket), int(batch_bucket),
            int(max_words),
        )

    def get(self, key: tuple) -> Optional[_Entry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._tick += 1
                self._use[key] = self._tick
            return entry

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def instances(self) -> int:
        with self._lock:
            return sum(len(e.units) for e in self._entries.values())

    def reserved(self) -> int:
        with self._lock:
            return len(self._reserved)

    def cap(self) -> int:
        """The LRU bound in force: DSS_RES_AOT_CAP, or the reserved
        grids plus room for miss-driven entries when they need more."""
        with self._lock:
            return self._cap()

    def _cap(self) -> int:
        return max(self._max,
                   len(self._reserved) + min(MISS_HEADROOM, self._max))

    def compile(self, ft, window_bucket: int, batch_bucket: int,
                max_words: Optional[int] = None, instances: int = 2,
                reserve: bool = False) -> bool:
        """Build (and on the card capture) one bucket of `ft`.  Returns
        True when a fresh entry was built (False: already cached).
        `reserve` pins the key against eviction (grid warms).  Runs off
        any serving path: boot, fold and miss-driven warms."""
        if max_words is None:
            max_words = max_words_for(window_bucket)
        key = self.key_for(ft, window_bucket, batch_bucket, max_words)
        with self._lock:
            if reserve:
                self._reserved.add(key)
            if key in self._entries:
                return False
        t0 = time.perf_counter()
        try:
            # chaos seam: an injected failure models a capture error
            # for one bucket; it is counted, and submits in that bucket
            # keep launching B1 eagerly
            fault_point("graph.capture", detail=str(key))
            entry = _Entry(self._lock)
            cols = (ft.b_alo, ft.b_ahi, ft.b_t0, ft.b_t1)
            with self._build_lock:
                entry.units = [
                    _Instance(entry, cols, int(window_bucket),
                              int(batch_bucket), int(max_words), ft.device)
                    for _ in range(max(1, int(instances)))
                ]
                if ft.device.type == "cuda":
                    stream = self._capture_streams.get(ft.device)
                    if stream is None:
                        stream = self._capture_streams[ft.device] = (
                            torch.cuda.Stream(ft.device, priority=-1))
                    for unit in entry.units:
                        unit.capture(stream)
        except BaseException:
            with self._lock:
                self.capture_failures += 1
            raise
        captured = len(entry.units) if ft.device.type == "cuda" else 0
        dt = (time.perf_counter() - t0) * 1000
        with self._lock:
            if key in self._entries:
                return False
            self._tick += 1
            self._entries[key] = entry
            self._use[key] = self._tick
            self.compiles += 1
            self.captures += captured
            self.capture_ms_total += dt
            cap = self._cap()
            while len(self._entries) > cap:
                victim = min(
                    (k for k in self._entries
                     if k != key and k not in self._reserved),
                    key=lambda k: self._use.get(k, 0),
                    default=None,
                )
                if victim is None:
                    break
                del self._entries[victim]
                self._use.pop(victim, None)
                self.evictions += 1
        return True

    def compile_async(self, ft, window_bucket: int, batch_bucket: int,
                      max_words: int, instances: int = 2,
                      reserve: bool = False) -> None:
        """Schedule a bucket on the background capture thread (miss-
        driven warm: the serving path never blocks on it, and the next
        batch landing in this bucket hits).  Deduped per key; only a
        weak reference to the table is kept until the build runs.
        `reserve` pins the key at once (fold-time grid warms)."""
        key = self.key_for(ft, window_bucket, batch_bucket, max_words)
        with self._lock:
            if reserve:
                self._reserved.add(key)
            if key in self._entries or key in self._pending_keys:
                return
            self._pending_keys.add(key)
            self._pending.append((key, weakref.ref(ft), int(instances)))
            if self._compiler is None or not self._compiler.is_alive():
                self._compiler = threading.Thread(
                    target=self._compile_loop,
                    name="dss-resident-graph",
                    daemon=True,
                )
                self._compiler.start()

    def _compile_loop(self):
        while True:
            with self._lock:
                if not self._pending:
                    return
                key, ref, instances = self._pending.popleft()
            try:
                ft = ref()
                if ft is not None:
                    _, wb, bb, mw = key
                    self.compile(ft, wb, bb, mw, instances)
                del ft
            except Exception:  # noqa: BLE001 — a bad bucket must not
                import logging  # kill the capture thread (compile()
                # counted it in capture_failures)

                logging.getLogger("dss.resident").exception(
                    "graph capture failed for %s", key
                )
            finally:
                with self._lock:
                    self._pending_keys.discard(key)


# the process-wide cache every ResidentKernel shares
_CACHE = GraphCache()


def graph_cache() -> GraphCache:
    """The process-wide GraphCache (boot-warm logs, tests, the smoke)."""
    return _CACHE


class ResidentKernel:
    """The `kernel=` hook FastTable.submit consumes.

    lookup() maps a submit's shape bucket to a free replay unit of a
    captured entry; a miss returns None (submit launches B1 eagerly)
    and is counted, and with autocompile the bucket is scheduled on
    the background capture thread, so the warm grid is sized from live
    traffic.  A hit whose units are all busy also returns None and
    counts in `busy`.  Counters are per instance (one per resident
    loop); the entries live in the shared process cache."""

    __slots__ = ("cache", "autocompile", "instances", "hits", "misses",
                 "busy")

    def __init__(self, cache: Optional[GraphCache] = None,
                 autocompile: bool = True, instances: int = 2):
        self.cache = cache if cache is not None else _CACHE
        self.autocompile = bool(autocompile)
        self.instances = max(1, int(instances))
        self.hits = 0
        self.misses = 0
        self.busy = 0

    def lookup(self, ft, window_bucket: int, batch_bucket: int,
               max_words: int) -> Optional[_Instance]:
        entry = self.cache.get(
            self.cache.key_for(ft, window_bucket, batch_bucket, max_words)
        )
        if entry is None:
            self.misses += 1
            if self.autocompile:
                self.cache.compile_async(
                    ft, window_bucket, batch_bucket, max_words,
                    self.instances,
                )
            return None
        unit = entry.acquire()
        if unit is None:
            self.busy += 1
            return None
        self.hits += 1
        return unit

    def warm(self, ft, batch_buckets=None, window_buckets=None) -> int:
        """Build the bucket grid for one FastTable, SYNCHRONOUSLY, its
        keys reserved.  Returns the number of fresh entries built.  For
        boot/test warm only — anything on a fold or serving path wants
        warm_async."""
        n = 0
        for bb in batch_buckets or batch_bucket_grid():
            for wb in window_buckets or window_bucket_grid():
                if self.cache.compile(ft, wb, bb, None, self.instances,
                                      reserve=True):
                    n += 1
        return n

    def warm_async(self, ft, batch_buckets=None,
                   window_buckets=None) -> None:
        """Schedule the bucket grid on the background capture thread —
        the fold-time warm hook uses this so a fold never stalls behind
        captures; until a bucket lands, submits launch B1 eagerly."""
        for bb in batch_buckets or batch_bucket_grid():
            for wb in window_buckets or window_bucket_grid():
                self.cache.compile_async(
                    ft, wb, bb, max_words_for(wb), self.instances,
                    reserve=True,
                )

    def buckets(self) -> int:
        return self.cache.size()


# feeder/collector shutdown sentinel
_DONE = object()


class ResidentLoop:
    """Persistent device execution loop for the fused query path.

    A dedicated feeder thread owns a bounded host ring buffer; the
    coalescer's pack stage enqueues drained batches (enqueue() —
    non-blocking, False on a full ring so the router can fall back to
    the cold device path instead of stalling the pack stage).  The
    feeder pops jobs and submits them through the table's resident
    path (DarTable.query_many_submit(kernel=...): captured buckets on
    the loop's own stream) WITHOUT waiting for results, keeping up to
    `max_inflight` batches in flight; the collector thread resolves
    them in submission order and invokes each job's `done` callback
    with the results and the measured marginal cost.

    The cost a done callback receives is the *inter-completion gap*
    (time since the previous batch finished, floored at this batch's
    own submit time): in a full pipeline that is the marginal per-batch
    cost — the resident floor — while a lone batch pays its full round
    trip.

    close() stops admission, DRAINS the ring (every enqueued batch is
    still submitted, collected, and delivered), then joins both
    threads.  Each ResidentKernel entry gets max_inflight + 2 replay
    units: the batches in the queue, the one the feeder holds and the
    one being collected, so a full stream never finds a bucket busy.
    """

    def __init__(self, table, *, ring_capacity: int = 32,
                 max_inflight: int = 4,
                 kernel: Optional[ResidentKernel] = None):
        self._table = table
        self.kernel = (
            kernel if kernel is not None
            else ResidentKernel(instances=max(1, int(max_inflight)) + 2)
        )
        dev = getattr(table, "device", None)
        self._stream = (
            torch.cuda.Stream(dev)
            if dev is not None and dev.type == "cuda" else None
        )
        self._ring: deque = deque()
        self._ring_cap = max(1, int(ring_capacity))
        self._cond = threading.Condition()
        self._closed = False
        self._inflight_q: _queue.Queue = _queue.Queue(
            maxsize=max(1, int(max_inflight))
        )
        self._max_inflight = max(1, int(max_inflight))
        self._feeder: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self._last_done = 0.0  # perf_counter of the last collection
        # counters (stats() -> co_res_* gauges)
        self.enqueued = 0
        self.rejected = 0
        self.submitted = 0
        self.collected = 0
        self.errors = 0

    # -- admission -----------------------------------------------------------

    def has_space(self) -> bool:
        return not self._closed and len(self._ring) < self._ring_cap

    def enqueue(self, payload, done) -> bool:
        """payload: the 7-tuple QueryCoalescer._pack_args produces
        (keys_list, alt_lo, alt_hi, t_start, t_end, now, owner_ids).
        done(results, error, gap_ms, lat_ms, used_device) runs on the
        collector thread — gap_ms is the marginal inter-completion
        cost (the resident floor signal), lat_ms the full
        submit->delivered wall time (the deadline signal).  Returns
        False (nothing happens) when the ring is full or the loop is
        closed — the caller keeps ownership of the batch and routes
        it elsewhere."""
        with self._cond:
            if self._closed or len(self._ring) >= self._ring_cap:
                self.rejected += 1
                return False
            self._ring.append((payload, done))
            self.enqueued += 1
            self._ensure_threads()
            self._cond.notify_all()
        return True

    def _ensure_threads(self):
        if self._feeder is None or not self._feeder.is_alive():
            self._feeder = threading.Thread(
                target=self._feed_loop, name="dss-resident-feeder",
                daemon=True,
            )
            self._feeder.start()
        if self._collector is None or not self._collector.is_alive():
            self._collector = threading.Thread(
                target=self._collect_loop, name="dss-resident-collect",
                daemon=True,
            )
            self._collector.start()

    # -- the loop ------------------------------------------------------------

    def _submit(self, payload):
        keys, lo, hi, t0s, t1s, now, owners = payload
        return self._table.query_many_submit(
            keys, lo, hi, t0s, t1s, now=now, owner_ids=owners,
            kernel=self.kernel,
        )

    def _feed_loop(self):
        """Pop the ring, submit onto the loop's stream, hand to the
        collector.  The bounded inflight queue is the stream-depth
        governor: when `max_inflight` batches are outstanding the
        put() blocks, the ring fills, and enqueue() starts returning
        False — backpressure the router converts into cold-device or
        host routing instead of unbounded device queueing."""
        while True:
            with self._cond:
                while not self._ring and not self._closed:
                    self._cond.wait()
                if not self._ring:
                    break  # closed and fully drained
                payload, done = self._ring.popleft()
                self._cond.notify_all()
            t_sub = time.perf_counter()
            try:
                # chaos seam: device loss mid-stream — the error rides
                # the normal delivery path to the coalescer's done
                # callback, which absorbs it (host re-run)
                fault_point("resident.submit")
                if self._stream is None:
                    pq = self._submit(payload)
                else:
                    with torch.cuda.stream(self._stream):
                        pq = self._submit(payload)
            except BaseException as e:  # noqa: BLE001 — deliver, don't die
                self._inflight_q.put((None, done, t_sub, e))
                continue
            with self._cond:
                self.submitted += 1
            self._inflight_q.put((pq, done, t_sub, None))
        self._inflight_q.put(_DONE)

    def _collect_loop(self):
        while True:
            item = self._inflight_q.get()
            if item is _DONE:
                return
            pq, done, t_sub, err = item
            results = None
            used_device = False
            if err is None:
                try:
                    if pq is not None:
                        pq.wait_device()
                        fn = getattr(pq, "used_device", None)
                        used_device = bool(fn()) if fn else False
                    results = self._table.query_many_collect(pq)
                except BaseException as e:  # noqa: BLE001
                    err = e
            t_done = time.perf_counter()
            # marginal cost: gap since the previous completion, never
            # earlier than this batch's own submit; lat is the full
            # wall time a caller experienced — the two feed DIFFERENT
            # cost-model keys (floor vs latency)
            gap_ms = (t_done - max(t_sub, self._last_done)) * 1000
            lat_ms = (t_done - t_sub) * 1000
            self._last_done = t_done
            with self._cond:
                self.collected += 1
                if err is not None:
                    self.errors += 1
            try:
                done(results, err, gap_ms, lat_ms, used_device)
            except Exception:  # noqa: BLE001 — a bad callback must not
                import logging  # kill the loop

                logging.getLogger("dss.resident").exception(
                    "resident done-callback failed"
                )

    # -- lifecycle / introspection -------------------------------------------

    def close(self, join: bool = True, timeout: float = 30.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            feeder, collector = self._feeder, self._collector
        if not join:
            return
        me = threading.current_thread()
        for th in (feeder, collector):
            if th is not None and th is not me:
                th.join(timeout)

    def stats(self) -> dict:
        cache = self.kernel.cache
        with self._cond:
            return {
                "ring_depth": len(self._ring),
                "ring_cap": self._ring_cap,
                "inflight": self._inflight_q.qsize(),
                "max_inflight": self._max_inflight,
                "enqueued": self.enqueued,
                "rejected": self.rejected,
                "submitted": self.submitted,
                "collected": self.collected,
                "errors": self.errors,
                "graph_hits": self.kernel.hits,
                "graph_misses": self.kernel.misses,
                "graph_busy": self.kernel.busy,
                "graph_buckets": self.kernel.buckets(),
                "graph_instances": cache.instances(),
                "graph_evictions": cache.evictions,
                "graph_dropped": cache.dropped,
                "graph_compiles": cache.compiles,
                "graph_captures": cache.captures,
                "graph_capture_failures": cache.capture_failures,
                "graph_capture_ms_total": round(cache.capture_ms_total, 1),
            }

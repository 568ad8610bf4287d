"""The fast conflict-query path: host index lookup + dense device filter.

The port of the reference's `dss_tpu/ops/fastpath.py` (`FastTable`).
Division of labor:

  host (CPU)     — cell-key -> postings-range lookup (numpy
                   searchsorted over the sorted key column), window
                   packing, and result assembly from the compacted hit
                   words the device returns.
  device (CUDA)  — for every (query, cell) window of the exact block
                   columns, the 4D overlap test (f32 altitudes, i64 ns
                   times), hits bit-packed to u32 words and the
                   non-empty words compacted on the device
                   (ops.fused_filter), so the D2H copy is proportional
                   to hits, not to windows scanned.

submit() launches on the current stream and starts a non-blocking copy
of the flat output into pinned host memory, recording an event;
collect() waits on that event and decodes.  Many batches can be in
flight at once.  With a resident `kernel=` (ops/resident.py) a submit
whose shape bucket was captured replays that CUDA graph instead of
launching B1 eagerly.  On the CPU both halves are plain synchronous
calls.

Small batches (<= HOST_MAX_BATCH queries) answer from the exact host
scan instead (query_host_auto), with identical results.  The three host
halves (window pack, hit decode, host scan) prefer the C++ library of
dss_tpu_torch.native where it is built, and fall back to the numpy
versions below, which give the same output bit for bit.

Every table also carries the quantized `p3` columns of the legacy
path: query_batch filters windows conservatively on the device (B2,
ops.fastpath_cuda.filter_windows, or the reference's XLA route as
torch ops, _filter_words), and exact_filter re-checks the hits on the
host.  A table built without `slot_exact` has only `p3`: its fused and
host routes are absent, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dss_tpu_torch.ops.fastpath_cuda import filter_windows, window_hits
from dss_tpu_torch.ops.fused_filter import (
    BLOCK, PLAIN_CHUNK, WORDS, fused_window_filter,
)

INT32_MAX = np.int32(2**31 - 1)
INT32_MIN = np.int32(-(2**31))
DEAD_T1 = np.int64(-(2**62))  # t_end of dead postings: never >= any now

_NATIVE: Optional[tuple] = None  # one-shot import cache (module|None,)


def _native_mod():
    """The dss_tpu_torch.native module, or None when it can't import.
    The import is cached; native.available() stays cheap per call (a
    lazy dlopen behind a lock-free fast path).  Setting _NATIVE to
    (None,) forces the numpy paths."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from dss_tpu_torch import native
        except Exception:  # pragma: no cover
            native = None
        _NATIVE = (native,)
    return _NATIVE[0]


def resolve_device(device=None) -> torch.device:
    """The device a table lives on: `cuda` unless the caller names
    another.  A CUDA device on a machine without a card raises — the
    port never quietly runs a device table on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions"
        )
    return dev


def mm_floor(x) -> np.ndarray:
    """Altitude in metres -> i32 millimetres, rounded down (outward for
    a lower bound) and clipped to the i32 range."""
    v = np.floor(np.asarray(x, np.float64) * 1000.0)
    return np.clip(v, -(2**31), 2**31 - 1).astype(np.int32)


def mm_ceil(x) -> np.ndarray:
    v = np.ceil(np.asarray(x, np.float64) * 1000.0)
    return np.clip(v, -(2**31), 2**31 - 1).astype(np.int32)


def sec_floor(x) -> np.ndarray:
    """Time in ns -> i32 seconds, rounded down and clipped."""
    return np.clip(
        np.asarray(x, np.int64) // 10**9, -(2**31), 2**31 - 1
    ).astype(np.int32)


def sec_ceil(x) -> np.ndarray:
    return np.clip(
        -((-np.asarray(x, np.int64)) // 10**9), -(2**31), 2**31 - 1
    ).astype(np.int32)


def _bitpack_weights() -> np.ndarray:
    """(128, 8) f32: lane i contributes 2^(i%16) to word i//16."""
    w = np.zeros((BLOCK, 8), np.float32)
    for i in range(BLOCK):
        w[i, i // 16] = float(1 << (i % 16))
    return w


def segmented_arange(counts: np.ndarray) -> np.ndarray:
    """Ragged expansion: for counts [2, 3] -> [0, 1, 0, 1, 2]."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    return np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)


def pow2_bucket(n: int, lo: int = 256) -> int:
    """Smallest power-of-two >= max(n, lo): the shape-bucketing rule of
    the reference, kept so both produce outputs of identical shape."""
    v = lo
    while v < n:
        v *= 2
    return v


# hit-word decode tables: popcount per uint16 half, and a de Bruijn
# count-trailing-zeros LUT (the multiply wraps mod 2^32 by design)
_POPCOUNT16 = (
    np.unpackbits(np.arange(1 << 16, dtype="<u2").view(np.uint8))
    .reshape(-1, 16)
    .sum(axis=1)
    .astype(np.uint16)
)
_DEBRUIJN_CTZ = np.zeros(32, np.int8)
for _i in range(32):
    _DEBRUIJN_CTZ[(((1 << _i) * 0x077CB531) & 0xFFFFFFFF) >> 27] = _i


def _expand_hit_words(bits_u32: np.ndarray):
    """(word_index, bit_position) pairs for every set bit, word-major
    with ascending bit positions within a word.  Per-word popcount gives
    each word's output span; iteration k extracts the k-th lowest set
    bit of every still-active word (de Bruijn ctz) into span start + k."""
    pc = _POPCOUNT16[bits_u32 & 0xFFFF] + _POPCOUNT16[bits_u32 >> 16]
    total = int(pc.sum())
    base = np.cumsum(pc) - pc
    wi = np.repeat(np.arange(len(bits_u32), dtype=np.int64), pc)
    bitpos = np.empty(total, np.int32)
    rem = bits_u32.copy()
    active = np.flatnonzero(rem)
    k = 0
    while active.size:
        v = rem[active]
        low = v & (~v + np.uint32(1))
        ctz = _DEBRUIJN_CTZ[
            ((low * np.uint32(0x077CB531)) >> np.uint32(27)).astype(np.int64)
        ]
        bitpos[base[active] + k] = ctz
        v &= v - np.uint32(1)
        rem[active] = v
        active = active[v != 0]
        k += 1
    return wi, bitpos


def warmup(device=None) -> None:
    """Build the kernel and run the first device-path batch shapes
    (HOST_MAX_BATCH + 1 queries, 3- and 8-cell coverings) ahead of
    traffic."""
    n = BLOCK
    ones = np.ones(n, bool)
    ft = FastTable(
        np.arange(n, dtype=np.int32),
        np.arange(n, dtype=np.int32),
        np.zeros(n, np.float32),
        np.ones(n, np.float32),
        np.zeros(n, np.int64),
        np.full(n, 2, np.int64),
        ones,
        slot_exact=dict(
            alt_lo=np.zeros(n, np.float32),
            alt_hi=np.ones(n, np.float32),
            t0=np.zeros(n, np.int64),
            t1=np.full(n, 2, np.int64),
            live=ones.copy(),
        ),
        device=device,
    )
    b = FastTable.HOST_MAX_BATCH + 1
    for width in (3, 8):
        qk = np.broadcast_to(
            np.arange(width, dtype=np.int32)[None, :], (b, width)
        ).copy()
        ft.query_fused(
            qk,
            np.zeros(b, np.float32),
            np.ones(b, np.float32),
            np.zeros(b, np.int64),
            np.ones(b, np.int64),
            now=1,
        )


class PendingBatch:
    """In-flight fused query batch: the flat output (pinned host copy
    on CUDA, the result itself on the CPU), the event that marks the
    copy done, and the host decode state.  `instance` is the resident
    replay unit whose static output `host` is, held until collect has
    read it (release())."""

    __slots__ = (
        "host", "event", "win_q", "win_blk", "host_inputs", "nw",
        "max_words", "kernel", "instance",
    )

    def __init__(self, host, event, win_q, win_blk, host_inputs, nw,
                 max_words, kernel=None, instance=None):
        self.host = host  # i32 [n_words, wordpos..., bits...]
        self.event = event  # torch.cuda.Event or None (CPU)
        self.win_q = win_q
        self.win_blk = win_blk
        self.host_inputs = host_inputs  # for the overflow rerun
        self.nw = nw
        self.max_words = max_words
        self.kernel = kernel  # the resident selector, kept for the rerun
        self.instance = instance

    def ready(self) -> None:
        """Block until the kernel and the D2H copy have completed
        (readiness only — no decode)."""
        if self.event is not None:
            self.event.synchronize()

    def release(self) -> None:
        """Hand the replay unit back (idempotent)."""
        inst, self.instance = self.instance, None
        if inst is not None:
            inst.release()


class FastTable:
    """Device-resident quantized `p3` columns and, with `slot_exact`,
    exact block columns + host decode state."""

    WORDS = WORDS  # u32 hit words per window

    # route small batches to the host when the candidate postings fit
    # comfortably in cache; large batches amortize the device launch
    HOST_MAX_BATCH = 64
    HOST_MAX_CANDIDATES = 1 << 16
    # the forced chunked host route (query_host_chunked): per-chunk
    # candidate cap beyond which the chunk is device-shaped work
    HOST_ROUTE_MAX_CANDIDATES = 1 << 18

    def __init__(
        self,
        post_key: np.ndarray,  # i32[P] sorted
        post_ent: np.ndarray,  # i32[P]
        alt_lo: np.ndarray,  # f32[P] per-posting (inlined)
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # i64[P] ns
        t_end: np.ndarray,
        live: np.ndarray,  # bool[P]
        *,
        slot_exact: Optional[dict] = None,  # per-slot {"alt_lo","alt_hi",
        #                                     "t0","t1","live"}
        device=None,
    ):
        post_key = np.asarray(post_key)
        P = len(post_key)
        # pad keys (-1 per-row, -2 window pad) must stay distinguishable
        # from real DAR keys (30-bit, geo/s2cell.py)
        if P and int(post_key.min()) < 0:
            raise ValueError(
                f"FastTable requires non-negative DAR keys, got min "
                f"{int(post_key.min())}"
            )
        if P and int(post_key.max()) >= INT32_MAX:
            raise ValueError(
                "FastTable requires DAR keys < INT32_MAX "
                f"(pad sentinel), got max {int(post_key.max())}"
            )
        # the reference's padding: 2 extra blocks so lo_blk+1 never
        # reads out of range, same block count on both sides
        ppad = ((P + 2 * BLOCK - 1) // (2 * BLOCK)) * 2 * BLOCK + 4 * BLOCK
        nb = ppad // BLOCK
        # quantized columns, conservative (intervals rounded outward);
        # pad lanes are INT32_MAX in every row and dead postings end at
        # INT32_MIN, so neither matches a real window
        packed = np.full((5, ppad), INT32_MAX, np.int32)
        packed[0, :P] = post_key
        packed[1, :P] = mm_floor(alt_lo)
        packed[2, :P] = mm_ceil(alt_hi)
        packed[3, :P] = sec_floor(t_start)
        packed[4, :P] = np.where(live, sec_ceil(t_end), INT32_MIN)
        p3 = packed.reshape(5, nb, BLOCK).transpose(1, 0, 2).copy()
        live = np.asarray(live, bool)
        cols = None
        if slot_exact is not None:
            # exact per-posting columns in block layout; pad lanes and
            # dead postings can never match (alo=+inf, ahi=-inf,
            # t1=-(2**62))
            b_alo = np.full(ppad, np.inf, np.float32)
            b_ahi = np.full(ppad, -np.inf, np.float32)
            b_t0 = np.full(ppad, 2**62, np.int64)
            b_t1 = np.full(ppad, DEAD_T1, np.int64)
            b_alo[:P] = np.asarray(alt_lo, np.float32)
            b_ahi[:P] = np.asarray(alt_hi, np.float32)
            b_t0[:P] = np.asarray(t_start, np.int64)
            b_t1[:P] = np.where(live, np.asarray(t_end, np.int64), DEAD_T1)
            cols = tuple(c.reshape(nb, BLOCK) for c in (b_alo, b_ahi, b_t0, b_t1))
        self._adopt(post_key, post_ent, live, p3, slot_exact, cols,
                    resolve_device(device))

    def _adopt(self, host_key, host_ent, host_live, p3, slot_exact, cols,
               device) -> None:
        """Take the host arrays, the (NB, 5, 128) `p3` columns and, with
        `slot_exact`, the (NB, 128) exact columns `cols` = (b_alo,
        b_ahi, b_t0, b_t1); upload the columns to `device`."""
        self.device = device
        self.n_postings = len(host_key)
        self.n_blocks = p3.shape[0]
        self.host_key = host_key
        self.host_ent = np.asarray(host_ent)
        self.host_live = host_live

        def up(a):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:  # e.g. a view of another table's
                a = a.copy()
            return torch.from_numpy(a).to(device)

        self.p3 = up(p3)  # (NB, 5, 128) i32
        self.bitpack_w = up(_bitpack_weights())  # (128, 8) f32
        self.slot_exact = None
        self.b_alo = self.b_ahi = self.b_t0 = self.b_t1 = None
        if slot_exact is None:
            return
        self.b_alo, self.b_ahi, self.b_t0, self.b_t1 = map(up, cols)
        # host copies of the per-slot exact values (host route +
        # liveness); `live` is normalized to a contiguous buffer here,
        # where no concurrent mutator exists yet: mark_dead() flips
        # bits of THIS array in place, and the native host scan caches
        # a uint8 view of the same memory (_hostq_cols)
        self.slot_exact = {k: np.asarray(v) for k, v in slot_exact.items()}
        self.slot_exact["live"] = np.ascontiguousarray(
            self.slot_exact["live"], dtype=bool
        )

    def mark_dead(self, slot: int) -> None:
        """Tombstone one slot in place (no rebuild): collect() and the
        host route drop it from then on.  A table without exact columns
        has nothing to mark."""
        if self.slot_exact is None:
            return
        self.slot_exact["live"][slot] = False

    # -- host window expansion -----------------------------------------------

    def _range_lookup(self, k: np.ndarray):
        """For each query key, the [lo, hi) slice of the sorted key
        column.  Large batches are sorted first so consecutive binary
        searches walk the same cache lines; results go back to query
        order."""
        P = len(self.host_key)
        if P <= 4096 or len(k) <= 512:
            return (
                np.searchsorted(self.host_key, k, side="left"),
                np.searchsorted(self.host_key, k, side="right"),
            )
        order = np.argsort(k, kind="stable")
        ks = k[order]
        lo = np.empty(len(k), np.int64)
        hi = np.empty(len(k), np.int64)
        lo[order] = np.searchsorted(self.host_key, ks, side="left")
        hi[order] = np.searchsorted(self.host_key, ks, side="right")
        return lo, hi

    def _expand_windows(self, qkeys: np.ndarray):
        """(query, cell) pairs -> every 128-block their postings runs
        touch.  Returns (win_q, win_key, win_blk, win_start, win_end);
        [start, end) is the run's lane slice within the block."""
        B, W = qkeys.shape
        qk = np.ascontiguousarray(qkeys, np.int32)
        lo, hi = self._range_lookup(qk.ravel())
        nonempty = hi > lo  # also drops pad cells (-1)
        lo, hi = lo[nonempty], hi[nonempty]
        flat_q = np.repeat(np.arange(B), W)[nonempty]
        flat_k = qk.ravel()[nonempty]
        first_blk = lo // BLOCK
        n_blocks = (hi - 1) // BLOCK - first_blk + 1  # >= 1
        win_q = np.repeat(flat_q, n_blocks).astype(np.int32)
        win_key = np.repeat(flat_k, n_blocks)
        starts = np.repeat(first_blk, n_blocks)
        win_blk = (starts + segmented_arange(n_blocks)).astype(np.int32)
        blk0 = win_blk.astype(np.int64) * BLOCK
        win_start = np.maximum(np.repeat(lo, n_blocks) - blk0, 0).astype(np.int32)
        win_end = np.minimum(np.repeat(hi, n_blocks) - blk0, BLOCK).astype(np.int32)
        return win_q, win_key, win_blk, win_start, win_end

    def _sample_index(self):
        """(host_key i32, sample, sample0) for the native range
        lookups: 1/64- and 1/4096-sampled key columns that keep the
        search's top levels cache-resident.  The table is immutable, so
        built once and cached; None samples below 2^14 postings (flat
        search is already cache-resident)."""
        hk = np.ascontiguousarray(self.host_key, np.int32)
        sample = getattr(self, "_hk_sample", None)
        sample0 = getattr(self, "_hk_sample0", None)
        if sample is None and len(hk) > 1 << 14:
            sample = self._hk_sample = np.ascontiguousarray(hk[::64])
            sample0 = self._hk_sample0 = np.ascontiguousarray(
                sample[::64]
            )
        return hk, sample, sample0

    def _pack_windows(self, qkeys: np.ndarray):
        """Expand + pack windows for the kernel: one (2, bucket) i32
        array [blk, start|end<<8|qidx<<16].  Returns
        (wins, win_q, win_blk, nw); nw == 0 means no work.  Prefers the
        native pack (binary searches + ragged expansion in two
        GIL-released calls), bit-identical to the numpy path below."""
        if len(qkeys) > (1 << 15):
            raise ValueError("fused path supports batches up to 32768")
        nat = _native_mod()
        if nat is not None and nat.available():
            qk = np.ascontiguousarray(qkeys, np.int32)
            hk, sample, sample0 = self._sample_index()
            res = nat.pack_windows(
                hk, qk.ravel(), qk.shape[1], BLOCK, pow2_bucket,
                sample=sample, sample0=sample0,
            )
            if res is not None:
                return res
        win_q, _, win_blk, win_start, win_end = self._expand_windows(qkeys)
        nw = len(win_blk)
        if nw == 0:
            return None, win_q, win_blk, 0
        # qidx lives in bits 16-31 of a signed i32 meta word; the
        # <= 2^15 batch gate keeps the sign bit clear
        bucket = pow2_bucket(nw)
        wins = np.zeros((2, bucket), np.int32)
        wins[0, :nw] = win_blk
        # pad rows keep meta 0 -> start == end == 0 -> no lanes match
        wins[1, :nw] = win_start | (win_end << 8) | (win_q << 16)
        return wins, win_q, win_blk, nw

    # -- fused device path ---------------------------------------------------

    def submit(
        self,
        qkeys: np.ndarray,  # i32[B, W] DAR keys, pad -1
        alt_lo: np.ndarray,  # f32[B] (-inf if unbounded)
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # i64[B] ns (NO_TIME_LO if unbounded)
        t_end: np.ndarray,
        *,
        now,  # int scalar or i64[B] per-query request time
        max_words: Optional[int] = None,
        kernel=None,  # resident selector (ops/resident.py): maps this
        #               submit's shape bucket to a captured CUDA graph;
        #               None (or a miss) launches B1 eagerly
    ) -> Optional[PendingBatch]:
        """Launch one fused query batch (no device sync).  Returns None
        when no query key has any postings.

        max_words=None sizes the compacted-word buffer to a pow2 bucket
        >= the window count; collect() reruns at the 4*nw hard bound on
        overflow."""
        if self.slot_exact is None:
            raise ValueError("table has no exact columns (built without "
                             "slot_exact): use query_batch")
        wins, win_q, win_blk, nw = self._pack_windows(qkeys)
        if nw == 0:
            return None
        if max_words is None:
            max_words = pow2_bucket(nw, lo=1 << 16)
        # fold the liveness rule into the lower time bound per query:
        # t_end >= max(t_start, now) == (t_end >= t_start) & (t_end >= now)
        t0_eff = np.maximum(
            np.asarray(t_start, np.int64), np.asarray(now, np.int64)
        )
        # pad the batch axis to a pow2 bucket, as the reference does:
        # a captured graph has fixed shapes.  Pad queries are inert —
        # no window's meta references an index >= B.
        b = len(qkeys)
        bb = pow2_bucket(b, lo=16)

        def qpad(a, dtype):  # an owned (bb,) copy: inputs may be read-only
            out = np.zeros(bb, dtype)
            out[:b] = np.broadcast_to(np.asarray(a, dtype), (b,))
            return out

        q = (qpad(alt_lo, np.float32), qpad(alt_hi, np.float32),
             qpad(t0_eff, np.int64), qpad(t_end, np.int64))
        inst = None
        if kernel is not None:
            inst = kernel.lookup(self, wins.shape[1], bb, max_words)
        if inst is not None:
            host, event = inst.replay(wins, *q)
        else:
            dev = self.device
            out = fused_window_filter(
                self.b_alo, self.b_ahi, self.b_t0, self.b_t1,
                torch.from_numpy(wins).to(dev),
                *(torch.from_numpy(a).to(dev) for a in q),
                max_words=max_words,
            )
            host, event = out, None
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
        return PendingBatch(
            host, event, win_q, win_blk,
            (qkeys, alt_lo, alt_hi, t_start, t_end, now), nw, max_words,
            kernel, inst,
        )

    def collect(
        self, pending: Optional[PendingBatch]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve a submitted batch -> (qidx i64[H], slots i64[H]),
        exact (not deduped).  The one host sync per batch."""
        if pending is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        try:
            pending.ready()
            out = pending.host.numpy()
            mw = pending.max_words
            n_words = int(out[0])
            # copies: a replay unit's output is reused once released
            wordpos = out[1 : 1 + min(n_words, mw)].copy()
            bits = out[1 + mw : 1 + mw + min(n_words, mw)].astype(np.int32)
        finally:
            pending.release()
        if n_words > mw:
            # overflow: rerun at the hard upper bound (4 words per
            # window), which cannot overflow, through the same selector
            qkeys, alt_lo, alt_hi, t_start, t_end, now = pending.host_inputs
            hard = pow2_bucket(4 * pending.nw, lo=1 << 16)
            return self.collect(
                self.submit(
                    qkeys, alt_lo, alt_hi, t_start, t_end,
                    now=now, max_words=hard, kernel=pending.kernel,
                )
            )
        if n_words == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        wshift = WORDS.bit_length() - 1  # WORDS is a pow2
        nat = _native_mod()
        if nat is not None and nat.available():
            # native decode: popcount/ctz expansion + pad/tombstone
            # filter in one GIL-released call over the copies above
            # (never the replay unit's pinned buffer, which is handed
            # back by now), same output order
            res = nat.decode_hits(
                wordpos, bits.view(np.uint32),
                np.ascontiguousarray(pending.win_q, np.int32),
                np.ascontiguousarray(pending.win_blk, np.int32),
                wshift, BLOCK,
                np.ascontiguousarray(self.host_ent, np.int32),
                self.n_postings,
                self.slot_exact["live"].view(np.uint8),
            )
            if res is not None:
                return res
        wi, bitpos = _expand_hit_words(bits.view(np.uint32))
        wp = wordpos[wi]
        win = wp >> wshift
        lane = ((wp & (WORDS - 1)) << 5) + bitpos
        offs = pending.win_blk[win].astype(np.int64) * BLOCK + lane
        ok = offs < self.n_postings
        offs = offs[ok]
        slots = self.host_ent[offs].astype(np.int64)
        qidx = pending.win_q[win[ok]].astype(np.int64)
        # post-build tombstones (mark_dead) are dropped here
        alive = self.slot_exact["live"][slots]
        return qidx[alive], slots[alive]

    def query_fused(
        self, qkeys, alt_lo, alt_hi, t_start, t_end, *, now,
        max_words: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """submit + collect in one call -> exact (qidx, slots)."""
        return self.collect(
            self.submit(
                qkeys, alt_lo, alt_hi, t_start, t_end,
                now=now, max_words=max_words,
            )
        )

    # -- host small-batch path ----------------------------------------------

    def host_candidates(self, qkeys: np.ndarray, *,
                        max_batch: Optional[int] = None,
                        max_candidates: Optional[int] = None):
        """-> (lo, hi) postings ranges for the batch, or None when the
        batch should go to the device (too big)."""
        mb = self.HOST_MAX_BATCH if max_batch is None else int(max_batch)
        if len(qkeys) > mb or self.slot_exact is None:
            return None
        mc = (
            self.HOST_MAX_CANDIDATES
            if max_candidates is None
            else int(max_candidates)
        )
        lo, hi = self._range_lookup(
            np.ascontiguousarray(qkeys, np.int32).ravel()
        )
        if int((hi - lo).sum()) > mc:
            return None
        return lo, hi

    def query_host_chunked(
        self, qkeys, alt_lo, alt_hi, t_start, t_end, *, now,
        chunk: Optional[int] = None,
    ):
        """FORCED exact host answer for batches of any size, in chunks
        of HOST_MAX_BATCH rows with the raised
        HOST_ROUTE_MAX_CANDIDATES cap.  -> (qidx, slots) identical to
        the fused path, or None when any chunk exceeds the cap (or the
        table has no exact columns)."""
        if self.slot_exact is None:
            return None
        b = len(qkeys)
        step = self.HOST_MAX_BATCH if chunk is None else max(1, int(chunk))
        now_b = np.broadcast_to(np.asarray(now, np.int64), (b,))
        parts_q: List[np.ndarray] = []
        parts_s: List[np.ndarray] = []
        for s in range(0, b, step):
            e = min(b, s + step)
            res = self.query_host_auto(
                qkeys[s:e], alt_lo[s:e], alt_hi[s:e],
                t_start[s:e], t_end[s:e], now=now_b[s:e],
                max_batch=step,
                max_candidates=self.HOST_ROUTE_MAX_CANDIDATES,
            )
            if res is None:
                return None
            qi, sl = res
            parts_q.append(qi + s)
            parts_s.append(sl)
        if not parts_q:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(parts_q), np.concatenate(parts_s)

    def query_host_auto(
        self, qkeys, alt_lo, alt_hi, t_start, t_end, *, now,
        max_batch: Optional[int] = None,
        max_candidates: Optional[int] = None,
    ):
        """Exact host-path answer for small batches: (qidx, slots), or
        None when the batch should go to the device (or the table has
        no exact columns).  Prefers the native scan (one GIL-released
        call; same compares on the same values as query_host), and
        falls back to the numpy path where the library is absent."""
        mb = self.HOST_MAX_BATCH if max_batch is None else int(max_batch)
        if len(qkeys) > mb or self.slot_exact is None:
            return None
        nat = _native_mod()
        if nat is not None and nat.available():
            cols = self._hostq_columns()
            res = nat.query_host(
                *cols[:8],
                np.ascontiguousarray(qkeys, np.int32),
                np.ascontiguousarray(alt_lo, np.float32),
                np.ascontiguousarray(alt_hi, np.float32),
                np.ascontiguousarray(t_start, np.int64),
                np.ascontiguousarray(t_end, np.int64),
                np.ascontiguousarray(
                    np.broadcast_to(np.asarray(now, np.int64), (len(qkeys),))
                ),
                self.HOST_MAX_CANDIDATES
                if max_candidates is None
                else int(max_candidates),
                sample=cols[8], sample0=cols[9],
            )
            if res is None:
                return None  # candidate gate: device path
            return res[0], res[1].astype(np.int64)
        ranges = self.host_candidates(
            qkeys, max_batch=max_batch, max_candidates=max_candidates
        )
        if ranges is None:
            return None
        return self.query_host(
            qkeys, alt_lo, alt_hi, t_start, t_end, now=now, ranges=ranges
        )

    def _hostq_columns(self):
        """The table-side columns of the native host scan, prepared
        once: (host_key, host_ent, host_live u8, slot live u8, alt_lo,
        alt_hi, t0, t1, sample, sample0) in the native dtypes.  The live view shares
        memory with slot_exact["live"] (made a contiguous bool buffer in
        _adopt), so a mark_dead() after this is seen by the scan."""
        cols = getattr(self, "_hostq_cols", None)
        if cols is None:
            se = self.slot_exact
            hk, sample, sample0 = self._sample_index()
            cols = self._hostq_cols = (
                hk,
                np.ascontiguousarray(self.host_ent, np.int32),
                np.ascontiguousarray(self.host_live).view(np.uint8),
                se["live"].view(np.uint8),
                np.ascontiguousarray(se["alt_lo"], np.float32),
                np.ascontiguousarray(se["alt_hi"], np.float32),
                np.ascontiguousarray(se["t0"], np.int64),
                np.ascontiguousarray(se["t1"], np.int64),
                sample, sample0,
            )
        return cols

    def query_host(
        self, qkeys, alt_lo, alt_hi, t_start, t_end, *, now, ranges,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact small-batch query on the host postings + exact
        columns: identical results to query_fused.  `ranges` comes from
        host_candidates()."""
        B, W = qkeys.shape
        lo, hi = ranges
        n = hi - lo
        nonempty = n > 0
        lo_n, n_n = lo[nonempty], n[nonempty]
        flat_q = np.repeat(np.arange(B), W)[nonempty]
        total = int(n_n.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        offs = np.repeat(lo_n, n_n) + segmented_arange(n_n)
        slots = self.host_ent[offs]
        qidx = np.repeat(flat_q, n_n)
        se = self.slot_exact
        now_q = np.asarray(now, np.int64)
        if now_q.ndim:
            now_q = now_q[qidx]
        alt_lo = np.asarray(alt_lo, np.float32)
        alt_hi = np.asarray(alt_hi, np.float32)
        t_start = np.asarray(t_start, np.int64)
        t_end = np.asarray(t_end, np.int64)
        keep = (
            self.host_live[offs]  # per-posting build-time tombstones
            & se["live"][slots]  # per-slot post-build tombstones
            & (se["alt_hi"][slots] >= alt_lo[qidx])
            & (se["alt_lo"][slots] <= alt_hi[qidx])
            & (se["t1"][slots] >= np.maximum(t_start[qidx], now_q))
            & (se["t0"][slots] <= t_end[qidx])
        )
        return qidx[keep].astype(np.int64), slots[keep].astype(np.int64)

    # -- legacy quantized-mask path -------------------------------------------

    def _filter_words(self, win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s):
        """The reference's XLA route (_filter_xla) as torch ops on the
        table's device -> (NW, 8) i32 16-bit hit words: the quantized
        compare of each window over its block of `p3`, bit-packed by a
        matmul with `bitpack_w`, PLAIN_CHUNK windows at a time.  Every
        partial sum is a sum of distinct powers of two below 2^16, so
        the f32 product is exact; on the card this relies on full-f32
        matmuls (torch.backends.cuda.matmul.allow_tf32 at its default,
        False)."""
        q = (win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s)
        parts = [
            torch.matmul(
                window_hits(self.p3, *(a[s : s + PLAIN_CHUNK] for a in q))
                .to(torch.float32),
                self.bitpack_w,
            ).to(torch.int32)
            for s in range(0, win_blk.shape[0], PLAIN_CHUNK)
        ]
        return torch.cat(parts)

    def _legacy_inputs(self, qkeys, alt_lo, alt_hi, t_start, t_end):
        """query_batch's host expansion -> (win_q, win_blk, per-window
        device inputs padded to a pow2 bucket), or None without
        windows."""
        # expand every (query, cell) run into ALL the 128-blocks it
        # touches, so hot cells with long runs are fully covered
        win_q, win_key, win_blk, _, _ = self._expand_windows(qkeys)
        if len(win_blk) == 0:
            return None
        alo_mm = mm_floor(np.where(np.isneginf(alt_lo), -2e6, alt_lo))
        ahi_mm = mm_ceil(np.where(np.isposinf(alt_hi), 2e6, alt_hi))
        t0s = sec_floor(t_start)
        t1s = sec_ceil(t_end)
        # pad to the reference's pow2 bucket with never-matching windows
        # (key -2); the bucket is a multiple of the kernel's GROUP
        nw = len(win_blk)
        pad = pow2_bucket(nw) - nw

        def padded(a, fill):
            if pad:
                a = np.concatenate([a, np.full(pad, fill, np.int32)])
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                self.device
            )

        args = (
            padded(win_blk, 0),
            padded(win_key, -2),
            padded(alo_mm[win_q].astype(np.int32), 0),
            padded(ahi_mm[win_q].astype(np.int32), 0),
            padded(t0s[win_q].astype(np.int32), 0),
            padded(t1s[win_q].astype(np.int32), 0),
        )
        return win_q, win_blk, args

    def _legacy_filter(self, args, nw: int, use_kernel: bool) -> np.ndarray:
        """The device filter and the D2H copy of its first nw rows: the
        (nw, 128) int8 mask of B2, or the (nw, 8) words of
        _filter_words."""
        if use_kernel:
            return filter_windows(self.p3, *args)[:nw].cpu().numpy()
        return self._filter_words(*args)[:nw].cpu().numpy()

    def _legacy_pairs(self, win_q, win_blk, out, use_kernel: bool):
        """Decode the filter's output -> (qidx, offs), in window-major,
        lane-ascending order on both routes."""
        if use_kernel:
            wi, lane = np.nonzero(out)
        else:
            m = out.astype(np.uint32)  # (NW, 8) 16-bit words
            wi0, wordq = np.nonzero(m)
            vals = m[wi0, wordq]
            bitpos = np.arange(16, dtype=np.uint32)
            expanded = (vals[:, None] >> bitpos[None, :]) & 1
            e_i, e_b = np.nonzero(expanded)
            wi = wi0[e_i]
            lane = wordq[e_i] * 16 + e_b
        offs = win_blk[wi].astype(np.int64) * BLOCK + lane
        qidx = win_q[wi].astype(np.int64)
        ok = offs < self.n_postings
        return qidx[ok], offs[ok]

    def query_batch(
        self,
        qkeys: np.ndarray,  # i32[B, W] DAR keys, pad -1
        alt_lo: np.ndarray,  # f32[B] (-inf if unbounded)
        alt_hi: np.ndarray,
        t_start: np.ndarray,  # i64[B] ns (NO_TIME_LO if unbounded)
        t_end: np.ndarray,
        *,
        now: int,
        use_kernel: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (query_index i64[H], posting_offset i64[H]): the raw hit
        pairs after the conservative device filter over `p3`.  Callers
        re-check exact attributes per hit (exact_filter); `now` is not
        applied here, as in the reference.  use_kernel=True runs the B2
        kernel (filter_windows), False the reference's XLA route as
        torch ops (_filter_words); both return the same arrays."""
        prep = self._legacy_inputs(qkeys, alt_lo, alt_hi, t_start, t_end)
        if prep is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        win_q, win_blk, args = prep
        out = self._legacy_filter(args, len(win_blk), use_kernel)
        return self._legacy_pairs(win_q, win_blk, out, use_kernel)

    def exact_filter(
        self,
        qidx: np.ndarray,
        offs: np.ndarray,
        records_alt_lo: np.ndarray,  # per-SLOT exact values
        records_alt_hi: np.ndarray,
        records_t0: np.ndarray,
        records_t1: np.ndarray,
        records_live: np.ndarray,
        alt_lo: np.ndarray,
        alt_hi: np.ndarray,
        t_start: np.ndarray,
        t_end: np.ndarray,
        *,
        now,  # int scalar or i64[B] per-query request time
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Drop quantization false positives; -> (qidx, slots).  Key
        equality was already tested exactly on the device, so only the
        attribute tests and liveness against `now` are re-checked."""
        slots = self.host_ent[offs]
        now_q = np.asarray(now, np.int64)
        if now_q.ndim:
            now_q = now_q[qidx]
        keep = (
            records_live[slots]
            & (records_alt_hi[slots] >= alt_lo[qidx])
            & (records_alt_lo[slots] <= alt_hi[qidx])
            & (records_t1[slots] >= t_start[qidx])
            & (records_t0[slots] <= t_end[qidx])
            & (records_t1[slots] >= now_q)
        )
        return qidx[keep], slots[keep]

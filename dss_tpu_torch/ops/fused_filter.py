"""The fused window filter: exact 4D compare, bit-pack, compaction.

`fused_window_filter` is the one device kernel of the DAR search path.
On CUDA tensors it launches the hand-written Hopper kernel in
`dss_tpu_torch/csrc/fused_filter.cu`; on CPU tensors it runs
`fused_window_filter_torch`, the plain PyTorch version written step by
step after the reference's `dss_tpu/ops/fastpath.py:fused_window_filter`.
Both return one flat i32 tensor:

  out[0]                 = count of non-empty hit words (true count)
  out[1 : 1+max_words]   = flat word positions (window*4 + w), ascending
  out[1+max_words : ]    = u32 hit bits per word (as i32)

Inputs: exact block columns `b_alo/b_ahi` f32 (NB, 128) and
`b_t0/b_t1` i64 (NB, 128); `wins` i32 (2, NW) = [block index,
start | end<<8 | qidx<<16]; per-query bounds `q_alo/q_ahi` f32[B] and
`q_t0/q_t1` i64[B], with q_t0 pre-folded with `now` on the host
(t0_eff = max(t_start, now)).

The kernel is one launch that writes the whole output, so the wrapper
allocates it with `torch.empty`, or writes into the caller's `out`.  It
keeps a small scratch per device and stream (tile counter, epoch, tile
statuses), zeroed once when it is allocated or grown; a caller that
captures the launch into a CUDA graph (ops/resident.py) passes a
scratch of its own (`new_scratch`), since a graph replays on whatever
stream it is launched on.  The kernel is built with the other kernels of
`csrc/` by `ops/cuda_build.py` and bound once with ctypes through a
plain C function.
`exact_hits` is the per-lane exact compare, shared with B4's plain
version (`ops/fastpath_cuda.fused_filter_mask_torch`), as the CUDA
source shares its compare between B1 and B4.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dss_tpu_torch.ops import cuda_build

BLOCK = 128  # postings per block
WORDS = BLOCK // 32  # u32 hit words per window
TILE_WINDOWS = 64  # windows per tile of the kernel (csrc/fused_filter.cu)
SCRATCH_HEAD = 32  # u64 words of counter and epoch before the tile statuses
# windows per step of the plain version: bounds its (windows, 128)
# temporaries at the 131072-window bucket
PLAIN_CHUNK = 16384

_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 3
)
_fn = None  # the kernel's C entry, bound at the first launch
# (device index, stream handle) -> the kernel's u64 scratch: tile
# counter, epoch and tile statuses.  Zeroed once when allocated; each
# launch leaves it ready for the next one on the same stream.
_scratch = {}
# serving threads launch and replay at once: the counts below are
# bumped under this lock, so no increment is lost
COUNT_LOCK = threading.Lock()


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: want {dtype} with {ndim} dims, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def new_scratch(dev, n_tiles: int) -> torch.Tensor:
    """A zeroed scratch for launches over up to n_tiles tiles of
    TILE_WINDOWS windows, on one stream or in one captured graph."""
    cap = max(1024, 1 << max(n_tiles - 1, 0).bit_length())
    return torch.zeros(SCRATCH_HEAD + cap, dtype=torch.int64, device=dev)


def _scratch_for(dev, stream: int, n_tiles: int) -> torch.Tensor:
    """The launch's scratch on (dev, stream), grown to n_tiles statuses."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < SCRATCH_HEAD + n_tiles:
        buf = new_scratch(dev, n_tiles)
        _scratch[key] = buf
    return buf


def fused_window_filter(
    b_alo, b_ahi, b_t0, b_t1, wins, q_alo, q_ahi, q_t0, q_t1,
    *, max_words: int, out=None, scratch=None,
) -> torch.Tensor:
    """Exact window filter + hit bit-packing + word compaction (see
    the module docstring), into `out` when given (i32, 1 + 2*max_words).
    CUDA tensors launch the kernel (or raise), with `scratch` in place
    of the stream's own when given; CPU tensors run the plain version.
    `fused_window_filter.launches` counts the kernel's launches (a call
    under CUDA graph capture launches nothing and is not counted);
    `fused_window_filter.graph_replays` counts replays of captured
    calls (ops/resident.py)."""
    global _fn
    dev = b_alo.device
    if out is not None:
        _check(out, "out", torch.int32, 1, dev)
        if out.shape[0] != 1 + 2 * max_words:
            raise ValueError(f"out must have 1 + 2*max_words = "
                             f"{1 + 2 * max_words} elements")
    if dev.type == "cpu":
        res = fused_window_filter_torch(
            b_alo, b_ahi, b_t0, b_t1, wins, q_alo, q_ahi, q_t0, q_t1,
            max_words=max_words,
        )
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"fused_window_filter: unsupported device {dev}")
    cols = (("b_alo", b_alo, torch.float32), ("b_ahi", b_ahi, torch.float32),
            ("b_t0", b_t0, torch.int64), ("b_t1", b_t1, torch.int64))
    for name, t, dtype in cols:
        _check(t, name, dtype, 2, dev)
        if t.shape != b_alo.shape or t.shape[1] != BLOCK:
            raise ValueError(f"{name} must be (NB, {BLOCK}) like b_alo")
    _check(wins, "wins", torch.int32, 2, dev)
    for t, name, dtype in ((q_alo, "q_alo", torch.float32),
                           (q_ahi, "q_ahi", torch.float32),
                           (q_t0, "q_t0", torch.int64),
                           (q_t1, "q_t1", torch.int64)):
        _check(t, name, dtype, 1, dev)
        if t.shape != q_alo.shape:
            raise ValueError(f"{name} must have q_alo's length")
    if wins.shape[0] != 2:
        raise ValueError("wins must be (2, NW)")
    nw = int(wins.shape[1])
    if nw >= 1 << 29 or not 0 <= max_words < 1 << 30 \
            or b_alo.shape[0] >= 1 << 31 or q_alo.shape[0] >= 1 << 31:
        raise ValueError(f"unsupported nw={nw} / max_words={max_words}")
    n_tiles = -(-nw // TILE_WINDOWS)
    if scratch is not None:
        _check(scratch, "scratch", torch.int64, 1, dev)
        if scratch.shape[0] < SCRATCH_HEAD + n_tiles:
            raise ValueError(f"scratch needs {SCRATCH_HEAD + n_tiles} words")
    if _fn is None:
        _fn = cuda_build.function("dss_fused_window_filter", _ARGTYPES)
    if out is None:
        out = torch.empty(1 + 2 * max_words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if scratch is None:
            scratch = _scratch_for(dev, stream, n_tiles)
        err = _fn(
            b_alo.data_ptr(), b_ahi.data_ptr(), b_t0.data_ptr(),
            b_t1.data_ptr(), int(b_alo.shape[0]), wins.data_ptr(), nw,
            q_alo.data_ptr(), q_ahi.data_ptr(), q_t0.data_ptr(),
            q_t1.data_ptr(), int(q_alo.shape[0]), int(max_words),
            out.data_ptr(), scratch.data_ptr(), stream,
        )
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"fused_window_filter launch failed: CUDA error {err}")
    if not capturing:
        with COUNT_LOCK:
            fused_window_filter.launches += 1
    return out


fused_window_filter.launches = 0
fused_window_filter.graph_replays = 0


def _bit_weights(device) -> torch.Tensor:
    """(32,) i32: 2^i, with bit 31 as -2^31 (the i32 bit pattern)."""
    w = [1 << i for i in range(31)] + [-(1 << 31)]
    return torch.tensor(w, dtype=torch.int32, device=device)


def exact_hits(b_alo, b_ahi, b_t0, b_t1, blk, meta, alo, ahi, t0, t1):
    """The exact per-lane compare for a chunk of C windows -> (C, 128)
    bool: lanes [start, end) of block `blk` (meta = start | end<<8 in
    its low 16 bits) whose columns overlap the window's bounds
    (f32 `alo/ahi`, i64 `t0/t1`, each (C,))."""
    lanes = torch.arange(BLOCK, dtype=torch.int32, device=b_alo.device)
    start = (meta & 0xFF)[:, None]
    end = ((meta >> 8) & 0xFF)[:, None]
    return (
        (lanes[None, :] >= start)
        & (lanes[None, :] < end)
        & (b_ahi[blk] >= alo[:, None])
        & (b_alo[blk] <= ahi[:, None])
        & (b_t1[blk] >= t0[:, None])
        & (b_t0[blk] <= t1[:, None])
    )


def filter_pack_torch(
    b_alo, b_ahi, b_t0, b_t1, wins, q_alo, q_ahi, q_t0, q_t1,
) -> torch.Tensor:
    """The filter + pack stage of the plain version -> (NW, 4) i32
    words (bit i of word w = lane 32w+i), the pre-compaction words of
    the reference's fused kernel."""
    dev = b_alo.device
    win_blk = wins[0].long()
    meta = wins[1]
    win_q = (meta >> 16).long()
    weights = _bit_weights(dev)
    q = (q_alo[win_q], q_ahi[win_q], q_t0[win_q], q_t1[win_q])
    parts = []
    for s in range(0, wins.shape[1], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        hit = exact_hits(
            b_alo, b_ahi, b_t0, b_t1, win_blk[s:e], meta[s:e],
            *(a[s:e] for a in q),
        )
        # disjoint bits, so the i32 sum equals the bitwise OR and every
        # partial sum stays in range (bit 31 weighs -2^31)
        h = hit.to(torch.int32).reshape(-1, WORDS, 32) * weights
        parts.append(h.sum(dim=2, dtype=torch.int32))
    if not parts:
        return torch.zeros((0, WORDS), dtype=torch.int32, device=dev)
    return torch.cat(parts)


def fused_window_filter_torch(
    b_alo, b_ahi, b_t0, b_t1, wins, q_alo, q_ahi, q_t0, q_t1,
    *, max_words: int,
) -> torch.Tensor:
    """The plain PyTorch version, step by step after the reference's
    fused_window_filter: per-window gathers of the block columns and
    query bounds, the exact compare on lanes [start, end), the pack of
    128 lanes into 4 words (filter_pack_torch), then a cumsum + scatter
    compaction.  Runs on any device; the wrapper takes it only for CPU
    tensors."""
    dev = b_alo.device
    words = filter_pack_torch(
        b_alo, b_ahi, b_t0, b_t1, wins, q_alo, q_ahi, q_t0, q_t1,
    )
    flat = words.reshape(-1)
    nz = flat != 0
    pos = torch.cumsum(nz.to(torch.int64), 0)
    n_words = pos[-1:] if len(pos) else torch.zeros(1, dtype=torch.int64, device=dev)
    # rank >= max_words (overflow) and zero words go to the drop slot
    dst = torch.where(nz & (pos <= max_words), pos - 1, max_words)
    idx = torch.arange(flat.shape[0], dtype=torch.int32, device=dev)
    wordpos = torch.zeros(max_words + 1, dtype=torch.int32, device=dev)
    bits = torch.zeros(max_words + 1, dtype=torch.int32, device=dev)
    wordpos.scatter_(0, dst, idx)
    bits.scatter_(0, dst, flat)
    return torch.cat(
        [n_words.to(torch.int32), wordpos[:max_words], bits[:max_words]]
    )

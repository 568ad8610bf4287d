"""The window-mask kernels: B2, B3 and B4 of the reference's Pallas file.

The port of `dss_tpu/ops/fastpath_pallas.py`'s three mask entries, under
the reference's names and signatures (without `interpret`):

  filter_windows           B2, the reference's `filter_windows_pallas`:
                           the legacy path's quantized window filter
                           over the `p3` columns (NW a multiple of GROUP)
  filter_windows_gridless  B3: the same compare, NW <= 512; the
                           reference's XLA gather before it is not
                           needed, the kernel reads the blocks itself
  fused_filter_gridless    B4: the fused path's exact compare as an
                           int8 lane mask, without the pack, NW <= 512

Each returns an (NW, 128) int8 mask.  On CUDA tensors each launches its
hand-written kernel (`csrc/window_mask.cu` for B2 and B3,
`csrc/fused_filter.cu` for B4, built by `ops/cuda_build.py`; B3 has a
C entry of its own, and B4 reads only the lanes of each window's
range) or raises;
on CPU tensors it runs the plain PyTorch version beside it
(`filter_windows_torch`, `fused_filter_mask_torch`).  Each entry counts
its kernel launches in `.launches`.  The input checks are the
reference's, on either device, so the port refuses what it refuses.
"""

from __future__ import annotations

import ctypes

import torch

from dss_tpu_torch.ops import cuda_build
from dss_tpu_torch.ops.fused_filter import (
    BLOCK, PLAIN_CHUNK, _check, exact_hits,
)

GROUP = 32  # B2 takes windows in whole groups, as the reference's grid
GRIDLESS_MAX_WINDOWS = 512  # the reference's bound for B3 and B4

_WINDOW_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] + [ctypes.c_void_p] * 2
)
_MASK_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] + [ctypes.c_void_p] * 2
)


def window_hits(p3, blk, qk, qalo, qahi, qt0, qt1) -> torch.Tensor:
    """The quantized compare for a chunk of C windows -> (C, 128) bool:
    every lane of block `blk` whose key equals the window's and whose
    quantized altitude and time ranges overlap it (signed i32)."""
    win = p3[blk.long()]  # (C, 5, 128)
    return (
        (win[:, 0, :] == qk[:, None])
        & (win[:, 2, :] >= qalo[:, None])
        & (win[:, 1, :] <= qahi[:, None])
        & (win[:, 4, :] >= qt0[:, None])
        & (win[:, 3, :] <= qt1[:, None])
    )


def filter_windows_torch(p3, win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s):
    """B2's and B3's plain version: gather each window's block of `p3`
    and compare, PLAIN_CHUNK windows at a time -> (NW, 128) int8."""
    q = (win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s)
    parts = [
        window_hits(p3, *(a[s : s + PLAIN_CHUNK] for a in q)).to(torch.int8)
        for s in range(0, win_blk.shape[0], PLAIN_CHUNK)
    ]
    if not parts:
        return torch.zeros((0, BLOCK), dtype=torch.int8, device=p3.device)
    return torch.cat(parts)


def fused_filter_mask_torch(
    b_alo, b_ahi, b_t0, b_t1, win_blk, meta, alo_w, ahi_w, t0_w, t1_w,
):
    """B4's plain version: the exact compare of the fused path's plain
    filter (`fused_filter.exact_hits`) with per-window bounds, PLAIN_CHUNK
    windows at a time -> (NW, 128) int8."""
    q = (win_blk.long(), meta, alo_w, ahi_w, t0_w, t1_w)
    parts = [
        exact_hits(b_alo, b_ahi, b_t0, b_t1,
                   *(a[s : s + PLAIN_CHUNK] for a in q)).to(torch.int8)
        for s in range(0, win_blk.shape[0], PLAIN_CHUNK)
    ]
    if not parts:
        return torch.zeros((0, BLOCK), dtype=torch.int8, device=b_alo.device)
    return torch.cat(parts)


def _check_vectors(named, nw, dtype_of, dev) -> None:
    for name, t in named:
        _check(t, name, dtype_of[name], 1, dev)
        if t.shape[0] != nw:
            raise ValueError(f"{name} has {t.shape[0]} windows, want {nw}")


def _check_aligned(named) -> None:
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel")


def _window_mask(entry, c_name, p3, win_blk, qk, qalo_mm, qahi_mm, qt0s,
                 qt1s):
    """B2/B3 body: the plain version for CPU tensors, else the kernel
    behind C entry `c_name` (counted on `entry`)."""
    dev = p3.device
    if dev.type == "cpu":
        return filter_windows_torch(
            p3, win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s
        )
    if dev.type != "cuda":
        raise ValueError(f"{entry.__name__}: unsupported device {dev}")
    _check(p3, "p3", torch.int32, 3, dev)
    if tuple(p3.shape[1:]) != (5, BLOCK) or p3.shape[0] >= 1 << 31:
        raise ValueError(f"p3 must be (NB, 5, {BLOCK}), got {tuple(p3.shape)}")
    _check_aligned([("p3", p3)])
    nw = int(win_blk.shape[0])
    vecs = (win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s)
    names = ("win_blk", "qk", "qalo_mm", "qahi_mm", "qt0s", "qt1s")
    _check_vectors(zip(names, vecs), nw,
                   dict.fromkeys(names, torch.int32), dev)
    mask = torch.empty((nw, BLOCK), dtype=torch.int8, device=dev)
    if nw == 0:
        return mask
    fn = cuda_build.function(c_name, _WINDOW_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p3.data_ptr(), int(p3.shape[0]),
                 *(v.data_ptr() for v in vecs), nw, mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"{entry.__name__} launch failed: CUDA error {err}"
        )
    entry.launches += 1
    return mask


def filter_windows(p3, win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s):
    """B2: `p3` i32 (NB, 5, 128); per window i32 (NW,) block index,
    key (negative never matches) and quantized bounds; NW a multiple of
    GROUP -> per-lane hit mask (NW, 128) int8."""
    nw = win_blk.shape[0]
    if nw % GROUP:
        raise ValueError(f"NW must be padded to a multiple of {GROUP}, got {nw}")
    return _window_mask(
        filter_windows, "dss_filter_windows", p3, win_blk, qk, qalo_mm,
        qahi_mm, qt0s, qt1s,
    )


def filter_windows_gridless(p3, win_blk, qk, qalo_mm, qahi_mm, qt0s, qt1s):
    """B3: filter_windows' compare for NW <= GRIDLESS_MAX_WINDOWS
    windows, any NW -> (NW, 128) int8, equal to the reference's
    filter_windows_gridless bit for bit."""
    nw = win_blk.shape[0]
    if nw > GRIDLESS_MAX_WINDOWS:
        raise ValueError(
            f"gridless entry takes at most {GRIDLESS_MAX_WINDOWS} windows, "
            f"got {nw}"
        )
    return _window_mask(
        filter_windows_gridless, "dss_filter_windows_gridless", p3, win_blk,
        qk, qalo_mm, qahi_mm, qt0s, qt1s,
    )


def fused_filter_gridless(
    b_alo, b_ahi, b_t0, b_t1, win_blk, meta, alo_w, ahi_w, t0_w, t1_w,
):
    """B4: exact block columns (f32 `b_alo/b_ahi`, i64 `b_t0/b_t1`,
    each (NB, 128)); per window i32 block index and meta = start |
    end<<8, f32 alo/ahi and i64 t0 (pre-folded with now) / t1;
    NW <= GRIDLESS_MAX_WINDOWS -> the exact hit mask (NW, 128) int8."""
    nw = int(win_blk.shape[0])
    if nw > GRIDLESS_MAX_WINDOWS:
        raise ValueError(
            f"gridless entry takes at most {GRIDLESS_MAX_WINDOWS} windows, "
            f"got {nw}"
        )
    dev = b_alo.device
    args = (b_alo, b_ahi, b_t0, b_t1, win_blk, meta, alo_w, ahi_w, t0_w, t1_w)
    if dev.type == "cpu":
        return fused_filter_mask_torch(*args)
    if dev.type != "cuda":
        raise ValueError(f"fused_filter_gridless: unsupported device {dev}")
    cols = (("b_alo", b_alo, torch.float32), ("b_ahi", b_ahi, torch.float32),
            ("b_t0", b_t0, torch.int64), ("b_t1", b_t1, torch.int64))
    for name, t, dtype in cols:
        _check(t, name, dtype, 2, dev)
        if t.shape != b_alo.shape or t.shape[1] != BLOCK:
            raise ValueError(f"{name} must be (NB, {BLOCK}) like b_alo")
    if b_alo.shape[0] >= 1 << 31:
        raise ValueError("too many blocks for the kernel")
    _check_aligned((name, t) for name, t, _ in cols)
    vecs = args[4:]
    names = ("win_blk", "meta", "alo_w", "ahi_w", "t0_w", "t1_w")
    dtypes = dict(zip(names, (torch.int32, torch.int32, torch.float32,
                              torch.float32, torch.int64, torch.int64)))
    _check_vectors(zip(names, vecs), nw, dtypes, dev)
    mask = torch.empty((nw, BLOCK), dtype=torch.int8, device=dev)
    if nw == 0:
        return mask
    fn = cuda_build.function("dss_fused_filter_mask", _MASK_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for _, t, _ in cols), int(b_alo.shape[0]),
                 *(v.data_ptr() for v in vecs), nw, mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_filter_gridless launch failed: CUDA error {err}"
        )
    fused_filter_gridless.launches += 1
    return mask


filter_windows.launches = 0
filter_windows_gridless.launches = 0
fused_filter_gridless.launches = 0

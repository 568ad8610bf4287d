"""Native (C++) host halves of the port: the work around the device.

The port's copy of the reference's `dss_tpu/native` (same C entries,
same Python API).  The device compute path is CUDA (dss_tpu_torch/csrc);
these cover the host work around it, each mirroring its numpy version
operation-for-operation so results are bit-identical (pinned
differentially by tests/test_torch_native.py, against both the port's
numpy paths and the reference):

- covering.cc — the level-13 covering fast path (request shaping)
- hostquery.cc — the exact small-batch serving query over the sorted
  postings + slot columns (no device round trip)
- fastwin.cc — the fused device pipeline's window pack + hit decode,
  plus the shared sampled two-level range lookup both query paths ride

The shared library is built with g++ from the sources in this package
into `build/native/` beside it (_buildlib: content digest, file lock,
atomic renames), synchronously by ensure_built() or on a background
thread started at first import.  Where the toolchain or the build is
unavailable the callers take the numpy paths: behavior never changes,
only speed.  The ctypes calls release the GIL; every array they are
handed is referenced by the wrapper until the call returns.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from dss_tpu_torch.native import _buildlib

SO_PATH = os.path.join(_buildlib.BUILD_DIR, _buildlib.SO_NAME)

_load_lock = threading.Lock()   # guards _lib / _load_failed + dlopen
_build_lock = threading.Lock()  # serializes g++ runs (never held with
#                                 _load_lock, so available() can't
#                                 block behind a compile)
_lib = None
_load_failed = False


def _try_load() -> Optional[ctypes.CDLL]:
    """dlopen the .so if fresh on disk.  Fast; never compiles."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _load_lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _buildlib.so_fresh():
            return None
        try:
            lib = ctypes.CDLL(SO_PATH)
            lib.dss_loop_covering.restype = ctypes.c_int64
            lib.dss_loop_covering.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64,
            ]
            lib.dss_points_covering.restype = ctypes.c_int64
            lib.dss_points_covering.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64,
            ]
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.dss_query_host.restype = ctypes.c_int64
            lib.dss_query_host.argtypes = [
                i32p, i32p, u8p, ctypes.c_int64,          # postings
                u8p, f32p, f32p, i64p, i64p,              # slot columns
                i32p, ctypes.c_int32, ctypes.c_int32,     # qkeys, B, W
                f32p, f32p, i64p, i64p, i64p,             # query bounds
                i32p, ctypes.c_int64, ctypes.c_int64,     # sample index
                i32p, ctypes.c_int64,                     # top-level sample
                i64p, i64p,                               # range scratch
                ctypes.c_int64,                           # max_candidates
                i64p, i32p, ctypes.c_int64,               # out buffers
            ]
            lib.dss_win_ranges.restype = ctypes.c_int64
            lib.dss_win_ranges.argtypes = [
                i32p, ctypes.c_int64,                     # host_key
                i32p, ctypes.c_int64, ctypes.c_int64,     # sample index
                i32p, ctypes.c_int64,                     # top-level sample
                i32p, ctypes.c_int64, ctypes.c_int64,     # qkeys, n, block
                i64p, i64p,                               # lo/hi scratch
            ]
            lib.dss_win_expand.restype = ctypes.c_int64
            lib.dss_win_expand.argtypes = [
                i64p, i64p, ctypes.c_int64,               # lo, hi, n
                ctypes.c_int32, ctypes.c_int64,           # w, block
                i32p, i32p,                               # wins rows
                i32p, i32p, ctypes.c_int64,               # win_q/blk, cap
            ]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.dss_hit_total.restype = ctypes.c_int64
            lib.dss_hit_total.argtypes = [u32p, ctypes.c_int64]
            lib.dss_decode_hits.restype = ctypes.c_int64
            lib.dss_decode_hits.argtypes = [
                i32p, u32p, ctypes.c_int64,               # wordpos, bits
                i32p, i32p,                               # win_q, win_blk
                ctypes.c_int64, ctypes.c_int64,           # shift, block
                i32p, ctypes.c_int64,                     # host_ent, P
                u8p,                                      # slot_live
                i64p, i64p, ctypes.c_int64,               # out, cap
            ]
            _lib = lib
        except (OSError, AttributeError):
            # OSError: dlopen failure.  AttributeError: a library
            # missing a symbol — latch the numpy fallback instead of
            # re-raising on every request.
            _load_failed = True
        return _lib


def ensure_built() -> bool:
    """Build (if needed) and load synchronously.  Call at startup or
    from tests; the request path never compiles."""
    global _load_failed
    if _try_load() is not None:
        return True
    with _build_lock:
        if _try_load() is not None:
            return True
        if not _buildlib.so_fresh() and not _buildlib.build():
            # build failure does NOT latch: a sibling process's build
            # producing a fresh library is picked up by the next
            # _try_load stat.  Only dlopen of a fresh
            # .so latches _load_failed.
            return False
    return _try_load() is not None


def available() -> bool:
    """True if the kernel is loaded (or the .so is fresh on disk and
    loads instantly).  Never triggers a compile: a covering request
    must not stall behind a multi-second g++ run — the background
    build started at import flips this True when done."""
    return _try_load() is not None


# Kick the build off-thread at import: server processes get the library
# a few seconds after boot without ever blocking a request on g++.
if not _buildlib.so_fresh():
    threading.Thread(
        target=ensure_built, name="dss-native-build", daemon=True
    ).start()


class CoveringTooLarge(Exception):
    """Native covering exceeded the max cell count (AreaTooLarge)."""


_OUT_CAP = 100_001
_tls = threading.local()


def _out_buf() -> np.ndarray:
    """Reusable per-thread output buffer: allocating 800 KB per call
    costs more than the kernel itself."""
    buf = getattr(_tls, "buf", None)
    if buf is None:
        buf = _tls.buf = np.empty(_OUT_CAP, dtype=np.uint64)
    return buf


def _ptr(a, ct):
    """ctypes pointer to a contiguous ndarray's buffer."""
    return a.ctypes.data_as(ctypes.POINTER(ct))


def loop_covering(v_xyz: np.ndarray, area_ok: bool) -> Optional[np.ndarray]:
    """Native single-face rect covering of the loop.

    Returns the sorted uint64 cell array, None when the caller must
    take the Python BFS fallback (multi-face / face-edge / oversized
    rect / area gate failed / native unavailable), or raises
    CoveringTooLarge.
    """
    lib = _try_load()
    if lib is None:
        return None
    v = np.ascontiguousarray(v_xyz, dtype=np.float64)
    out = _out_buf()
    rc = lib.dss_loop_covering(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(len(v)),
        np.int32(1 if area_ok else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int64(_OUT_CAP),
    )
    if rc == -2:
        raise CoveringTooLarge("covering exceeds maximum cell count")
    if rc < 0:
        return None
    return out[:rc].copy()


class AreaTooLarge(Exception):
    """Loop exceeds the area gate even after the winding retry; .area
    carries the computed km² for the error message."""

    def __init__(self, area: float):
        super().__init__(f"area is too large ({area:f}km²)")
        self.area = area


class Degenerate(Exception):
    """Zero/negative area: the caller takes the polyline path."""


def points_covering(v_xyz: np.ndarray, max_area_km2: float):
    """covering_from_loop_points fast path: winding retry + area gate +
    rect covering in one native call.  The area gate threshold comes
    from the caller (covering.MAX_AREA_KM2 — single source of truth).
    Returns the sorted uint64 cells, or None when the caller must run
    the full Python path; raises AreaTooLarge / Degenerate /
    CoveringTooLarge per the gate results.
    """
    lib = _try_load()
    if lib is None:
        return None
    v = np.ascontiguousarray(v_xyz, dtype=np.float64)
    out = _out_buf()
    area = ctypes.c_double(0.0)
    rc = lib.dss_points_covering(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(len(v)),
        ctypes.c_double(max_area_km2),
        ctypes.byref(area),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int64(_OUT_CAP),
    )
    if rc == -1:
        raise Degenerate()
    if rc == -2:
        if area.value > max_area_km2:
            raise AreaTooLarge(area.value)
        raise CoveringTooLarge("covering exceeds maximum cell count")
    if rc < 0:
        return None
    return out[:rc].copy()


def query_host(
    host_key, host_ent, host_live,
    slot_live, slot_alo, slot_ahi, slot_t0, slot_t1,
    qkeys, q_alo, q_ahi, q_t0, q_t1, q_now,
    max_candidates: int,
    *, sample=None, sample0=None, stride: int = 64,
):
    """Native exact host query -> (qidx i64[N], slot i32[N]), or None
    when the lib is unavailable or the candidate total says device
    path.  Inputs must be contiguous arrays of the fastpath dtypes.
    sample / sample0 (optional, see pack_windows) route the range
    lookups through the cached two-level index instead of flat binary
    searches: the serving-path lookups share the fused path's index."""
    lib = _try_load()
    if lib is None:
        return None
    b, w = qkeys.shape
    cap = int(max_candidates)
    # reusable per-thread output + range-scratch buffers (same
    # rationale as _out_buf: a fresh allocation per call would cost
    # more than the scan)
    bufs = getattr(_tls, "hq", None)
    if bufs is None or len(bufs[0]) < cap:
        bufs = _tls.hq = (
            np.empty(cap, np.int64), np.empty(cap, np.int32)
        )
    out_q, out_s = bufs
    n = b * w
    scratch = getattr(_tls, "hqr", None)
    if scratch is None or len(scratch[0]) < n:
        scratch = _tls.hqr = (np.empty(n, np.int64), np.empty(n, np.int64))
    lo, hi = scratch
    if sample is None:
        sample = np.zeros(0, np.int32)
    if sample0 is None:
        sample0 = np.zeros(0, np.int32)

    rc = lib.dss_query_host(
        _ptr(host_key, ctypes.c_int32), _ptr(host_ent, ctypes.c_int32),
        _ptr(host_live, ctypes.c_uint8), np.int64(len(host_key)),
        _ptr(slot_live, ctypes.c_uint8), _ptr(slot_alo, ctypes.c_float),
        _ptr(slot_ahi, ctypes.c_float), _ptr(slot_t0, ctypes.c_int64),
        _ptr(slot_t1, ctypes.c_int64),
        _ptr(qkeys, ctypes.c_int32), np.int32(b), np.int32(w),
        _ptr(q_alo, ctypes.c_float), _ptr(q_ahi, ctypes.c_float),
        _ptr(q_t0, ctypes.c_int64), _ptr(q_t1, ctypes.c_int64),
        _ptr(q_now, ctypes.c_int64),
        _ptr(sample, ctypes.c_int32), np.int64(len(sample)),
        np.int64(stride),
        _ptr(sample0, ctypes.c_int32), np.int64(len(sample0)),
        _ptr(lo, ctypes.c_int64), _ptr(hi, ctypes.c_int64),
        np.int64(max_candidates),
        _ptr(out_q, ctypes.c_int64), _ptr(out_s, ctypes.c_int32),
        np.int64(cap),
    )
    if rc < 0:
        return None
    return out_q[:rc].copy(), out_s[:rc].copy()


def pack_windows(
    host_key, qk_flat, w: int, block: int, pow2_bucket,
    sample=None, stride: int = 64, sample0=None,
):
    """Native FastTable._pack_windows: postings-range binary searches +
    window expansion + meta packing in two GIL-released calls (the
    port's times are in PERF.md, from chip_smoke.py).  Returns
    (wins, win_q, win_blk, nw) with bit-identical contents to the
    numpy path, or None when the lib is unavailable.  qk_flat must be
    contiguous i32; wins pad rows are zero exactly like the numpy
    path (start == end == 0 -> no lanes match).  sample (optional) is
    the caller-cached host_key[::stride] copy that keeps the search's
    top levels L2-resident; sample0 (optional, requires sample) must
    be sample[::64] — the L1-resident top level (derived on the fly
    when absent)."""
    lib = _try_load()
    if lib is None:
        return None
    n = len(qk_flat)
    scratch = getattr(_tls, "winr", None)
    if scratch is None or len(scratch[0]) < n:
        scratch = _tls.winr = (np.empty(n, np.int64), np.empty(n, np.int64))
    lo, hi = scratch

    if sample is None:
        sample = np.zeros(0, np.int32)
    if sample0 is None:
        sample0 = np.zeros(0, np.int32)
    nw = lib.dss_win_ranges(
        _ptr(host_key, ctypes.c_int32), np.int64(len(host_key)),
        _ptr(sample, ctypes.c_int32), np.int64(len(sample)),
        np.int64(stride),
        _ptr(sample0, ctypes.c_int32), np.int64(len(sample0)),
        _ptr(qk_flat, ctypes.c_int32), np.int64(n), np.int64(block),
        _ptr(lo, ctypes.c_int64), _ptr(hi, ctypes.c_int64),
    )
    if nw == 0:
        empty = np.zeros(0, np.int32)
        return None, empty, empty, 0
    bucket = pow2_bucket(int(nw))
    wins = np.zeros((2, bucket), np.int32)
    win_q = np.empty(nw, np.int32)
    win_blk = np.empty(nw, np.int32)
    rc = lib.dss_win_expand(
        _ptr(lo, ctypes.c_int64), _ptr(hi, ctypes.c_int64), np.int64(n),
        np.int32(w), np.int64(block),
        _ptr(wins[0], ctypes.c_int32), _ptr(wins[1], ctypes.c_int32),
        _ptr(win_q, ctypes.c_int32), _ptr(win_blk, ctypes.c_int32),
        np.int64(nw),
    )
    if rc != nw:  # pragma: no cover — count/expand disagreement
        return None
    return wins, win_q, win_blk, int(nw)


def decode_hits(
    wordpos, bits_u32, win_q, win_blk,
    words_shift: int, block: int,
    host_ent, n_postings: int, slot_live_u8,
):
    """Native hit-word decode for FastTable.collect: popcount total +
    ctz expansion + pad/tombstone filtering in two GIL-released calls.
    Output pairs are in the numpy path's exact order.  Returns (qidx i64[H], slots i64[H]) or None when the
    lib is unavailable.  All array args must be contiguous."""
    lib = _try_load()
    if lib is None:
        return None
    n_words = len(wordpos)

    total = lib.dss_hit_total(
        _ptr(bits_u32, ctypes.c_uint32), np.int64(n_words)
    )
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    out_q = np.empty(total, np.int64)
    out_s = np.empty(total, np.int64)
    rc = lib.dss_decode_hits(
        _ptr(wordpos, ctypes.c_int32), _ptr(bits_u32, ctypes.c_uint32),
        np.int64(n_words),
        _ptr(win_q, ctypes.c_int32), _ptr(win_blk, ctypes.c_int32),
        np.int64(words_shift), np.int64(block),
        _ptr(host_ent, ctypes.c_int32), np.int64(n_postings),
        _ptr(slot_live_u8, ctypes.c_uint8),
        _ptr(out_q, ctypes.c_int64), _ptr(out_s, ctypes.c_int64),
        np.int64(total),
    )
    if rc < 0:  # pragma: no cover — cap is popcount-exact
        return None
    return out_q[:rc], out_s[:rc]

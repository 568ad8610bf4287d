// Quantized window filter: one int8 hit-mask row of 128 lanes per window.
//
// Replaces, in the reference package:
//   dss_tpu/ops/fastpath_pallas.py:_kernel (via filter_windows_pallas), B2:
//     the legacy path's window filter over the quantized p3 columns
//     (filter_windows, below);
//   dss_tpu/ops/fastpath_pallas.py:_gridless_kernel (via
//     filter_windows_gridless), B3: the same compare over windows that
//     XLA gathered first (jnp.take), at most 512 windows.  The gather
//     existed only because the TPU's compile service refused scalar
//     prefetch; here B3 reads p3 and the block indices directly, with no
//     gather (dss_filter_windows_gridless, below).
// For window w on block b = win_blk[w], lane l of the mask is
//   p3[b,0,l] == qk[w] && p3[b,2,l] >= qalo[w] && p3[b,1,l] <= qahi[w] &&
//   p3[b,4,l] >= qt0[w] && p3[b,3,l] <= qt1[w]
// in signed i32, on all 128 lanes (a legacy window has no lane range).
// Rows of p3 are key, alt_lo mm-floor, alt_hi mm-ceil, t0 s-floor, t1
// s-ceil.  Dead postings carry t1 = INT32_MIN and pad lanes INT32_MAX in
// all rows, so neither matches a real window; pad windows (key -2) and
// -1 pad keys match no posting, since table keys are non-negative.
//
// Bound: memory.  The least traffic is 2,560 B of p3 for each distinct
// block in the batch, plus 24 B of window scalars and 128 B of mask for
// each window of the bucket.  At the 1M-intent headline batch (about 85k
// windows in a 131,072 bucket, at most 62,504 blocks) that is at most
// about 180 MB, or about 0.05 ms at 3.35 TB/s on an H100 SXM;
// chip_smoke.py computes it from each run's distinct blocks.
//
// B2's design (simple first): one warp per window, 8 windows per CTA.
// Thread t reads lanes 4t..4t+3 of each of the five rows as one 16 B
// load, so each row is one coalesced 512 B read, and writes its 4 mask
// bytes as one 32-bit store, so a window's 128 B mask row is one
// coalesced store.  Windows that share a block read it again (from L2
// when it is hot).
//
// B3's design: B2's kernel, launched through B3's own entry
// (dss_filter_windows_gridless), so B2 and B3 share one compare.  At
// <= 512 windows B3's bound (about 0.5 MB at the headline, 0.16 us) is
// a tenth of one launch's fixed cost, so what a design can win is
// latency.  Three others were timed against this one in turns on the
// card (PERF.md has the times) and lost: one wave over every SM (4
// windows a CTA at 512 windows, about 2 % slower); the CTA's block
// indices and scalars loaded in one coalesced pass into shared memory
// before any row load (about 30 % slower); and with that, each distinct
// block of a CTA staged once by a 1D bulk copy on an mbarrier (about
// 65 % slower).  Each kernel is two dependent round trips and a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // lanes per block
constexpr int kRows = 5;     // p3 rows per block
constexpr int kWarps = 8;    // windows per CTA

// A window whose block index lies outside [0, nb) matches nothing (the
// reference leaves such an index undefined; here it must not read out
// of range).
__global__ void filter_windows(const int32_t* __restrict__ p3, int nb,
                               const int32_t* __restrict__ win_blk,
                               const int32_t* __restrict__ qk,
                               const int32_t* __restrict__ qalo,
                               const int32_t* __restrict__ qahi,
                               const int32_t* __restrict__ qt0,
                               const int32_t* __restrict__ qt1, int nw,
                               uint32_t* __restrict__ mask) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= nw) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t blk = win_blk[w];
  uint32_t packed = 0;  // byte k = lane 4*lane+k, little-endian
  if (blk >= 0 && blk < nb) {
    const int4* rows = reinterpret_cast<const int4*>(
                           p3 + static_cast<int64_t>(blk) * kRows * kBlock) +
                       lane;
    constexpr int kRow = kBlock / 4;  // int4s per row
    const int4 key = rows[0];
    const int4 alo = rows[kRow];
    const int4 ahi = rows[2 * kRow];
    const int4 t0 = rows[3 * kRow];
    const int4 t1 = rows[4 * kRow];
    const int32_t p_key[4] = {key.x, key.y, key.z, key.w};
    const int32_t p_alo[4] = {alo.x, alo.y, alo.z, alo.w};
    const int32_t p_ahi[4] = {ahi.x, ahi.y, ahi.z, ahi.w};
    const int32_t p_t0[4] = {t0.x, t0.y, t0.z, t0.w};
    const int32_t p_t1[4] = {t1.x, t1.y, t1.z, t1.w};
    const int32_t q_key = qk[w];
    const int32_t q_alo = qalo[w];
    const int32_t q_ahi = qahi[w];
    const int32_t q_t0 = qt0[w];
    const int32_t q_t1 = qt1[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool hit = p_key[k] == q_key && p_ahi[k] >= q_alo &&
                       p_alo[k] <= q_ahi && p_t1[k] >= q_t0 &&
                       p_t0[k] <= q_t1;
      packed |= static_cast<uint32_t>(hit) << (8 * k);
    }
  }
  mask[static_cast<int64_t>(w) * (kBlock / 4) + lane] = packed;
}

}  // namespace

// Launches filter_windows on `stream` and returns cudaGetLastError().
// p3 is i32 (nb, 5, 128), 16 B aligned; the six per-window arrays are
// i32 (nw,); mask is int8 (nw, 128).  B2's entry; B3's calls it.
extern "C" int dss_filter_windows(const void* p3, int nb, const void* win_blk,
                                  const void* qk, const void* qalo,
                                  const void* qahi, const void* qt0,
                                  const void* qt1, int nw, void* mask,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nw <= 0) return static_cast<int>(cudaGetLastError());
  filter_windows<<<(nw + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const int32_t*>(p3), nb,
      static_cast<const int32_t*>(win_blk), static_cast<const int32_t*>(qk),
      static_cast<const int32_t*>(qalo), static_cast<const int32_t*>(qahi),
      static_cast<const int32_t*>(qt0), static_cast<const int32_t*>(qt1), nw,
      static_cast<uint32_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// B3: launches filter_windows on `stream` and returns
// cudaGetLastError(); the arguments are dss_filter_windows' (any nw,
// the wrapper caps it at 512).
extern "C" int dss_filter_windows_gridless(const void* p3, int nb,
                                           const void* win_blk,
                                           const void* qk, const void* qalo,
                                           const void* qahi, const void* qt0,
                                           const void* qt1, int nw,
                                           void* mask, void* stream) {
  return dss_filter_windows(p3, nb, win_blk, qk, qalo, qahi, qt0, qt1, nw,
                            mask, stream);
}

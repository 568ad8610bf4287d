// Fused exact window filter + hit bit-pack + ordered word compaction (B1),
// and the same exact filter as an int8 lane mask (B4).
//
// B1 replaces, in the reference package:
//   dss_tpu/ops/fastpath_pallas.py:_fused_kernel (via
//     fused_filter_pack_pallas) — the per-window exact 4D compare and
//     the pack of 128 hit lanes into 4 u32 words;
//   dss_tpu/ops/fastpath.py:fused_window_filter — the XLA around it:
//     the per-query bound gather by qidx = meta >> 16 and the
//     cumsum + scatter compaction of the non-empty words.
// It computes fused_window_filter's whole flat i32 output, bit for bit:
//   out[0]                   = count of non-empty words (the TRUE count,
//                              even when it exceeds max_words)
//   out[1 : 1+max_words]     = flat word positions (window*4 + w), ascending
//   out[1+max_words : ]      = the words' raw u32 bits
// Writes at rank >= max_words are dropped; the caller passes `out`
// zeroed, so the tail of both halves stays zero as in the XLA scatter.
//
// Bound: memory.  Each window reads up to 128 lanes x (4 B b_alo +
// 4 B b_ahi + 8 B b_t0 + 8 B b_t1) = 3,072 B of block columns and does a
// handful of compares per lane, so the least time is the bytes over the
// card's memory rate: at most NW x 3,072 B / 3.35 TB/s, about 0.12 ms
// for the 131072-window bucket on an H100 SXM.  This kernel reads only
// the lanes of [start, end), so the bytes it needs are the run's lanes,
// not the full block.
//
// Design (simple first; no TMA, no persistent blocks):
//   1. filter_pack: one warp per window, 8 warps and 32 windows per
//      CTA.  Lane i tests lanes i, 32+i, 64+i, 96+i of the block, so
//      each column read is one coalesced 128 B / 256 B row segment;
//      __ballot_sync gives each packed word directly (bit i of word w =
//      lane 32w+i, bit 31 included).  Each CTA writes its 128 words and
//      its count of non-zero words.
//   2. scan_counts: one CTA scans the per-CTA counts into exclusive
//      offsets and writes the total to out[0].
//   3. scatter: one CTA per 128-word chunk ranks its non-zero words
//      (ballot/popc within a warp, shared-memory sums across warps)
//      and scatters position + bits.  Ranks, not atomics, keep the word
//      positions ascending, which the host decode relies on.
// Pad windows (blk 0, meta 0) have start == end == 0 and match no lane.
//
// B4 replaces dss_tpu/ops/fastpath_pallas.py:_gridless_exact_kernel (via
// fused_filter_gridless): the same exact compare per lane, no pack, one
// int8 mask row per window, with the window's bounds given per window
// (no qidx).  The TPU splits each i64 time into i32 hi/lo' planes
// (_split_i64) because its compiler refused i64 vectors; Hopper compares
// i64 natively, which orders every pair of i64 values as the split-plane
// identity does.  B1 and B4 call one compare, exact_hit, so the two
// cannot drift apart.
//   Bound: memory.  At most 3,072 B of block columns per window (24 B per
//   lane), 32 B of window scalars and 128 B of mask; for the <= 512
//   windows the reference allows, about 1.6 MB, or about 0.5 us at
//   3.35 TB/s on an H100 SXM.  chip_smoke.py counts the distinct lanes
//   of [start, end) that a run's windows need.
//   Design: one warp per window, 8 per CTA.  Thread t loads lanes
//   4t..4t+3 of each column as 16 B vectors (32 B for the i64 columns),
//   so each column row is one coalesced read, and writes its 4 mask
//   bytes as one 32-bit store, so a window's 128 B row is one coalesced
//   store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;                       // postings per block
constexpr int kWords = kBlock / 32;               // u32 words per window
constexpr int kWarps = 8;                         // filter CTA: 256 threads
constexpr int kWinPerCta = 32;                    // windows per chunk
constexpr int kChunkWords = kWinPerCta * kWords;  // 128 words per chunk
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The exact 4D compare of one posting lane with one window's bounds.
__device__ __forceinline__ bool exact_hit(float p_alo, float p_ahi,
                                          int64_t p_t0, int64_t p_t1,
                                          float q_alo, float q_ahi,
                                          int64_t q_t0, int64_t q_t1) {
  return p_ahi >= q_alo && p_alo <= q_ahi && p_t1 >= q_t0 && p_t0 <= q_t1;
}

__global__ void filter_pack(const float* __restrict__ b_alo,
                            const float* __restrict__ b_ahi,
                            const int64_t* __restrict__ b_t0,
                            const int64_t* __restrict__ b_t1,
                            const int32_t* __restrict__ win_blk,
                            const int32_t* __restrict__ win_meta,
                            const float* __restrict__ q_alo,
                            const float* __restrict__ q_ahi,
                            const int64_t* __restrict__ q_t0,
                            const int64_t* __restrict__ q_t1, int nw,
                            uint32_t* __restrict__ words,
                            int32_t* __restrict__ chunk_count) {
  __shared__ int warp_nz[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int nz = 0;
  for (int k = warp; k < kWinPerCta; k += kWarps) {
    const int w = blockIdx.x * kWinPerCta + k;
    if (w >= nw) break;  // uniform across the warp
    const int32_t meta = win_meta[w];
    const int start = meta & 0xFF;
    const int end = (meta >> 8) & 0xFF;
    const int q = meta >> 16;
    const float alo = q_alo[q];
    const float ahi = q_ahi[q];
    const int64_t t0 = q_t0[q];
    const int64_t t1 = q_t1[q];
    const int64_t base = static_cast<int64_t>(win_blk[w]) * kBlock;
    uint32_t mine = 0;  // lane j < 4 keeps word j
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int l = j * 32 + lane;
      bool hit = false;
      if (l >= start && l < end) {
        const int64_t i = base + l;
        hit = exact_hit(b_alo[i], b_ahi[i], b_t0[i], b_t1[i], alo, ahi, t0,
                        t1);
      }
      const uint32_t bits = __ballot_sync(kFull, hit);
      if (lane == j) mine = bits;
    }
    if (lane < kWords) words[static_cast<int64_t>(w) * kWords + lane] = mine;
    nz += __popc(__ballot_sync(kFull, lane < kWords && mine != 0u));
  }
  if (lane == 0) warp_nz[warp] = nz;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < kWarps; ++i) s += warp_nz[i];
    chunk_count[blockIdx.x] = s;
  }
}

// Inclusive scan of one value per thread across a 1024-thread CTA.
__device__ int cta_inclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];  // 32 warps in a 1024-thread CTA
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  return x + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void scan_counts(const int32_t* __restrict__ counts, int n,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += counts[i];
  int run = cta_inclusive_scan(local, warp_sums) - local;  // exclusive
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == kScanThreads - 1) *total = run;  // the true count
}

__global__ void scatter(const uint32_t* __restrict__ words, int n_words,
                        const int32_t* __restrict__ offsets, int max_words,
                        int32_t* __restrict__ out) {
  __shared__ int warp_tot[kChunkWords / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * kChunkWords + threadIdx.x;
  const uint32_t w = idx < n_words ? words[idx] : 0u;
  const uint32_t ball = __ballot_sync(kFull, w != 0u);
  if (lane == 0) warp_tot[warp] = __popc(ball);
  __syncthreads();
  if (w == 0u) return;
  int rank = offsets[blockIdx.x] + __popc(ball & ((1u << lane) - 1u));
  for (int i = 0; i < warp; ++i) rank += warp_tot[i];
  if (rank < max_words) {
    out[1 + rank] = idx;
    out[1 + max_words + rank] = static_cast<int32_t>(w);  // raw bits
  }
}

// B4: one warp per window; thread t owns lanes 4t..4t+3.  A window
// whose block index lies outside [0, nb) matches nothing (the reference
// leaves such an index undefined; here it must not read out of range).
__global__ void fused_filter_mask(const float* __restrict__ b_alo,
                                  const float* __restrict__ b_ahi,
                                  const int64_t* __restrict__ b_t0,
                                  const int64_t* __restrict__ b_t1, int nb,
                                  const int32_t* __restrict__ win_blk,
                                  const int32_t* __restrict__ win_meta,
                                  const float* __restrict__ w_alo,
                                  const float* __restrict__ w_ahi,
                                  const int64_t* __restrict__ w_t0,
                                  const int64_t* __restrict__ w_t1, int nw,
                                  uint32_t* __restrict__ mask) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= nw) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t blk = win_blk[w];
  uint32_t packed = 0;  // byte k = lane 4*lane+k, little-endian
  if (blk >= 0 && blk < nb) {
    const int32_t meta = win_meta[w];
    const int start = meta & 0xFF;
    const int end = (meta >> 8) & 0xFF;
    const int64_t i = static_cast<int64_t>(blk) * kBlock + 4 * lane;
    const float4 alo4 = *reinterpret_cast<const float4*>(b_alo + i);
    const float4 ahi4 = *reinterpret_cast<const float4*>(b_ahi + i);
    const longlong2 t0a = *reinterpret_cast<const longlong2*>(b_t0 + i);
    const longlong2 t0b = *reinterpret_cast<const longlong2*>(b_t0 + i + 2);
    const longlong2 t1a = *reinterpret_cast<const longlong2*>(b_t1 + i);
    const longlong2 t1b = *reinterpret_cast<const longlong2*>(b_t1 + i + 2);
    const float p_alo[4] = {alo4.x, alo4.y, alo4.z, alo4.w};
    const float p_ahi[4] = {ahi4.x, ahi4.y, ahi4.z, ahi4.w};
    const int64_t p_t0[4] = {t0a.x, t0a.y, t0b.x, t0b.y};
    const int64_t p_t1[4] = {t1a.x, t1a.y, t1b.x, t1b.y};
    const float qa = w_alo[w];
    const float qb = w_ahi[w];
    const int64_t q0 = w_t0[w];
    const int64_t q1 = w_t1[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = 4 * lane + k;
      const bool hit = l >= start && l < end &&
                       exact_hit(p_alo[k], p_ahi[k], p_t0[k], p_t1[k], qa,
                                 qb, q0, q1);
      packed |= static_cast<uint32_t>(hit) << (8 * k);
    }
  }
  mask[static_cast<int64_t>(w) * (kBlock / 4) + lane] = packed;
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError().
// wins is (2, nw) i32: row 0 block index, row 1 start | end<<8 | qidx<<16.
// Scratch (caller-allocated): words u32[nw*4], counts and offsets
// i32[ceil(nw/32)].  out is i32[1 + 2*max_words], zeroed by the caller.
extern "C" int dss_fused_window_filter(
    const void* b_alo, const void* b_ahi, const void* b_t0, const void* b_t1,
    const void* wins, int nw, const void* q_alo, const void* q_ahi,
    const void* q_t0, const void* q_t1, int max_words, void* words,
    void* counts, void* offsets, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nw <= 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = (nw + kWinPerCta - 1) / kWinPerCta;
  const int32_t* w32 = static_cast<const int32_t*>(wins);
  filter_pack<<<n_chunks, kWarps * 32, 0, s>>>(
      static_cast<const float*>(b_alo), static_cast<const float*>(b_ahi),
      static_cast<const int64_t*>(b_t0), static_cast<const int64_t*>(b_t1),
      w32, w32 + nw, static_cast<const float*>(q_alo),
      static_cast<const float*>(q_ahi), static_cast<const int64_t*>(q_t0),
      static_cast<const int64_t*>(q_t1), nw, static_cast<uint32_t*>(words),
      static_cast<int32_t*>(counts));
  scan_counts<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), n_chunks,
      static_cast<int32_t*>(offsets), static_cast<int32_t*>(out));
  scatter<<<n_chunks, kChunkWords, 0, s>>>(
      static_cast<const uint32_t*>(words), nw * kWords,
      static_cast<const int32_t*>(offsets), max_words,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B4: launches fused_filter_mask on `stream` and returns
// cudaGetLastError().  Block columns (nb, 128), 16 B aligned; per window
// i32 blk and meta (start | end<<8), f32 alo/ahi, i64 t0/t1; mask is
// int8 (nw, 128).
extern "C" int dss_fused_filter_mask(
    const void* b_alo, const void* b_ahi, const void* b_t0, const void* b_t1,
    int nb, const void* win_blk, const void* meta, const void* w_alo,
    const void* w_ahi, const void* w_t0, const void* w_t1, int nw, void* mask,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nw <= 0) return static_cast<int>(cudaGetLastError());
  fused_filter_mask<<<(nw + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const float*>(b_alo), static_cast<const float*>(b_ahi),
      static_cast<const int64_t*>(b_t0), static_cast<const int64_t*>(b_t1), nb,
      static_cast<const int32_t*>(win_blk), static_cast<const int32_t*>(meta),
      static_cast<const float*>(w_alo), static_cast<const float*>(w_ahi),
      static_cast<const int64_t*>(w_t0), static_cast<const int64_t*>(w_t1), nw,
      static_cast<uint32_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

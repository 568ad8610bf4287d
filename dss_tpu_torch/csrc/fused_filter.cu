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
// Words at rank >= max_words are dropped; the kernel writes the zero tail
// of both halves itself, so `out` may come uninitialised.
//
// Bound: memory.  The bytes a batch must move are 24 B of block columns
// (f32 alo, f32 ahi, i64 t0, i64 t1) for each distinct (block, lane) of
// the windows' [start, end) ranges, 8 B of window list per window of the
// bucket, 24 B of bounds per query and the flat output.  chip_smoke.py
// counts them for the 8192-query headline batch at 1M intents: about
// 55.9 MB, 0.0167 ms at 3.35 TB/s on an H100 SXM.  Pad windows read no
// columns and no bounds; a window reads only the lanes it needs.  What
// keeps the kernel from that bound is latency, not bytes: on an
// L2-resident batch of the same shape it is hardly faster (PERF.md).
//
// Design: one launch, one pass, no memset.  A persistent grid (as many
// CTAs as fit on the card at once) draws tiles of kTileWin windows from
// an atomic counter.  For each tile a CTA:
//   1. reads the tile's window list (loaded ahead, during the previous
//      tile), skips pad and empty windows, gathers each live window's
//      query bounds into shared memory and lists the tile's non-empty
//      32-lane segments as items;
//   2. has each warp load the columns of kBatch items at once, every
//      load issued before any compare, so several items' loads are in
//      flight per warp (the TPU kernel overlaps one window's DMA with
//      the previous window's compare; here the overlap is across items
//      and across the many warps resident on each SM); lane i compares
//      lane i of the segment, and __ballot_sync gives the packed word
//      (bit i = lane 32*seg + i, bit 31 included);
//   3. counts and ranks the tile's non-empty words and publishes the
//      count as the tile's status, tagged with the launch's epoch;
//   4. resolves the PREVIOUS tile's exclusive prefix by decoupled
//      look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
//      with Decoupled Look-back"): warp 0 sums the predecessors' counts
//      back to the nearest published prefix, 256 tiles per round trip,
//      publishes that tile's inclusive prefix, and the CTA scatters the
//      tile's words at their ranks.  Ranks, not atomics, keep the
//      positions ascending, which the host decode relies on.
// Resolving one tile late keeps the CTA's loads going: when it looks
// back, its predecessors have had a whole tile's time to publish, and no
// CTA idles on the slowest tile of a wave before starting its next one.
// A CTA waits only on tiles drawn before its own, and a tile is drawn
// only by a running CTA that publishes its count before it waits on
// anything, so the look-back always makes progress.  When the counter
// runs out, each CTA waits for the last tile's inclusive prefix (the
// true count) and zeroes its share of [count, max_words) in both
// halves.  The counter, the epoch and the tile statuses live in a
// scratch buffer that the wrapper keeps per device and stream: the CTA
// that makes the launch's last draw resets the counter and advances the
// epoch, so no launch needs the buffer cleared.  A spin that outlasts
// millions of polls traps: a stuck look-back ends the launch with an
// error instead of hanging the card.
// Staging the columns through shared memory instead (a cp.async ring
// per warp, or one TMA bulk copy per column run with an mbarrier) was
// slower on the H100: issuing the copies cost about as much as the
// loads they replaced, and the stage limited the CTAs per SM.
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
//   Design: one warp a window; thread t owns lanes 4t..4t+3 and loads
//   them (16 B of each f32 column, 32 B of each i64 column) only when
//   they intersect the window's [start, end): about 30 lanes a window
//   at the headline, so a window reads about 8 of its 32 four-lane
//   groups where a full row is 3,072 B.  A warp loads its window's
//   block, meta and bounds in one round trip (the range decides which
//   columns to read), then the columns.  Every thread writes its 4
//   mask bytes as one 32-bit store, so a window's 128 B row is one
//   coalesced store.  The range is what made B4 about 12 % faster
//   cold than the earlier kernel (every lane loaded).  Two other
//   designs were timed against it in turns on the card (PERF.md) and
//   lost: one wave over every SM (4 windows a CTA at 512 windows, about
//   2 % slower), and the CTA's scalars loaded in one coalesced pass into
//   shared memory before any column load (about 95 % slower cold).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;                        // postings per block
constexpr int kWords = kBlock / 32;                // u32 words per window
constexpr int kWarps = 8;                          // 256 threads per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTileWin = 64;                       // windows per tile
constexpr int kTileWords = kTileWin * kWords;      // == kThreads
constexpr int kBatch = 4;            // items whose loads a warp issues at once
constexpr int kLook = 8;                 // tile statuses per look-back lane
constexpr int kHead = 32;     // u64 scratch words before the tile statuses
constexpr int kEpochWord = 16;  // its own 128 B line, apart from the counter
constexpr long long kSpinLimit = 1LL << 22;  // polls: a second or more
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPrefixBit = 1ull << 31;
static_assert(kTileWords == kThreads, "one tile word per thread");
static_assert(kTileWin == 64, "phase 1 scans the windows in two warps");

// The exact 4D compare of one posting lane with one window's bounds.
__device__ __forceinline__ bool exact_hit(float p_alo, float p_ahi,
                                          int64_t p_t0, int64_t p_t1,
                                          float q_alo, float q_ahi,
                                          int64_t q_t0, int64_t q_t1) {
  return p_ahi >= q_alo && p_alo <= q_ahi && p_t1 >= q_t0 && p_t0 <= q_t1;
}

struct Smem {
  uint32_t words[kTileWords];    // the tile's packed words
  int64_t q_t0[kTileWin];        // each live window's query bounds
  int64_t q_t1[kTileWin];
  float q_alo[kTileWin];
  float q_ahi[kTileWin];
  int32_t blk[kTileWin];
  int32_t range[kTileWin];       // start | end << 8; 0 for a dead window
  uint16_t items[kTileWords];    // window << 2 | segment
  int warp_sum[kWarps];
  int tile;
  int next;
  int excl;
  int total;
  unsigned tag;
};

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The status word of a tile: the launch's tag, the prefix bit, a count.
__device__ __forceinline__ unsigned long long status_word(unsigned tag,
                                                          bool prefix,
                                                          unsigned v) {
  return (static_cast<unsigned long long>(tag) << 32) |
         (prefix ? kPrefixBit : 0ull) | v;
}

// Waits until tile status *p carries this launch's tag (and, with
// `prefix`, the tile's inclusive prefix); -> the status word.
__device__ unsigned long long await_status(const unsigned long long* p,
                                           unsigned tag, bool prefix) {
  unsigned long long s = ld_relaxed(p);
  for (long long spins = 0; static_cast<unsigned>(s >> 32) != tag ||
                            (prefix && !(s & kPrefixBit));) {
    if (++spins > kSpinLimit) __trap();
    __nanosleep(64);
    s = ld_relaxed(p);
  }
  return s;
}

// Warp 0 of the CTA that holds `tile` > 0: the sum of every earlier
// tile's word count, read back to the nearest tile that has published
// its prefix.  Lane i reads the statuses of tiles j-8i .. j-8i-7, so one
// round trip covers 256 tiles.
__device__ unsigned lookback(const unsigned long long* status, int tile,
                             unsigned tag, int lane) {
  // before tile 0: an empty prefix
  const unsigned long long origin = status_word(tag, true, 0u);
  unsigned excl = 0;
  for (int j = tile - 1;; j -= 32 * kLook) {
    unsigned long long st[kLook];
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int idx = j - kLook * lane - k;
      st[k] = idx >= 0 ? ld_relaxed(status + idx) : origin;
    }
    unsigned sum = 0;
    bool found = false;  // the lane reached a published prefix
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      if (found) continue;
      if (static_cast<unsigned>(st[k] >> 32) != tag) {
        st[k] = await_status(status + j - kLook * lane - k, tag, false);
      }
      sum += static_cast<unsigned>(st[k] & (kPrefixBit - 1));
      found = (st[k] & kPrefixBit) != 0;
    }
    const unsigned pb = __ballot_sync(kFull, found);
    const int stop = pb ? __ffs(pb) - 1 : 31;  // lane 0 holds tile j
    excl += __reduce_add_sync(kFull, lane <= stop ? sum : 0u);
    if (pb) return excl;
  }
}

// The draw that found the counter spent.  Each CTA makes exactly one, so
// the last of them comes after every draw of the launch: it resets the
// counter for the next launch and advances the epoch, which every CTA
// read before its first draw.
__device__ void spent_draw(unsigned draw, int n_tiles,
                           unsigned long long* scratch, unsigned tag) {
  if (draw != static_cast<unsigned>(n_tiles) + gridDim.x - 1) return;
  unsigned* epoch = reinterpret_cast<unsigned*>(scratch + kEpochWord);
  atomicExch(reinterpret_cast<unsigned*>(scratch), 0u);
  // tags run 1 .. 2^32-1: a fresh buffer's zero status never matches
  atomicExch(epoch, tag == kFull ? 0u : tag);
}

__global__ void __launch_bounds__(kThreads) fused_filter_compact(
    const float* __restrict__ b_alo, const float* __restrict__ b_ahi,
    const int64_t* __restrict__ b_t0, const int64_t* __restrict__ b_t1,
    int nb, const int32_t* __restrict__ win_blk,
    const int32_t* __restrict__ win_meta, int nw,
    const float* __restrict__ q_alo, const float* __restrict__ q_ahi,
    const int64_t* __restrict__ q_t0, const int64_t* __restrict__ q_t1,
    int nq, int max_words, int32_t* __restrict__ out,
    unsigned long long* __restrict__ scratch) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (nw + kTileWin - 1) / kTileWin;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + kHead;

  if (tid == 0) {
    const unsigned long long e = ld_relaxed(scratch + kEpochWord);
    const unsigned tag = static_cast<unsigned>(e) + 1u;
    __threadfence();  // the epoch is read before the draw
    const unsigned t = atomicAdd(counter, 1u);
    if (t >= static_cast<unsigned>(n_tiles)) {
      spent_draw(t, n_tiles, scratch, tag);
    }
    sm.tag = tag;
    sm.tile = static_cast<int>(min(t, static_cast<unsigned>(n_tiles)));
  }
  __syncthreads();
  const unsigned tag = sm.tag;
  int tile = sm.tile;

  // the window list of the tile to come, one window per thread < kTileWin
  int32_t pf_blk = 0, pf_meta = 0;
  auto prefetch = [&](int t) {
    const int w = t * kTileWin + tid;
    if (t < n_tiles && tid < kTileWin && w < nw) {
      pf_blk = win_blk[w];
      pf_meta = win_meta[w];
    } else {
      pf_meta = 0;
    }
  };
  prefetch(tile);

  // The tile before the current one, whose prefix is resolved and whose
  // words are scattered only after the current tile's columns are in:
  // by then its predecessors have had a whole tile's time to publish,
  // and the CTA's loads never wait on a look-back.  Its count, and this
  // thread's word of it with that word's rank in the tile.
  int prev = -1, prev_count = 0, prev_rank = 0;
  uint32_t prev_word = 0;
  auto resolve_prev = [&]() {
    if (warp == 0 && prev >= 0) {
      const unsigned excl = prev ? lookback(status, prev, tag, lane) : 0u;
      if (lane == 0) {
        if (prev) {
          st_relaxed(status + prev,
                     status_word(tag, true, excl + prev_count));
        }
        if (prev == n_tiles - 1) out[0] = static_cast<int>(excl) + prev_count;
        sm.excl = static_cast<int>(excl);
      }
    }
    __syncthreads();
    if (prev >= 0 && prev_word != 0u) {
      const int64_t r = static_cast<int64_t>(sm.excl) + prev_rank;
      if (r < max_words) {
        out[1 + r] = prev * kTileWords + tid;
        out[1 + max_words + r] = static_cast<int32_t>(prev_word);  // raw
      }
    }
  };

  while (tile < n_tiles) {
    unsigned next = 0;
    if (tid == 0) next = atomicAdd(counter, 1u);  // used after phase 2

    // -- 1. windows -> items; each live window's query bounds ------------
    int nseg = 0, seg0 = 0, incl = 0;
    if (tid < kTileWin) {
      const int start = pf_meta & 0xFF;
      const int end = (pf_meta >> 8) & 0xFF;
      const int q = pf_meta >> 16;
      // pad windows (meta 0) and bad indices stop here: no bounds, no items
      const bool live =
          start < end && pf_blk >= 0 && pf_blk < nb && q >= 0 && q < nq;
      if (live) {
        seg0 = start >> 5;
        nseg = ((end - 1) >> 5) - seg0 + 1;
        sm.q_alo[tid] = q_alo[q];
        sm.q_ahi[tid] = q_ahi[q];
        sm.q_t0[tid] = q_t0[q];
        sm.q_t1[tid] = q_t1[q];
      }
      sm.blk[tid] = pf_blk;
      sm.range[tid] = live ? (start | (end << 8)) : 0;
      incl = nseg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) sm.warp_sum[warp] = incl;
    }
    sm.words[tid] = 0u;
    __syncthreads();
    if (tid < kTileWin) {
      const int off = incl - nseg + (warp ? sm.warp_sum[0] : 0);
      for (int k = 0; k < nseg; ++k) {
        sm.items[off + k] = static_cast<uint16_t>((tid << 2) | (seg0 + k));
      }
    }
    const int n_items = sm.warp_sum[0] + sm.warp_sum[1];
    __syncthreads();

    // -- 2. the items' columns: each warp loads kBatch items at once -----
    for (int i0 = warp; i0 < n_items; i0 += kWarps * kBatch) {
      float p_alo[kBatch], p_ahi[kBatch];
      int64_t p_t0[kBatch], p_t1[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // every load before any compare
        const int i = i0 + j * kWarps;
        const int item = i < n_items ? sm.items[i] : 0;
        const int r = i < n_items ? sm.range[item >> 2] : 0;
        const int l = (item & 3) * 32 + lane;
        in[j] = l >= (r & 0xFF) && l < ((r >> 8) & 0xFF);
        p_alo[j] = p_ahi[j] = 0.f;
        p_t0[j] = p_t1[j] = 0;
        if (in[j]) {
          const int64_t g = static_cast<int64_t>(sm.blk[item >> 2]) * kBlock + l;
          p_alo[j] = __ldg(b_alo + g);
          p_ahi[j] = __ldg(b_ahi + g);
          p_t0[j] = __ldg(b_t0 + g);
          p_t1[j] = __ldg(b_t1 + g);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kWarps;
        if (i >= n_items) break;  // uniform across the warp
        const int item = sm.items[i];
        const int w = item >> 2;
        const bool hit = in[j] && exact_hit(p_alo[j], p_ahi[j], p_t0[j],
                                            p_t1[j], sm.q_alo[w], sm.q_ahi[w],
                                            sm.q_t0[w], sm.q_t1[w]);
        const uint32_t bits = __ballot_sync(kFull, hit);
        if (lane == 0) sm.words[w * kWords + (item & 3)] = bits;
      }
    }
    if (tid == 0) {
      if (next >= static_cast<unsigned>(n_tiles)) {
        spent_draw(next, n_tiles, scratch, tag);
      }
      sm.next = static_cast<int>(min(next, static_cast<unsigned>(n_tiles)));
    }
    __syncthreads();

    // -- 3. count and rank the tile's words; publish the count -----------
    const uint32_t word = sm.words[tid];
    const unsigned nz = __ballot_sync(kFull, word != 0u);
    if (lane == 0) sm.warp_sum[warp] = __popc(nz);
    __syncthreads();
    int rank = __popc(nz & ((1u << lane) - 1u));
    int count = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = sm.warp_sum[i];
      rank += i < warp ? c : 0;
      count += c;
    }
    const int next_tile = sm.next;
    prefetch(next_tile);  // in flight through the look-back and scatter
    if (tid == 0) {  // tile 0's prefix is its count
      st_relaxed(status + tile, status_word(tag, tile == 0, count));
    }

    // -- 4. the previous tile: look back, then scatter at the ranks ------
    resolve_prev();
    prev = tile;
    prev_count = count;
    prev_rank = rank;
    prev_word = word;
    tile = next_tile;
  }
  resolve_prev();

  // -- the zero tail: ranks [true count, max_words) of both halves ------
  if (tid == 0) {
    int total = 0;
    if (n_tiles > 0) {
      const unsigned long long s =
          await_status(status + n_tiles - 1, tag, true);
      total = static_cast<int>(s & (kPrefixBit - 1));
    } else if (blockIdx.x == 0) {
      out[0] = 0;
    }
    sm.total = total;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = sm.total + static_cast<int64_t>(blockIdx.x) * kThreads +
                   tid;
       r < max_words; r += stride) {
    out[1 + r] = 0;
    out[1 + max_words + r] = 0;
  }
}

// B4: one warp per window, 8 per CTA; thread t owns lanes 4t..4t+3 and
// reads their columns only where they meet [start, end).  A window
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
  const int32_t meta = win_meta[w];
  const float qa = w_alo[w];  // with blk and meta: one round trip
  const float qb = w_ahi[w];
  const int64_t q0 = w_t0[w];
  const int64_t q1 = w_t1[w];
  const int start = meta & 0xFF;
  const int end = (meta >> 8) & 0xFF;
  const int l0 = 4 * lane;
  uint32_t packed = 0;  // byte k = lane l0+k, little-endian
  if (blk >= 0 && blk < nb && l0 < end && l0 + 4 > start) {
    const int64_t i = static_cast<int64_t>(blk) * kBlock + l0;
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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + k;
      const bool hit = l >= start && l < end &&
                       exact_hit(p_alo[k], p_ahi[k], p_t0[k], p_t1[k], qa,
                                 qb, q0, q1);
      packed |= static_cast<uint32_t>(hit) << (8 * k);
    }
  }
  mask[static_cast<int64_t>(w) * (kBlock / 4) + lane] = packed;
}

int g_max_ctas[64];  // per device: CTAs of fused_filter_compact at once

}  // namespace

// B1: launches fused_filter_compact on `stream` and returns a CUDA error
// code (0 on success).  Block columns (nb, 128); wins is
// (2, nw) i32: row 0 block index, row 1 start | end<<8 | qidx<<16;
// per-query bounds (nq,).  A window whose block or query index is out of
// range matches nothing.  out is i32[1 + 2*max_words], written whole.
// scratch is u64[32 + ceil(nw/64)], zeroed once when allocated and then
// reused by every launch on `stream` (never by two streams at once).
extern "C" int dss_fused_window_filter(
    const void* b_alo, const void* b_ahi, const void* b_t0, const void* b_t1,
    int nb, const void* wins, int nw, const void* q_alo, const void* q_ahi,
    const void* q_t0, const void* q_t1, int nq, int max_words, void* out,
    void* scratch, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_max_ctas[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_filter_compact, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_max_ctas[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int n_tiles = (nw + kTileWin - 1) / kTileWin;
  // enough CTAs for the tiles, or for the zero tail when it is long
  const int64_t want = n_tiles > max_words / (4 * kThreads)
                           ? n_tiles
                           : max_words / (4 * kThreads);
  const int grid = static_cast<int>(
      want < 1 ? 1 : (want < g_max_ctas[dev] ? want : g_max_ctas[dev]));
  const int32_t* w32 = static_cast<const int32_t*>(wins);
  fused_filter_compact<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b_alo), static_cast<const float*>(b_ahi),
      static_cast<const int64_t*>(b_t0), static_cast<const int64_t*>(b_t1), nb,
      w32, w32 + nw, nw, static_cast<const float*>(q_alo),
      static_cast<const float*>(q_ahi), static_cast<const int64_t*>(q_t0),
      static_cast<const int64_t*>(q_t1), nq, max_words,
      static_cast<int32_t*>(out), static_cast<unsigned long long*>(scratch));
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

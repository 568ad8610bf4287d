// The mesh route's conflict query: K1 mesh_query and K2 mesh_merge.
//
// Replaces, in the reference package (XLA device code, not Pallas):
//   K1: dss_tpu/ops/conflict.py:_candidates -> _attr_test -> _compact_unique
//     (:78-131), as conflict_query_batch (:190-224) and
//     max_count_per_cell (:157-187) run them, and as
//     dss_tpu/parallel/sharded.py:_local_query (:290-313) runs them per
//     shard under shard_map.  For each (shard row s, query q): every query
//     cell's run of the sorted postings (base, then an optional delta with
//     its own cap), min(run, cap) candidate slots per cell, the 4D test with
//     the SQL's COALESCE encodings (+-inf altitudes, NO_TIME_* sentinels,
//     t_end >= now per query, the sentinel row inactive), and the unique
//     hits ascending, the first R written and the rest INT32_MAX, with the
//     exact unique count even past R.  In count mode it writes instead the
//     max over the query's cells of the per-cell hits (base + delta, no
//     dedup): max_count_per_cell.
//   K2: dss_tpu/parallel/sharded.py, the "sp" merge of step (:368-385):
//     the n_sp sorted unique shard lists of a query merged, deduplicated
//     and compacted to max_results; ovf = any(n_uni > sr) | n_unique > R;
//     each shard's n_uni summed over the queries (the psum of shard_hits);
//     each query's kept count min(n_unique, R) and the batch's largest.
//
// What bounds K1 on an H100: chains of dependent loads, not bytes.  Per
// query cell a search of the sorted int32 keys (about 23 dependent probes
// at 8M postings), then per candidate a dependent post_ent load and its
// entity's test; a warm run is barely faster than a cold one, so the time
// is latency times chain length over the warps in flight.  The useful
// bytes (the key sectors the searches touch, the reached postings, 25 B
// of columns per named slot, the output rows) give the bound that
// chip_smoke.py reports.  The design shortens the chains and keeps more
// warps in flight (one warp per (shard, query) item):
//   - the entity's test reads one 32 B row (pack_entity_rows: alt_lo,
//     alt_hi, t_start, t_end, owner, active) with two 16 B loads of one
//     sector, not five or six columns at five sectors;
//   - the live keys of a chunk of 32 cells are spread over the whole warp:
//     g = 32 / (live keys, rounded up to a power of two) lanes search each
//     key together, a (g + 1)-ary search of g probes a step (about 10 steps
//     at 8 live keys and 8M postings instead of 23), and each run's end is
//     read by ballots over 128 B windows of the row, four keys' windows in
//     flight, not by a second search;
//   - each lane gathers kUnroll candidates a round, so their post_ent and
//     row loads overlap;
//   - the hits go to a per-warp tile of kTile int32 in shared memory (by
//     ballot and popc, in candidate order); an item whose hits outgrow it
//     moves them to its own slice of a global scratch that the wrapper
//     hands over, so a block needs under 12 KB, not K * (cap + delta cap)
//     int32 a warp, and K1 stays exact for any cap.  The launch bound asks
//     for kMinBlocks blocks an SM, which leaves 64 registers a thread and
//     no spills;
//   - the hits are sorted in place (a bitonic network whose pads past the
//     last hit are virtual) and deduplicated on the way out.  Count mode
//     needs no buffer: a run's hits are the ballots' count between its
//     first candidate and the next run's.
// Measured on an H100 at the mesh headline (mesh_device_time.py, each
// choice left out in turns): without the tile (8 KB a warp) K1 takes
// about 1.75x as long, with one lane a key about 1.1x; 48 warps an SM at
// 40 registers (spilling) or four candidates a lane are slower; merging
// the hits' ascending runs (each cell's run is ascending by slot) instead
// of sorting them was 1-4 % slower at about 40 hits an item, so K1 sorts.
// K2 reads n_uni and the min(n_uni, sr) live values of each shard list
// (the rest are pads it never reads) and writes every column of a row of
// R, pads included: that is its bound.  One warp per query.  K1 writes
// each list ascending and unique, so K2 merges the lists instead of
// sorting their concatenation: each value goes straight to its place,
// its index in its list plus, in every other list, the values below it
// (by binary search in shared memory; ties to the earlier list), in a
// per-warp tile of kMergeTile int32 or, past it, a global slice.  One
// list is copied out as it is, its first values read before its length
// is known.  Per-block sums of the shard hits and the batch
// maximum go into a zeroed buffer with one atomic each (int32 atomics:
// the sums do not depend on their order).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = INT32_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // items (a warp each) a block, both kernels
constexpr int kSmemMax = 232448;   // 227 KB, what one block may use
constexpr int kTile = 512;         // K1: hits a warp holds in shared memory
constexpr int kMaxGroup = 32;      // K1: lanes one key's search may take
constexpr int kUnroll = 2;         // K1: candidates a lane gathers a round
constexpr int kMinBlocks = 8;      // K1: blocks an SM should hold (32 warps)
constexpr int kDelta = 1 << 30;    // K1: marks a delta run's first posting
constexpr int kMergeTile = 1024;   // K2: int32 a warp holds in shared memory

// One K1 warp's shared state.
struct QueryWarp {
  int32_t key[32];     // the chunk's live keys, in order
  int start[65];       // first candidate of each nonempty run, then the total
  int lo[64];          // first posting of each run (| kDelta: the delta row)
  int hits[65];        // count mode: hits before each run's first candidate,
                       // then after the chunk
  int32_t tile[kTile];
};

struct QueryArgs {
  const int32_t* pkey;  // [s, p] sorted rows, pad INT32_MAX
  const int32_t* pent;  // [s, p]
  int p, cap;
  const int32_t* dkey;  // [s, pd] (pd 0: no delta)
  const int32_t* dent;
  int pd, dcap;
  const int4* rows;     // [n + 1] entity rows of 32 B (pack_entity_rows)
  const int32_t* keys;  // [q, k], pad -1
  int k;
  const float* qalo;    // per query [q]
  const float* qahi;
  const int64_t* qt0;
  const int64_t* qt1;
  const int64_t* now;
  const int32_t* qowner;  // null: no owner filter
  int s, q, r;
  int count_mode;
  int buf;               // an item's slice of the scratch, in int32
  int32_t* scratch;      // [n_items, buf]; null when buf <= kTile
  long long item0, n_items;  // the items (s * q + query) of this launch
  int32_t* slots;        // [s, q, r]
  int32_t* count;        // [s, q]: unique hits, or the max per-cell count
};

struct MergeArgs {
  const int32_t* slots;  // [n_sp, q, sr], each row's live values first
  const int32_t* nuni;   // [n_sp, q]
  int n_sp, q, sr, r;
  int32_t* scratch;      // [q, 2 * n_sp * sr]; null when the tile holds all
  int32_t* out;          // [q, r]
  uint8_t* ovf;          // [q]
  int32_t* kept;         // [q]
  int32_t* acc;          // [n_sp + 1], zeroed: shard hits, then max kept
};

// One query's bounds, as K1 tests an entity against them.
struct Bounds {
  float alo, ahi;
  int64_t t0, t1, now;
  bool by_owner;
  int32_t owner;
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The j-th of the g probes into an interval of len > 0 keys: in [0, len)
// and nondecreasing in j, about j * len / (g + 1).
__device__ __forceinline__ int cut(int j, int len, float inv) {
  return min(len - 1, static_cast<int>(static_cast<float>(j) *
                                       static_cast<float>(len) * inv));
}

// The first index of the sorted row[0, n) whose value is >= key, found by
// the g lanes of this lane's group together (the group's lanes start at
// gbit; t is this lane's place in it): each step probes g points that cut
// [lo, hi) into g + 1 parts and keeps the part that holds the answer.
// Every lane of the warp calls it.
__device__ int group_lower_bound(const int32_t* row, int n, int32_t key,
                                 int g, int gbit, int t) {
  const float inv = 1.0f / static_cast<float>(g + 1);
  const unsigned gmask = g == 32 ? kFull : (1u << g) - 1u;
  int lo = 0, hi = n;
  while (__any_sync(kFull, lo < hi)) {
    const int len = hi - lo;
    bool less = false;
    if (len > 0) less = __ldg(row + lo + cut(t + 1, len, inv)) < key;
    const int c = __popc((__ballot_sync(kFull, less) >> gbit) & gmask);
    if (len > 0) {
      const int nlo = c ? lo + cut(c, len, inv) + 1 : lo;
      hi = c < g ? lo + cut(c + 1, len, inv) : hi;
      lo = nlo;
    }
  }
  return lo;
}

// Lane i < nk holds key i, its first posting `first` in row and lim, the
// postings it may take (the least of what is left and the cap).  -> on
// lane i, how many of row[first, first + lim) equal the key: the run's
// length, read as ballots over 32-posting (128 B) windows, the windows of
// four keys in flight at a time.
__device__ int run_lengths(const int32_t* row, int first, int lim,
                           int32_t key, int nk, int lane) {
  int cnt = 0;
  bool open = lane < nk && lim > 0;
  for (int w = 0;; w += 32) {
    unsigned todo = __ballot_sync(kFull, open);
    if (!todo) break;
    while (todo) {
      int id[4];
      bool eq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        id[j] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = id[j] & 31;
        const int f = __shfl_sync(kFull, first, src);
        const int l = __shfl_sync(kFull, lim, src);
        const int32_t kk = __shfl_sync(kFull, key, src);
        eq[j] = id[j] >= 0 && w + lane < l && __ldg(row + f + w + lane) == kk;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int got = __popc(__ballot_sync(kFull, eq[j]));
        if (lane == id[j]) {
          cnt += got;
          open = got == 32 && w + 32 < lim;
        }
      }
    }
  }
  return cnt;
}

// The last of the nr runs (or lists) that start at or before c.
__device__ __forceinline__ int find_run(const int* start, int nr, int c) {
  int lo = 0, hi = nr;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= c) lo = mid;
    else hi = mid;
  }
  return lo;
}

// Whether entity row e passes the query's 4D test.
__device__ __forceinline__ bool entity_hit(const int4* rows, int32_t e,
                                           const Bounds& b) {
  const int4 x = __ldg(rows + 2 * static_cast<long long>(e));
  const int4 y = __ldg(rows + 2 * static_cast<long long>(e) + 1);
  const int64_t t0 = (static_cast<int64_t>(x.w) << 32) |
                     static_cast<uint32_t>(x.z);
  const int64_t t1 = (static_cast<int64_t>(y.y) << 32) |
                     static_cast<uint32_t>(y.x);
  bool hit = y.w != 0 && __int_as_float(x.y) >= b.alo &&
             __int_as_float(x.x) <= b.ahi && t1 >= b.t0 && t0 <= b.t1 &&
             t1 >= b.now;
  if (b.by_owner) hit = hit && y.z == b.owner;
  return hit;
}

// How many of the ascending a[0, len) are below v (or_equal: at most v).
__device__ __forceinline__ int count_below(const int32_t* a, int len,
                                           int32_t v, bool or_equal) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    const int32_t x = a[lo + half];
    if (x < v || (or_equal && x == v)) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// Merges the n values of buf, nseg ascending runs that start at seg[0,
// nseg) (seg[nseg] = n; a run may be empty), ascending into out[0, n):
// each value goes to its index in its run plus, in every other run, the
// values below it (in an earlier run, also those equal to it).
__device__ __forceinline__ void merge_runs(const int32_t* buf,
                                           const int* seg, int nseg, int n,
                                           int32_t* out, int lane) {
  for (int h = lane; h < n; h += 32) {
    const int32_t v = buf[h];
    const int own = find_run(seg, nseg, h);
    int pos = h - seg[own];
    for (int i = 0; i < nseg; ++i) {
      if (i != own) {
        pos += count_below(buf + seg[i], seg[i + 1] - seg[i], v, i < own);
      }
    }
    out[pos] = v;
  }
}

// Sorts buf[0, n) ascending, one warp.  Bitonic with every compare
// ascending (the first step of each merge compares mirror positions), so
// the positions past n act as +inf and any compare that reaches one is a
// no-op: only n values are stored.
__device__ __forceinline__ void warp_sort(int32_t* buf, int n, int lane) {
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (np2 >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int pr = (j == (k >> 1)) ? (i ^ (k - 1)) : (i + j);
        if (pr < n) {
          const int32_t x = buf[i], y = buf[pr];
          if (x > y) {
            buf[i] = y;
            buf[pr] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The unique values of the sorted buf[0, n) (INT32_MAX dropped), the first
// r written to out and the rest of out[0, r) INT32_MAX.  -> the unique
// count, on every lane.  `head` is this lane's buf[lane] (any value where
// lane >= n), read by the caller as early as it can be; each later value
// is read once, a round ahead, and its predecessor comes from the next
// lane down.
__device__ __forceinline__ int unique_out(const int32_t* buf, int n,
                                          int32_t head, int32_t* out, int r,
                                          int lane) {
  int kept = 0;
  int32_t carry = -1;  // the value before this round's first
  int32_t next = head;
  for (int b = 0; b < n; b += 32) {
    const int i = b + lane;
    const int32_t v = next;
    next = i + 32 < n ? buf[i + 32] : kPad;  // the next round's, in flight
    int32_t prev = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, v, 31);
    const bool keep = i < n && v != prev && v != kPad;
    const unsigned m = __ballot_sync(kFull, keep);
    const int pos = kept + __popc(m & lanes_below(lane));
    if (keep && pos < r) out[pos] = v;
    kept += __popc(m);
  }
  for (int i = min(kept, r) + lane; i < r; i += 32) out[i] = kPad;
  return kept;
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    mesh_query_kernel(const QueryArgs a) {
  __shared__ QueryWarp warps[kWarps];
  const int lane = threadIdx.x & 31;
  const long long rel =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (rel >= a.n_items) return;  // whole warps; no block barrier follows
  const long long item = a.item0 + rel;
  QueryWarp& w = warps[threadIdx.x >> 5];
  const int s = static_cast<int>(item / a.q);
  const int qi = static_cast<int>(item % a.q);
  const int32_t* pkey = a.pkey + static_cast<long long>(s) * a.p;
  const int32_t* pent = a.pent + static_cast<long long>(s) * a.p;
  const int32_t* dkey = a.dkey + static_cast<long long>(s) * a.pd;
  const int32_t* dent = a.dent + static_cast<long long>(s) * a.pd;
  const int32_t* keys = a.keys + static_cast<long long>(qi) * a.k;
  Bounds bq;
  bq.alo = a.qalo[qi];
  bq.ahi = a.qahi[qi];
  bq.t0 = a.qt0[qi];
  bq.t1 = a.qt1[qi];
  bq.now = a.now[qi];
  bq.by_owner = a.qowner != nullptr;
  bq.owner = bq.by_owner ? a.qowner[qi] : 0;

  int32_t* buf = w.tile;
  int n = 0;             // hits so far (both modes)
  int best = 0;          // the largest per-cell count so far (count mode)
  bool spilled = false;  // the hits lie in the global scratch
  for (int c0 = 0; c0 < a.k; c0 += 32) {
    const int32_t key = c0 + lane < a.k ? keys[c0 + lane] : -1;
    const unsigned live = __ballot_sync(kFull, key >= 0);
    const int nk = __popc(live);
    if (nk == 0) continue;
    if (key >= 0) w.key[__popc(live & lanes_below(lane))] = key;
    __syncwarp();
    // the searches: g lanes a key, the groups in key order
    int lg = 0;
    while ((1 << lg) < nk) ++lg;
    const int g = min(kMaxGroup, 32 >> lg);
    const int gi = lane / g;
    const int32_t gkey = w.key[min(gi, nk - 1)];
    const int fb = __shfl_sync(
        kFull, group_lower_bound(pkey, a.p, gkey, g, gi * g, lane % g),
        (lane * g) & 31);
    const int fd =
        a.pd ? __shfl_sync(kFull,
                           group_lower_bound(dkey, a.pd, gkey, g, gi * g,
                                             lane % g),
                           (lane * g) & 31)
             : 0;
    // lane i < nk: key i's runs, base and delta
    const int32_t mine = w.key[lane];
    const int cnt_b = run_lengths(
        pkey, fb, lane < nk ? min(a.p - fb, a.cap) : 0, mine, nk, lane);
    const int cnt_d =
        a.pd ? run_lengths(dkey, fd, lane < nk ? min(a.pd - fd, a.dcap) : 0,
                           mine, nk, lane)
             : 0;
    // the chunk's nonempty runs: the base runs in key order, then the delta
    const unsigned mb = __ballot_sync(kFull, cnt_b > 0);
    const unsigned md = __ballot_sync(kFull, cnt_d > 0);
    const int nb = __popc(mb), nr = nb + __popc(md);
    const int rb = __popc(mb & lanes_below(lane));
    const int rd = nb + __popc(md & lanes_below(lane));
    int inc_b = cnt_b, inc_d = cnt_d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, inc_b, o);
      const int y = __shfl_up_sync(kFull, inc_d, o);
      if (lane >= o) {
        inc_b += x;
        inc_d += y;
      }
    }
    const int tot_b = __shfl_sync(kFull, inc_b, 31);
    const int total = tot_b + __shfl_sync(kFull, inc_d, 31);
    if (cnt_b > 0) {
      w.start[rb] = inc_b - cnt_b;
      w.lo[rb] = fb;
    }
    if (cnt_d > 0) {
      w.start[rd] = tot_b + inc_d - cnt_d;
      w.lo[rd] = fd | kDelta;
    }
    if (lane == 0) w.start[nr] = total;
    __syncwarp();
    // the gather: kUnroll candidates a lane a round, in candidate order
    for (int b = 0; b < total; b += 32 * kUnroll) {
      int32_t e[kUnroll];
      int run[kUnroll];
      bool head[kUnroll], hit[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = b + u * 32 + lane;
        e[u] = 0;
        run[u] = 0;
        head[u] = false;
        if (c < total) {
          run[u] = find_run(w.start, nr, c);
          const int first = w.start[run[u]];
          const int lo = w.lo[run[u]];
          const int idx = (lo & ~kDelta) + (c - first);
          e[u] = __ldg((lo & kDelta ? dent : pent) + idx);
          head[u] = a.count_mode && c == first;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        hit[u] = b + u * 32 + lane < total && entity_hit(a.rows, e[u], bq);
      }
      unsigned m[kUnroll];
      int got = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        m[u] = __ballot_sync(kFull, hit[u]);
        got += __popc(m[u]);
      }
      if (!a.count_mode && !spilled && n + got > kTile) {
        // past the tile (only when a.buf > kTile: a scratch is there)
        int32_t* slice = a.scratch + rel * a.buf;
        for (int i = lane; i < n; i += 32) slice[i] = w.tile[i];
        buf = slice;
        spilled = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = n + __popc(m[u] & lanes_below(lane));
        if (head[u]) w.hits[run[u]] = pos;
        if (hit[u] && !a.count_mode) buf[pos] = e[u];
        n += __popc(m[u]);
      }
    }
    if (lane == 0) w.hits[nr] = n;
    __syncwarp();
    if (a.count_mode) {
      int h = 0;
      if (cnt_b > 0) h += w.hits[rb + 1] - w.hits[rb];
      if (cnt_d > 0) h += w.hits[rd + 1] - w.hits[rd];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        h = max(h, __shfl_xor_sync(kFull, h, o));
      }
      best = max(best, h);
    }
    __syncwarp();
  }
  if (a.count_mode) {
    if (lane == 0) a.count[item] = best;
    return;
  }
  warp_sort(buf, n, lane);
  const int uniq = unique_out(buf, n, lane < n ? buf[lane] : kPad,
                              a.slots + item * a.r, a.r, lane);
  if (lane == 0) a.count[item] = uniq;
}

__global__ void __launch_bounds__(kWarps * 32)
    mesh_merge_kernel(const MergeArgs a) {
  extern __shared__ int smem[];
  int* cta_hits = smem;          // [n_sp]
  int* cta_max = smem + a.n_sp;  // [1]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile_len = a.n_sp > 1 ? kMergeTile : 0;  // one list: no tile
  int* off = smem + a.n_sp + 1 + warp * (a.n_sp + 1 + tile_len);
  int32_t* tile = off + a.n_sp + 1;  // [tile_len]
  const int qi = blockIdx.x * kWarps + warp;
  // one list is copied out as it is: its first values are read before
  // its length is known
  const int32_t* list0 = a.slots + static_cast<long long>(qi) * a.sr;
  const int32_t head =
      a.n_sp == 1 && qi < a.q && lane < a.sr ? list0[lane] : kPad;
  for (int i = threadIdx.x; i < a.n_sp; i += blockDim.x) cta_hits[i] = 0;
  if (threadIdx.x == 0) *cta_max = 0;
  __syncthreads();
  if (qi < a.q) {  // whole warps
    // each list's live length and its place in the buffer
    int total = 0;
    bool shard_ovf = false;
    for (int s0 = 0; s0 < a.n_sp; s0 += 32) {
      int nu = 0, m = 0;
      if (s0 + lane < a.n_sp) {
        nu = a.nuni[static_cast<long long>(s0 + lane) * a.q + qi];
        m = min(max(nu, 0), a.sr);
        atomicAdd(&cta_hits[s0 + lane], nu);
      }
      shard_ovf = shard_ovf || __any_sync(kFull, nu > a.sr);
      int inc = m;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += x;
      }
      if (s0 + lane < a.n_sp) off[s0 + lane] = total + inc - m;
      total += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) off[a.n_sp] = total;
    __syncwarp();
    const int32_t* sorted = list0;
    if (a.n_sp > 1) {
      int32_t* buf =
          2 * total <= kMergeTile
              ? tile
              : a.scratch + static_cast<long long>(qi) * 2 * a.n_sp * a.sr;
      for (int j = 0; j < a.n_sp; ++j) {
        const int b0 = off[j], mj = off[j + 1] - b0;
        const int32_t* src =
            a.slots + (static_cast<long long>(j) * a.q + qi) * a.sr;
        for (int i = lane; i < mj; i += 32) buf[b0 + i] = src[i];
      }
      __syncwarp();
      merge_runs(buf, off, a.n_sp, total, buf + total, lane);
      __syncwarp();
      sorted = buf + total;
    }
    const int uniq = unique_out(
        sorted, total,
        a.n_sp == 1 ? head : (lane < total ? sorted[lane] : kPad),
        a.out + static_cast<long long>(qi) * a.r, a.r, lane);
    if (lane == 0) {
      const int kept = min(uniq, a.r);
      a.kept[qi] = kept;
      a.ovf[qi] = (shard_ovf || uniq > a.r) ? 1 : 0;
      atomicMax(cta_max, kept);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_sp; i += blockDim.x) {
    if (cta_hits[i]) atomicAdd(&a.acc[i], cta_hits[i]);
  }
  if (threadIdx.x == 0 && *cta_max) atomicMax(&a.acc[a.n_sp], *cta_max);
}

// Dynamic shared memory of one K2 block: the shard-hit sums and the
// maximum, and each warp's list offsets and (past one list) its tile.
long long merge_smem(long long n_sp) {
  return 4LL * (n_sp + 1) +
         4LL * kWarps * (n_sp + 1 + (n_sp > 1 ? kMergeTile : 0));
}

}  // namespace

// The int32 hits a K1 warp holds in shared memory (kTile).
extern "C" int dss_mesh_query_tile() { return kTile; }

// 1 when K1 needs no global scratch for items of `buf` int32 hits at
// most (count mode holds none), else 0.
extern "C" int dss_mesh_query_fits(long long buf, long long count_mode) {
  return count_mode || buf <= kTile ? 1 : 0;
}

// 1 when K2 needs no global scratch for n_sp lists of sr values, else 0.
extern "C" int dss_mesh_merge_fits(long long n_sp, long long sr) {
  return n_sp <= 1 || 2 * n_sp * sr <= kMergeTile ? 1 : 0;
}

// K1's blocks per SM, registers a thread and local memory a thread, into
// out[0..3); returns the CUDA error of the queries.
extern "C" int dss_mesh_query_occupancy(int* out) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, mesh_query_kernel, kWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, mesh_query_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// Launches K1 over items [item0, item0 + n_items) of the s * q (shard,
// query) items on `stream` and returns cudaGetLastError().  Pointers as
// in QueryArgs; qowner, and dkey/dent with pd 0, may be null; scratch
// holds n_items * buf int32 when buf > the tile (dss_mesh_query_fits 0),
// else may be null.  slots is unused in count mode.
extern "C" int dss_mesh_query(
    const void* pkey, const void* pent, int p, int cap, const void* dkey,
    const void* dent, int pd, int dcap, const void* rows, const void* keys,
    int k, const void* qalo, const void* qahi, const void* qt0,
    const void* qt1, const void* now, const void* qowner, int s, int q,
    int r, int count_mode, int buf, void* scratch, long long item0,
    long long n_items, void* slots, void* count, void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  QueryArgs a;
  a.pkey = static_cast<const int32_t*>(pkey);
  a.pent = static_cast<const int32_t*>(pent);
  a.p = p;
  a.cap = cap;
  a.dkey = static_cast<const int32_t*>(dkey);
  a.dent = static_cast<const int32_t*>(dent);
  a.pd = pd;
  a.dcap = dcap;
  a.rows = static_cast<const int4*>(rows);
  a.keys = static_cast<const int32_t*>(keys);
  a.k = k;
  a.qalo = static_cast<const float*>(qalo);
  a.qahi = static_cast<const float*>(qahi);
  a.qt0 = static_cast<const int64_t*>(qt0);
  a.qt1 = static_cast<const int64_t*>(qt1);
  a.now = static_cast<const int64_t*>(now);
  a.qowner = static_cast<const int32_t*>(qowner);
  a.s = s;
  a.q = q;
  a.r = r;
  a.count_mode = count_mode;
  a.buf = buf;
  a.scratch = static_cast<int32_t*>(scratch);
  a.item0 = item0;
  a.n_items = n_items;
  a.slots = static_cast<int32_t*>(slots);
  a.count = static_cast<int32_t*>(count);
  const long long grid = (n_items + kWarps - 1) / kWarps;
  mesh_query_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 over the q queries of one dp row on `stream` and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
// acc must hold n_sp + 1 zeros; scratch holds q * 2 * n_sp * sr int32
// when dss_mesh_merge_fits is 0, else may be null.
extern "C" int dss_mesh_merge(const void* slots, const void* nuni, int n_sp,
                              int q, int sr, int r, void* scratch, void* out,
                              void* ovf, void* kept, void* acc,
                              void* stream) {
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  MergeArgs a;
  a.slots = static_cast<const int32_t*>(slots);
  a.nuni = static_cast<const int32_t*>(nuni);
  a.n_sp = n_sp;
  a.q = q;
  a.sr = sr;
  a.r = r;
  a.scratch = static_cast<int32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.ovf = static_cast<uint8_t*>(ovf);
  a.kept = static_cast<int32_t*>(kept);
  a.acc = static_cast<int32_t*>(acc);
  const long long bytes = merge_smem(n_sp);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    // the limit is always the block's whole 227 KB, never one launch's
    // size: threads that launch at once with other sizes would otherwise
    // lower it under each other's launches
    const cudaError_t err = cudaFuncSetAttribute(
        mesh_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mesh_merge_kernel<<<(q + kWarps - 1) / kWarps, kWarps * 32,
                      static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
// Bound on an H100: random gathers.  Per candidate K1 reads one int32 of
// post_ent (a run is contiguous, so those reads coalesce) and 25 B of
// entity columns at a random slot, after a binary search of each query
// cell over int32 keys (about 23 dependent loads at 8M postings).  The
// bytes it must move (the 32 B key sectors its searches touch, the
// reached postings, the named slots' columns, the output rows) give the
// bound chip_smoke.py reports; but each column value is a 32 B sector of
// its own, five a candidate, and the dependent chain of loads is long: a
// warm run is barely faster than a cold one, so latency and sectors, not
// the useful bytes, set its time.  The design's answer: one
// warp per (shard, query), many warps in flight, and no [Q, K, cap]
// intermediate in device memory: the hits go to a per-warp buffer in shared
// memory (by ballot and popc), are sorted there (bitonic, pads past the
// last hit are virtual) and deduplicated on the way out.  The buffer holds
// K * (cap + delta cap) int32, the most hits a query can have; past what a
// block's shared memory holds the wrapper hands a global scratch instead.
// K2 reads n_uni and the min(n_uni, sr) live values of each shard list
// (the rest are pads it never reads) and writes every column of a row of
// R, pads included: that is its bound.  One warp per query, per-block sums
// of the shard hits and the batch maximum before one atomic each into a
// zeroed buffer (int32 atomics: the sums do not depend on their order).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = INT32_MAX;
constexpr int kWarps = 4;   // items (one warp each) per CTA, both kernels
constexpr int kRuns = 64;   // postings runs per chunk of 32 keys: base, delta
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // 227 KB, what one block may use

// One warp's table of the runs of a chunk of 32 query cells.
struct Runs {
  int start[kRuns];  // first candidate of each run (exclusive prefix)
  int lo[kRuns];     // first posting of each run
  int cnt[32];       // count mode: hits per cell of the chunk
};

struct QueryArgs {
  const int32_t* pkey;  // [s, p] sorted rows, pad INT32_MAX
  const int32_t* pent;  // [s, p]
  int p, cap;
  const int32_t* dkey;  // [s, pd] (pd 0: no delta)
  const int32_t* dent;
  int pd, dcap;
  const float* alo;     // entity columns [n + 1]
  const float* ahi;
  const int64_t* t0;
  const int64_t* t1;
  const uint8_t* active;
  const int32_t* owner;
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
  int buf;               // hit buffer of one item, in int32
  int32_t* scratch;      // [n_items, buf] global buffers; null: shared
  long long item0, n_items;  // the items (s * q + query) of this launch
  int32_t* slots;        // [s, q, r]
  int32_t* count;        // [s, q]: unique hits, or the max per-cell count
};

struct MergeArgs {
  const int32_t* slots;  // [n_sp, q, sr], each row's live values first
  const int32_t* nuni;   // [n_sp, q]
  int n_sp, q, sr, r;
  int buf;               // n_sp * sr
  int32_t* scratch;      // [q, buf] global buffers; null: shared
  int32_t* out;          // [q, r]
  uint8_t* ovf;          // [q]
  int32_t* kept;         // [q]
  int32_t* acc;          // [n_sp + 1], zeroed: shard hits, then max kept
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// First index in a[0, n) whose value is >= key (a sorted ascending).
__device__ __forceinline__ int lower_bound(const int32_t* a, int n,
                                           int32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Number of values equal to key at the head of a[0, n), where every value
// is >= key and a is sorted: the first index whose value is > key.
__device__ __forceinline__ int run_length(const int32_t* a, int n,
                                          int32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// (first posting, min(run, cap)) of key in a sorted row of n keys.
__device__ __forceinline__ void key_run(const int32_t* row, int n, int cap,
                                        int32_t key, int* lo, int* cnt) {
  *lo = 0;
  *cnt = 0;
  if (n <= 0 || cap <= 0) return;
  const int first = lower_bound(row, n, key);
  *lo = first;
  *cnt = run_length(row + first, min(n - first, cap), key);
}

// Sorts buf[0, n) ascending, one warp.  Bitonic with every compare
// ascending (the first step of each merge compares mirror positions), so
// the positions past n act as +inf and any compare that reaches one is a
// no-op: only n values are stored.
__device__ void warp_sort(int32_t* buf, int n, int lane) {
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
// count, on every lane.
__device__ int unique_out(const int32_t* buf, int n, int32_t* out, int r,
                          int lane) {
  int kept = 0;
  for (int b = 0; b < n; b += 32) {
    const int i = b + lane;
    bool keep = false;
    int32_t v = kPad;
    if (i < n) {
      v = buf[i];
      const int32_t prev = i ? buf[i - 1] : -1;
      keep = v != prev && v != kPad;
    }
    const unsigned m = __ballot_sync(kFull, keep);
    const int pos = kept + __popc(m & lanes_below(lane));
    if (keep && pos < r) out[pos] = v;
    kept += __popc(m);
  }
  for (int i = min(kept, r) + lane; i < r; i += 32) out[i] = kPad;
  return kept;
}

__global__ void __launch_bounds__(kWarps * 32)
    mesh_query_kernel(const QueryArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long rel = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (rel >= a.n_items) return;  // whole warps; no block barrier follows
  const long long item = a.item0 + rel;
  Runs& runs = reinterpret_cast<Runs*>(smem)[warp];
  int32_t* buf =
      a.scratch ? a.scratch + rel * a.buf
                : reinterpret_cast<int32_t*>(reinterpret_cast<Runs*>(smem) +
                                             kWarps) +
                      static_cast<long long>(warp) * a.buf;
  const int s = static_cast<int>(item / a.q);
  const int qi = static_cast<int>(item % a.q);
  const int32_t* pkey = a.pkey + static_cast<long long>(s) * a.p;
  const int32_t* pent = a.pent + static_cast<long long>(s) * a.p;
  const int32_t* dkey = a.dkey + static_cast<long long>(s) * a.pd;
  const int32_t* dent = a.dent + static_cast<long long>(s) * a.pd;
  const int32_t* keys = a.keys + static_cast<long long>(qi) * a.k;
  const float qalo = a.qalo[qi], qahi = a.qahi[qi];
  const int64_t qt0 = a.qt0[qi], qt1 = a.qt1[qi], now = a.now[qi];
  const bool by_owner = a.qowner != nullptr;
  const int32_t qown = by_owner ? a.qowner[qi] : 0;

  int n = 0;     // hits in buf (compact mode)
  int best = 0;  // the largest per-cell count so far (count mode)
  for (int c0 = 0; c0 < a.k; c0 += 32) {
    int lo_b = 0, n_b = 0, lo_d = 0, n_d = 0;
    if (c0 + lane < a.k) {
      const int32_t key = keys[c0 + lane];
      if (key >= 0) {
        key_run(pkey, a.p, a.cap, key, &lo_b, &n_b);
        key_run(dkey, a.pd, a.dcap, key, &lo_d, &n_d);
      }
    }
    int inc_b = n_b, inc_d = n_d;
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
    runs.start[lane] = inc_b - n_b;
    runs.start[32 + lane] = tot_b + inc_d - n_d;
    runs.lo[lane] = lo_b;
    runs.lo[32 + lane] = lo_d;
    runs.cnt[lane] = 0;
    __syncwarp();
    for (int b = 0; b < total; b += 32) {
      const int c = b + lane;
      bool hit = false;
      int32_t e = 0;
      int run = 0;
      if (c < total) {
        int lo = 0, hi = kRuns;  // the last run that starts at or before c
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (runs.start[mid] <= c) lo = mid + 1;
          else hi = mid;
        }
        run = lo - 1;
        const int idx = runs.lo[run] + (c - runs.start[run]);
        e = run < 32 ? __ldg(pent + idx) : __ldg(dent + idx);
        const bool live = __ldg(a.active + e) != 0;
        const int64_t et1 = __ldg(a.t1 + e);
        const int64_t et0 = __ldg(a.t0 + e);
        const float ehi = __ldg(a.ahi + e);
        const float elo = __ldg(a.alo + e);
        hit = live && ehi >= qalo && elo <= qahi && et1 >= qt0 &&
              et0 <= qt1 && et1 >= now;
        if (by_owner) hit = hit && __ldg(a.owner + e) == qown;
      }
      if (a.count_mode) {
        if (hit) atomicAdd(&runs.cnt[run & 31], 1);
      } else {
        const unsigned m = __ballot_sync(kFull, hit);
        if (hit) buf[n + __popc(m & lanes_below(lane))] = e;
        n += __popc(m);
      }
    }
    __syncwarp();
    if (a.count_mode) {
      int v = runs.cnt[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v = max(v, __shfl_xor_sync(kFull, v, o));
      }
      best = max(best, v);
      __syncwarp();
    }
  }
  if (a.count_mode) {
    if (lane == 0) a.count[item] = best;
    return;
  }
  warp_sort(buf, n, lane);
  const int uniq = unique_out(buf, n, a.slots + item * a.r, a.r, lane);
  if (lane == 0) a.count[item] = uniq;
}

__global__ void __launch_bounds__(kWarps * 32)
    mesh_merge_kernel(const MergeArgs a) {
  extern __shared__ int smem[];
  int* cta_hits = smem;             // [n_sp]
  int* cta_max = smem + a.n_sp;     // [1]
  int32_t* bufs = smem + a.n_sp + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  for (int i = threadIdx.x; i < a.n_sp; i += blockDim.x) cta_hits[i] = 0;
  if (threadIdx.x == 0) *cta_max = 0;
  __syncthreads();
  if (qi < a.q) {  // whole warps
    int32_t* buf = a.scratch
                       ? a.scratch + static_cast<long long>(qi) * a.buf
                       : bufs + static_cast<long long>(warp) * a.buf;
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
      const int base = total + inc - m;
      total += __shfl_sync(kFull, inc, 31);
      for (int j = 0; j < 32 && s0 + j < a.n_sp; ++j) {
        const int mj = __shfl_sync(kFull, m, j);
        const int bj = __shfl_sync(kFull, base, j);
        const int32_t* src =
            a.slots + (static_cast<long long>(s0 + j) * a.q + qi) * a.sr;
        for (int i = lane; i < mj; i += 32) buf[bj + i] = src[i];
      }
    }
    __syncwarp();
    if (a.n_sp > 1) warp_sort(buf, total, lane);
    const int uniq = unique_out(buf, total,
                                a.out + static_cast<long long>(qi) * a.r,
                                a.r, lane);
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

// Lets the kernel take more than the default 48 KB of dynamic shared
// memory.  The limit is always set to the block's whole 227 KB, never to
// one launch's size: threads that launch at once with other sizes would
// otherwise lower it under each other's launches.
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

// Dynamic shared memory of one K1 block: the warps' run tables, and their
// hit buffers of `buf` int32 each unless those lie in a global scratch.
long long query_smem(long long buf, int count_mode, bool shared_buf) {
  long long bytes = static_cast<long long>(sizeof(Runs)) * kWarps;
  if (shared_buf && !count_mode) bytes += 4LL * kWarps * buf;
  return bytes;
}

// Dynamic shared memory of one K2 block: the shard-hit sums and the
// maximum, and the warps' n_sp * sr buffers unless those are global.
long long merge_smem(long long n_sp, long long sr, bool shared_buf) {
  long long bytes = 4LL * (n_sp + 1);
  if (shared_buf) bytes += 4LL * kWarps * n_sp * sr;
  return bytes;
}

}  // namespace

// 1 when K1's hit buffers of `buf` int32 (an item's) fit in a block's
// shared memory, else 0: the wrapper then hands a global scratch.
extern "C" int dss_mesh_query_fits(long long buf, long long count_mode) {
  return query_smem(buf, static_cast<int>(count_mode != 0), true) <=
                 kSmemMax
             ? 1
             : 0;
}

// 1 when K2's buffers of n_sp * sr int32 (a query's) fit in a block's
// shared memory, else 0.
extern "C" int dss_mesh_merge_fits(long long n_sp, long long sr) {
  return merge_smem(n_sp, sr, true) <= kSmemMax ? 1 : 0;
}

// Launches K1 over items [item0, item0 + n_items) of the s * q (shard,
// query) items on `stream` and returns cudaGetLastError() (or the error of
// raising the shared-memory limit).  Pointers as in QueryArgs; qowner, and
// dkey/dent with pd 0, may be null; scratch null puts each warp's hit
// buffer of `buf` int32 in shared memory, else scratch holds n_items * buf
// int32.  slots is unused in count mode.
extern "C" int dss_mesh_query(
    const void* pkey, const void* pent, int p, int cap, const void* dkey,
    const void* dent, int pd, int dcap, const void* alo, const void* ahi,
    const void* t0, const void* t1, const void* active, const void* owner,
    const void* keys, int k, const void* qalo, const void* qahi,
    const void* qt0, const void* qt1, const void* now, const void* qowner,
    int s, int q, int r, int count_mode, int buf, void* scratch,
    long long item0, long long n_items, void* slots, void* count,
    void* stream) {
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
  a.alo = static_cast<const float*>(alo);
  a.ahi = static_cast<const float*>(ahi);
  a.t0 = static_cast<const int64_t*>(t0);
  a.t1 = static_cast<const int64_t*>(t1);
  a.active = static_cast<const uint8_t*>(active);
  a.owner = static_cast<const int32_t*>(owner);
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
  const long long bytes = query_smem(buf, count_mode, !scratch);
  cudaError_t err = allow_smem(mesh_query_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (n_items + kWarps - 1) / kWarps;
  mesh_query_kernel<<<static_cast<unsigned>(grid), kWarps * 32,
                      static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 over the q queries of one dp row on `stream` and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
// acc must hold n_sp + 1 zeros; scratch null puts each warp's n_sp * sr
// int32 buffer in shared memory, else scratch holds q * n_sp * sr int32.
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
  a.buf = n_sp * sr;
  a.scratch = static_cast<int32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.ovf = static_cast<uint8_t*>(ovf);
  a.kept = static_cast<int32_t*>(kept);
  a.acc = static_cast<int32_t*>(acc);
  const long long bytes = merge_smem(n_sp, sr, !scratch);
  cudaError_t err = allow_smem(mesh_merge_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mesh_merge_kernel<<<(q + kWarps - 1) / kWarps, kWarps * 32,
                      static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

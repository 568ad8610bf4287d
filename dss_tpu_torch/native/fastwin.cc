// Native window packing + hit decoding for the fused device path
// (dss_tpu_torch/ops/fastpath.py FastTable.submit/collect; the port's
// copy of the reference's dss_tpu/native/fastwin.cc).  These are the
// two host-CPU stages that bound pipelined fused throughput on a
// small host: expanding every query key's postings run into 128-lane
// device windows (~22 ms/8k-query batch in numpy: 65k binary searches
// + ragged repeats) and turning the compacted hit words back into
// (query, slot) pairs (~8 ms of popcount/ctz numpy).  Each mirrors
// the numpy math step-for-step — same integer ops on the same values,
// identical output ORDER — so results are bit-identical;
// tests/test_torch_native.py pins both differentially.
//
// Two-phase window build: dss_win_ranges runs the binary searches
// once and parks [lo, hi) per (query, cell) pair in caller scratch
// (plus the total window count, so Python can size the pow2-bucket
// upload buffer); dss_win_expand then fills the packed rows without
// re-searching.

#include <cstdint>

namespace {

inline int64_t lower_bound_i32(const int32_t* a, int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

inline int64_t upper_bound_i32(const int32_t* a, int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

inline int64_t lower_bound_range(
    const int32_t* a, int64_t lo, int64_t hi, int32_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace

namespace {

// Run end for a key known to start at lo (host_key[lo] == k): gallop
// forward over the contiguous run — probes ride the hardware
// prefetcher instead of paying random-access misses.  Requires
// k < INT32_MAX (DAR keys are 30-bit; pads are negative and never
// reach here).
inline int64_t run_end(
    const int32_t* a, int64_t n, int64_t lo, int32_t k) {
  int64_t step = 1;
  int64_t prev = lo;
  int64_t probe = lo + 1;
  while (probe < n && a[probe] <= k) {
    prev = probe;
    step <<= 1;
    probe = lo + step;
  }
  if (probe > n) probe = n;
  return lower_bound_range(a, prev + 1, probe, k + 1);
}

}  // namespace

extern "C" {

// Shared internal (cross-TU within libdsscover.so, not a public API):
// one key's [lo, hi) postings run via the sampled two-level lower
// bound + galloping run end.  Pass n_sample = 0 for the flat search.
void dss_internal_key_run(
    const int32_t* host_key, int64_t n_post,
    const int32_t* sample, int64_t n_sample, int64_t stride,
    const int32_t* sample0, int64_t n_s0, int64_t stride0,
    int32_t k, int64_t* out_lo, int64_t* out_hi) {
  int64_t lo;
  if (n_sample > 0) {
    int64_t s_lo = 0, s_hi = n_sample;
    if (n_s0 > 0) {
      const int64_t j0 = lower_bound_i32(sample0, n_s0, k);
      s_lo = j0 == 0 ? 0 : (j0 - 1) * stride0 + 1;
      s_hi = j0 * stride0 + 1;
      if (s_hi > n_sample) s_hi = n_sample;
    }
    const int64_t j = lower_bound_range(sample, s_lo, s_hi, k);
    const int64_t leaf_lo = j == 0 ? 0 : (j - 1) * stride + 1;
    int64_t leaf_hi = j * stride + 1;
    if (leaf_hi > n_post) leaf_hi = n_post;
    lo = lower_bound_range(host_key, leaf_lo, leaf_hi, k);
  } else {
    lo = lower_bound_i32(host_key, n_post, k);
  }
  *out_lo = lo;
  *out_hi = (lo < n_post && host_key[lo] == k)
                ? run_end(host_key, n_post, lo, k)
                : lo;
}

// Postings-range lookup for n flattened query keys (pad keys -1 find
// empty ranges).  Fills out_lo/out_hi (caller scratch, length n) and
// returns the total 128-block window count over non-empty runs —
// exactly sum((hi-1)/block - lo/block + 1).
//
// A flat binary search over millions of postings is memory-latency
// bound (~8 uncached probes x ~100 ns x 65k keys ~ 20 ms/batch), so
// the caller passes a 1/stride sampled copy of the key column
// (sample[i] = host_key[i*stride]; 1M/64 = 64 KB — L2-resident).
// Each lookup searches the sample, then one stride-sized leaf slice
// (1-2 cache lines), then finds the run end by galloping forward over
// the contiguous run — ~2 cold lines per key instead of ~8.  Pass
// n_sample = 0 to fall back to the flat search (small tables).

int64_t dss_win_ranges(
    const int32_t* host_key, int64_t n_post,
    const int32_t* sample, int64_t n_sample, int64_t stride,
    const int32_t* sample0_in, int64_t n_s0_in,
    const int32_t* qkeys, int64_t n, int64_t block,
    int64_t* out_lo, int64_t* out_hi) {
  int64_t nw = 0;
  if (n_sample <= 0) {
    // small table: flat searches are already cache-resident
    for (int64_t i = 0; i < n; ++i) {
      dss_internal_key_run(
          host_key, n_post, nullptr, 0, 0, nullptr, 0, 0,
          qkeys[i], &out_lo[i], &out_hi[i]);
      const int64_t lo = out_lo[i], hi = out_hi[i];
      if (hi > lo) nw += (hi - 1) / block - lo / block + 1;
    }
    return nw;
  }
  // The per-key search is latency-bound (a dependent chain of probes,
  // half of them mispredicted branches), so run G searches in
  // lockstep: branchless (cmov) rounds over the L2-resident sample,
  // prefetch each key's leaf slice, then branchless rounds within the
  // leaf — the G keys' cache misses overlap instead of serializing.
  constexpr int G = 16;
  // At 8M postings the 1/64 sample is itself ~500 KB (bigger than
  // L2), so derive one more 1/64 level on the fly (~8 KB — L1) and
  // search top-down: L1 rounds, then one prefetched sample slice,
  // then one prefetched host_key slice, then the gallop.  Every
  // random-access stage runs G keys in lockstep so misses overlap.
  const int64_t stride0 = 64;
  int64_t n_s0 = n_s0_in;
  const int32_t* sample0 = sample0_in;
  int32_t* owned = nullptr;
  if (n_s0 <= 0) {  // caller didn't cache the top level: derive it
    n_s0 = (n_sample + stride0 - 1) / stride0;
    owned = new int32_t[n_s0 > 0 ? n_s0 : 1];
    for (int64_t i = 0; i < n_s0; ++i) owned[i] = sample[i * stride0];
    sample0 = owned;
  }
  int top_rounds = 0;
  while ((int64_t{1} << top_rounds) < n_s0 + 1) ++top_rounds;
  int64_t lo_[G], hi_[G];
  int32_t key_[G];
  for (int64_t base = 0; base < n; base += G) {
    const int g_n = static_cast<int>(n - base < G ? n - base : G);
    for (int g = 0; g < g_n; ++g) {
      key_[g] = qkeys[base + g];
      lo_[g] = 0;
      hi_[g] = n_s0;
    }
    for (int r = 0; r < top_rounds; ++r) {
      for (int g = 0; g < g_n; ++g) {
        const int64_t lo = lo_[g], hi = hi_[g];
        const int64_t mid = (lo + hi) >> 1;
        const bool active = lo < hi;
        const bool lt = active && sample0[mid] < key_[g];
        lo_[g] = lt ? mid + 1 : lo;
        hi_[g] = active && !lt ? mid : hi_[g];
      }
    }
    // sample0[j] = sample[j*stride0] is the first level-0 entry >=
    // key, so key's sample lower bound lives in the slice
    // ((j-1)*stride0, j*stride0] — prefetch all G slices, then count.
    for (int g = 0; g < g_n; ++g) {
      const int64_t j = lo_[g];
      const int64_t s_lo = j == 0 ? 0 : (j - 1) * stride0 + 1;
      int64_t s_hi = j * stride0 + 1;
      if (s_hi > n_sample) s_hi = n_sample;
      lo_[g] = s_lo;
      hi_[g] = s_hi;
      for (int64_t off = s_lo; off < s_hi; off += 16) {
        __builtin_prefetch(&sample[off]);
      }
    }
    for (int g = 0; g < g_n; ++g) {
      const int64_t s_lo = lo_[g], s_hi = hi_[g];
      const int32_t k = key_[g];
      int64_t cnt = 0;
      for (int64_t off = s_lo; off < s_hi; ++off) {
        cnt += sample[off] < k;
      }
      lo_[g] = s_lo + cnt;  // = lower_bound(sample, k)
    }
    // sample[j] = host_key[j*stride]: same bracketing one level down
    for (int g = 0; g < g_n; ++g) {
      const int64_t j = lo_[g];
      const int64_t leaf_lo = j == 0 ? 0 : (j - 1) * stride + 1;
      int64_t leaf_hi = j * stride + 1;
      if (leaf_hi > n_post) leaf_hi = n_post;
      lo_[g] = leaf_lo;
      hi_[g] = leaf_hi;
      for (int64_t off = leaf_lo; off < leaf_hi; off += 16) {
        __builtin_prefetch(&host_key[off]);
      }
    }
    for (int g = 0; g < g_n; ++g) {
      // leaf lower bound as a branchless vectorizable count of
      // elements < key: the slice's cache lines are prefetched and
      // read whole either way, and the count loop autovectorizes
      const int64_t leaf_lo = lo_[g], leaf_hi = hi_[g];
      const int32_t k = key_[g];
      int64_t cnt = 0;
      for (int64_t off = leaf_lo; off < leaf_hi; ++off) {
        cnt += host_key[off] < k;
      }
      lo_[g] = leaf_lo + cnt;
    }
    for (int g = 0; g < g_n; ++g) {
      const int64_t lo = lo_[g];
      const int32_t k = key_[g];
      const int64_t hi = (lo < n_post && host_key[lo] == k)
                             ? run_end(host_key, n_post, lo, k)
                             : lo;
      out_lo[base + g] = lo;
      out_hi[base + g] = hi;
      if (hi > lo) nw += (hi - 1) / block - lo / block + 1;
    }
  }
  delete[] owned;
  return nw;
}

// Expand the ranges into packed window rows.  wins_blk / wins_meta are
// the two rows of the (2, bucket) i32 upload (caller pre-zeroes the
// pad tail); win_q / win_blk are the host-side decode arrays.  w is
// the per-query key width (query index of pair i == i / w).  Returns
// the window count, or -1 if it would exceed cap (callers size cap
// from dss_win_ranges, so that is a programming error, not data).
int64_t dss_win_expand(
    const int64_t* lo, const int64_t* hi, int64_t n,
    int32_t w, int64_t block,
    int32_t* wins_blk, int32_t* wins_meta,
    int32_t* win_q, int32_t* win_blk, int64_t cap) {
  int64_t nw = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t l = lo[i], h = hi[i];
    if (h <= l) continue;
    const int32_t q = static_cast<int32_t>(i / w);
    const int64_t first = l / block;
    const int64_t last = (h - 1) / block;
    for (int64_t b = first; b <= last; ++b) {
      if (nw >= cap) return -1;
      const int64_t blk0 = b * block;
      int64_t s = l - blk0;
      if (s < 0) s = 0;
      int64_t e = h - blk0;
      if (e > block) e = block;
      const int32_t blk = static_cast<int32_t>(b);
      wins_blk[nw] = blk;
      wins_meta[nw] = static_cast<int32_t>(s) |
                      (static_cast<int32_t>(e) << 8) | (q << 16);
      win_q[nw] = q;
      win_blk[nw] = blk;
      ++nw;
    }
  }
  return nw;
}

// Total set bits over the hit words — the decode output capacity.
int64_t dss_hit_total(const uint32_t* bits, int64_t n_words) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_words; ++i) {
    total += __builtin_popcount(bits[i]);
  }
  return total;
}

// Compacted hit words -> exact (query, slot) pairs, in the numpy
// path's order (word-major, ascending bit position), dropping pad
// lanes (offset >= n_postings) and post-build tombstones (!slot_live).
// words_shift = log2(words per window); block = postings per block.
// Returns the emitted pair count (<= cap = dss_hit_total).
int64_t dss_decode_hits(
    const int32_t* wordpos, const uint32_t* bits, int64_t n_words,
    const int32_t* win_q, const int32_t* win_blk,
    int64_t words_shift, int64_t block,
    const int32_t* host_ent, int64_t n_postings,
    const uint8_t* slot_live,
    int64_t* out_qidx, int64_t* out_slots, int64_t cap) {
  const int64_t words_mask = (int64_t{1} << words_shift) - 1;
  int64_t n_out = 0;
  for (int64_t i = 0; i < n_words; ++i) {
    const int64_t wp = wordpos[i];
    const int64_t win = wp >> words_shift;
    const int64_t lane_base = (wp & words_mask) << 5;
    const int64_t blk0 = static_cast<int64_t>(win_blk[win]) * block;
    uint32_t v = bits[i];
    while (v) {
      const int b = __builtin_ctz(v);
      v &= v - 1;
      const int64_t off = blk0 + lane_base + b;
      if (off >= n_postings) continue;
      const int32_t slot = host_ent[off];
      if (!slot_live[slot]) continue;
      if (n_out >= cap) return -1;  // unreachable when cap >= popcount
      out_qidx[n_out] = win_q[win];
      out_slots[n_out] = slot;
      ++n_out;
    }
  }
  return n_out;
}

}  // extern "C"

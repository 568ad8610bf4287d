// Native host-path query for FastTable (dss_tpu_torch/ops/fastpath.py
// query_host + host_candidates; the port's copy of the reference's
// dss_tpu/native/hostquery.cc): the exact small-batch answer path
// that serves point lookups and conflict prechecks without a device
// round trip.  Mirrors the numpy semantics comparison-for-comparison
// (same IEEE float/int compares on the same values — bit-identical
// verdicts); tests/test_torch_native.py pins it differentially.
//
// The numpy version costs ~0.2 ms at 1k entities and ~3 ms at 1M
// (dozens of array dispatches); this is one GIL-released call doing
// binary searches + a linear candidate scan (~5-40 us).

#include <cstdint>

// Shared sampled range lookup (fastwin.cc, same shared library):
// two-level lower bound + galloping run end — ~2 cold cache lines per
// key instead of ~8 flat binary-search misses at millions of postings.
extern "C" void dss_internal_key_run(
    const int32_t* host_key, int64_t n_post,
    const int32_t* sample, int64_t n_sample, int64_t stride,
    const int32_t* sample0, int64_t n_s0, int64_t stride0,
    int32_t k, int64_t* out_lo, int64_t* out_hi);

extern "C" {

// Exact host query over the sorted postings + exact slot columns.
//   qkeys: (B, W) int32, pad -1 (pads find empty ranges and drop out)
//   sample / sample0: optional cached host_key[::stride] /
//     sample[::64] index levels (n_sample = 0 -> flat searches)
//   scratch_lo / scratch_hi: caller buffers, length b*w (the ranges
//     are found once and shared by the gate and filter passes)
//   out_qidx / out_slot: caller buffers with capacity out_cap
// Returns the emitted pair count, or -1 when the candidate total
// exceeds max_candidates (caller takes the device path — the same
// HOST_MAX_CANDIDATES gate as fastpath.host_candidates).
int64_t dss_query_host(
    const int32_t* host_key, const int32_t* host_ent,
    const uint8_t* host_live, int64_t n_post,
    const uint8_t* slot_live, const float* slot_alo,
    const float* slot_ahi, const int64_t* slot_t0,
    const int64_t* slot_t1,
    const int32_t* qkeys, int32_t b, int32_t w,
    const float* q_alo, const float* q_ahi,
    const int64_t* q_t0, const int64_t* q_t1, const int64_t* q_now,
    const int32_t* sample, int64_t n_sample, int64_t stride,
    const int32_t* sample0, int64_t n_s0,
    int64_t* scratch_lo, int64_t* scratch_hi,
    int64_t max_candidates,
    int64_t* out_qidx, int32_t* out_slot, int64_t out_cap) {
  // pass 1: ranges + candidate total (the host/device routing gate)
  int64_t total = 0;
  for (int64_t i = 0; i < int64_t{b} * w; ++i) {
    dss_internal_key_run(
        host_key, n_post, sample, n_sample, stride, sample0, n_s0, 64,
        qkeys[i], &scratch_lo[i], &scratch_hi[i]);
    total += scratch_hi[i] - scratch_lo[i];
    if (total > max_candidates) return -1;
  }
  // pass 2: exact filter (identical compares to fastpath.query_host)
  int64_t n_out = 0;
  for (int32_t q = 0; q < b; ++q) {
    const float alo = q_alo[q];
    const float ahi = q_ahi[q];
    const int64_t t1min =
        q_t0[q] > q_now[q] ? q_t0[q] : q_now[q];  // max(t_start, now)
    const int64_t te = q_t1[q];
    for (int32_t j = 0; j < w; ++j) {
      const int64_t lo = scratch_lo[q * w + j];
      const int64_t hi = scratch_hi[q * w + j];
      for (int64_t off = lo; off < hi; ++off) {
        const int32_t slot = host_ent[off];
        if (!host_live[off]) continue;
        if (!slot_live[slot]) continue;
        if (!(slot_ahi[slot] >= alo)) continue;
        if (!(slot_alo[slot] <= ahi)) continue;
        if (!(slot_t1[slot] >= t1min)) continue;
        if (!(slot_t0[slot] <= te)) continue;
        if (n_out >= out_cap) return -1;  // cap: route to the device
        out_qidx[n_out] = q;
        out_slot[n_out] = slot;
        ++n_out;
      }
    }
  }
  return n_out;
}

}  // extern "C"

"""Online EWMA route-cost estimates — the planner's learned inputs.

A copy of the reference's `dss_tpu/plan/costs.py`, equal in behavior
(tests/test_torch_planner.py).  The prediction formulas live in
module-level functions shared with planner.ModelState, so the live
model and a recorded state snapshot can never disagree about what a
route is predicted to cost.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "CostModel",
    "chunks_of",
    "predict_device_ms",
    "predict_host_ms",
    "predict_resident_latency_ms",
    "predict_resident_ms",
    "predict_rqmatch_ms",
    "predict_shm_ms",
]


def chunks_of(n: int, chunk: int) -> int:
    """ceil(n / chunk), floored at one chunk."""
    return max(1, -(-int(n) // max(1, int(chunk))))


def predict_device_ms(
    floor_ms: float, item_ms: float, n: int, inflight: int = 0
) -> float:
    # batches already in the device stream must clear first; with
    # the double-buffered pipeline each adds ~a floor of wait
    return floor_ms * (1 + max(0, int(inflight))) + item_ms * n


def predict_resident_ms(
    res_floor_ms: float, item_ms: float, n: int, inflight: int = 0
) -> float:
    # THROUGHPUT view: the resident stream pipelines, so each batch
    # already queued at the loop adds ~one resident floor of wait,
    # not a cold floor.  Use for bulk routing / drain pacing.
    return res_floor_ms * (1 + max(0, int(inflight))) + item_ms * n


def predict_resident_latency_ms(
    res_lat_ms: float, res_floor_ms: float, item_ms: float,
    n: int, inflight: int = 0,
) -> float:
    # LATENCY view: one full stream round trip (pipelining never
    # removes it) plus a floor of queue wait per batch ahead.  Use
    # for headroom (deadline) comparisons.
    return res_lat_ms + res_floor_ms * max(0, int(inflight)) + item_ms * n


def predict_rqmatch_ms(
    rq_floor_ms: float, rq_item_ms: float, n: int, inflight: int = 0
) -> float:
    # reverse-query matching (push/match.py): the SAME fused geometry
    # kernel with query and data roles swapped — a batch of write-side
    # match volumes scanned against the subscription DAR.  Same
    # pipeline shape as a cold read dispatch, so the formula is the
    # device one; its OWN keys because the subscription table is a
    # different (usually far smaller) resident set than the entity
    # tiers, and letting read-side observations price write-side
    # matching would mis-route whichever side runs less often.
    return rq_floor_ms * (1 + max(0, int(inflight))) + rq_item_ms * n


def predict_shm_ms(
    rtt_ms: float, owner_serve_ms: float, inflight: int = 0,
    owner_threads: int = 2,
) -> float:
    # shared-memory ring round trip (parallel/shmring.py): one slot
    # publish + owner turnaround + response spin.  Requests already in
    # this worker's ring queue ahead of us serialize across the
    # owner's serve pool, so each adds ~a serve time divided by the
    # pool width.  The same formula prices the worker's shm-vs-proxy
    # decision (plan/shmroute.py) and the autotune depth sweep.
    return rtt_ms + owner_serve_ms * (
        max(0, int(inflight)) / max(1, int(owner_threads))
    )


def predict_host_ms(
    chunk_ms: float, floor_ms: float, chunk: int, n: int,
    inflight_chunks: int = 0, inflight_device: int = 0,
) -> float:
    # work already queued at the single collect thread serializes
    # ahead of this batch: forced host chunks scan there, and a
    # pending DEVICE batch blocks it in wait_device() for ~a floor
    # — without both terms a host batch behind a predecessor would
    # be predicted at a fraction of its real completion
    return (
        (chunks_of(n, chunk) + max(0, int(inflight_chunks))) * chunk_ms
        + max(0, int(inflight_device)) * floor_ms
    )


class CostModel:
    """Online EWMA cost estimates for the three serving routes.

    Four scalars, seeded at boot (DSS_CO_EST_* knobs) and updated
    from every completed batch:

      est_floor_ms — the COLD device dispatch floor: what one
          fused-kernel round trip costs before any per-query work.
      est_item_ms  — marginal device cost per batched query on top of
          the floor (device batch time modeled as floor + item * n).
      est_chunk_ms — one warmed-bucket exact host scan
          (FastTable.query_host_chunked serves an n-item batch as
          ceil(n / chunk) of these).
      est_res_floor_ms — the RESIDENT dispatch floor: the steady-state
          marginal per-batch cost of the resident loop's device stream
          (ops/resident.py — captured CUDA graphs + static buffers +
          pipelined feeder).  Its OWN key on purpose: resident observations
          never feed the cold floor and vice versa — with one shared
          floor, whichever route runs more would drag the estimate
          toward itself and poison routing for the other (a resident
          steady state would make cold dispatches look free; one cold
          dispatch would make the resident stream look floor-bound).
      est_res_lat_ms — the resident stream's full per-batch LATENCY
          (submit -> delivered), tracked separately from the floor:
          pipelining amortizes *dispatch cost* but every batch still
          rides one full round trip, so on a high-RTT host the stream
          drains at floor rates while each batch takes ~RTT wall
          clock.  Headroom (deadline) decisions use the latency;
          throughput decisions (bulk routing, Retry-After, drain
          pacing) use the floor.  Conflating them would route
          fresh-SLO traffic into a stream it can never make deadlines
          through.

    The cold-device pair is an exponentially-forgetting online
    least-squares fit over observed (n, total_ms) pairs: the EWMA
    first/second moments give slope = cov(n, t) / var(n) and floor =
    mean(t) - slope * mean(n).  While every batch is the same size,
    var(n) ~ 0 and the seed slope stands with the floor absorbing the
    level (the prediction AT observed sizes is exact, which is what
    the router compares against headroom); mixed sizes disambiguate
    the split.  The resident floor is a plain EWMA of the observed
    level minus the (shared) per-item slope — the compute cost per
    query is the same kernel either way; only the dispatch differs."""

    __slots__ = ("alpha", "chunk", "est_floor_ms", "est_item_ms",
                 "est_chunk_ms", "est_res_floor_ms", "est_res_lat_ms",
                 "est_rq_floor_ms", "est_rq_item_ms",
                 "device_obs", "host_obs", "resident_obs", "rqmatch_obs",
                 "_sn", "_st", "_snn", "_snt")

    def __init__(self, *, floor_ms: float = 20.0, item_ms: float = 0.02,
                 chunk_ms: float = 0.3, chunk: int = 64,
                 alpha: float = 0.2,
                 res_floor_ms: Optional[float] = None,
                 res_lat_ms: Optional[float] = None,
                 rq_floor_ms: Optional[float] = None,
                 rq_item_ms: Optional[float] = None):
        self.alpha = float(alpha)
        self.chunk = max(1, int(chunk))
        self.est_floor_ms = float(floor_ms)
        self.est_item_ms = float(item_ms)
        self.est_chunk_ms = float(chunk_ms)
        # default resident seed: the cold floor amortized over the
        # loop's default in-flight window — deliberately conservative
        # (a quarter, not a tenth) so the first resident batches must
        # EARN a lower floor before the router leans on it
        self.est_res_floor_ms = (
            self.est_floor_ms / 4.0
            if res_floor_ms is None
            else float(res_floor_ms)
        )
        # latency seed: a batch entering an idle stream pays one full
        # round trip — the cold floor is the honest prior, so
        # high-RTT hosts don't bet fresh deadlines on the stream until
        # it has MEASURED low latency
        self.est_res_lat_ms = (
            self.est_floor_ms if res_lat_ms is None else float(res_lat_ms)
        )
        # reverse-query (rqmatch) seeds: the same fused kernel, so the
        # cold dispatch floor is the honest prior until write-side
        # matching has produced its own observations; the per-item
        # slope starts at the read slope for the same reason
        self.est_rq_floor_ms = (
            self.est_floor_ms if rq_floor_ms is None else float(rq_floor_ms)
        )
        self.est_rq_item_ms = (
            self.est_item_ms if rq_item_ms is None else float(rq_item_ms)
        )
        self.device_obs = 0
        self.host_obs = 0
        self.resident_obs = 0
        self.rqmatch_obs = 0
        # EWMA moments of (n, total_ms) for the device fit, primed
        # from the seed (at a representative batch size) so the first
        # observations BLEND into the seeded estimate instead of
        # replacing it wholesale
        n0 = float(4 * self.chunk)
        t0 = self.est_floor_ms + self.est_item_ms * n0
        self._sn = n0
        self._st = t0
        self._snn = n0 * n0
        self._snt = n0 * t0

    def _chunks(self, n: int) -> int:
        return chunks_of(n, self.chunk)

    def reseed(self, *, floor_ms: Optional[float] = None,
               item_ms: Optional[float] = None,
               chunk_ms: Optional[float] = None,
               res_floor_ms: Optional[float] = None,
               res_lat_ms: Optional[float] = None,
               rq_floor_ms: Optional[float] = None,
               rq_item_ms: Optional[float] = None) -> None:
        """Jump estimates to externally MEASURED values — the tune
        actuator's hot-swap seam.  Unlike observe_*,
        which winsorizes each sample to 4x the current prediction (a
        genuine workload flip therefore converges only as fast as the
        clamp ratchets), a reseed lands in one step: the tuner fitted
        the new value from an unclamped whole-front histogram window,
        so the usual single-outlier defense does not apply.  When the
        cold-device pair changes, the EWMA moments are re-primed from
        the new seed (exactly as __init__ does) so subsequent
        observations BLEND forward from it instead of snapping the fit
        back to the pre-swap line.  None leaves a key untouched."""
        if floor_ms is not None:
            self.est_floor_ms = max(0.05, float(floor_ms))
        if item_ms is not None:
            self.est_item_ms = max(0.0, float(item_ms))
        if chunk_ms is not None:
            self.est_chunk_ms = max(1e-3, float(chunk_ms))
        if res_floor_ms is not None:
            self.est_res_floor_ms = max(0.02, float(res_floor_ms))
        if res_lat_ms is not None:
            self.est_res_lat_ms = max(0.02, float(res_lat_ms))
        if rq_floor_ms is not None:
            self.est_rq_floor_ms = max(0.02, float(rq_floor_ms))
        if rq_item_ms is not None:
            self.est_rq_item_ms = max(0.0, float(rq_item_ms))
        if floor_ms is not None or item_ms is not None:
            n0 = float(4 * self.chunk)
            t0 = self.est_floor_ms + self.est_item_ms * n0
            self._sn = n0
            self._st = t0
            self._snn = n0 * n0
            self._snt = n0 * t0

    def observe_device(self, n: int, total_ms: float) -> None:
        a = self.alpha
        n = float(max(1, n))
        # winsorize: one outlier batch (a stall that costs seconds
        # against a millisecond floor) must not poison the
        # floor estimate — under fresh-SLO-only traffic a poisoned-high
        # floor routes everything hostward and the device is never
        # re-sampled to correct it.  Clamping each observation to 4x
        # the current prediction bounds a single outlier's pull while
        # a GENUINE floor shift still converges (the clamp ratchets up
        # with the prediction each step).
        total_ms = min(
            float(total_ms), 4.0 * max(self.predict_device_ms(n), 0.05)
        )
        self._sn += a * (n - self._sn)
        self._st += a * (total_ms - self._st)
        self._snn += a * (n * n - self._snn)
        self._snt += a * (n * total_ms - self._snt)
        var = self._snn - self._sn * self._sn
        if var > 1e-6 * max(self._snn, 1.0):
            self.est_item_ms = max(
                0.0, (self._snt - self._sn * self._st) / var
            )
        # else: single-size traffic so far — keep the seeded slope
        self.est_floor_ms = max(
            0.05, self._st - self.est_item_ms * self._sn
        )
        self.device_obs += 1

    def observe_host(self, n: int, total_ms: float) -> None:
        per = total_ms / self._chunks(n)
        self.est_chunk_ms += self.alpha * (per - self.est_chunk_ms)
        self.host_obs += 1

    def observe_resident(self, n: int, gap_ms: float,
                         lat_ms: Optional[float] = None) -> None:
        """Feed ONLY the resident keys: gap_ms is the loop's marginal
        per-batch cost (inter-completion gap), so level = gap -
        item * n is the amortized dispatch floor; lat_ms is the full
        submit->delivered wall time feeding the latency EWMA the
        deadline comparisons use.  Both winsorized like the cold fit —
        one stall (GC pause, a capture on another thread) must not route a steady
        stream hostward."""
        gap_ms = min(
            float(gap_ms),
            4.0 * max(self.predict_resident_ms(n), 0.05),
        )
        lvl = gap_ms - self.est_item_ms * float(max(1, n))
        self.est_res_floor_ms = max(
            0.02,
            self.est_res_floor_ms
            + self.alpha * (lvl - self.est_res_floor_ms),
        )
        if lat_ms is not None:
            lat_ms = min(
                float(lat_ms),
                4.0 * max(self.predict_resident_latency_ms(n), 0.05),
            )
            lat_lvl = lat_ms - self.est_item_ms * float(max(1, n))
            self.est_res_lat_ms = max(
                0.02,
                self.est_res_lat_ms
                + self.alpha * (lat_lvl - self.est_res_lat_ms),
            )
        self.resident_obs += 1

    def observe_rqmatch(self, n: int, total_ms: float) -> None:
        """Feed ONLY the rqmatch keys: the subscription table's match
        dispatches never drag the read-side floor and vice versa (same
        isolation argument as the resident keys).  Winsorized like the
        other fits — one unwarmed-bucket compile on the subscription
        DAR must not route every write's matching hostward."""
        n = float(max(1, n))
        total_ms = min(
            float(total_ms), 4.0 * max(self.predict_rqmatch_ms(n), 0.05)
        )
        lvl = total_ms - self.est_rq_item_ms * n
        self.est_rq_floor_ms = max(
            0.02,
            self.est_rq_floor_ms
            + self.alpha * (lvl - self.est_rq_floor_ms),
        )
        self.rqmatch_obs += 1

    def predict_device_ms(self, n: int, inflight: int = 0) -> float:
        return predict_device_ms(
            self.est_floor_ms, self.est_item_ms, n, inflight
        )

    def predict_resident_ms(self, n: int, inflight: int = 0) -> float:
        return predict_resident_ms(
            self.est_res_floor_ms, self.est_item_ms, n, inflight
        )

    def predict_resident_latency_ms(self, n: int,
                                    inflight: int = 0) -> float:
        return predict_resident_latency_ms(
            self.est_res_lat_ms, self.est_res_floor_ms,
            self.est_item_ms, n, inflight,
        )

    def predict_rqmatch_ms(self, n: int, inflight: int = 0) -> float:
        return predict_rqmatch_ms(
            self.est_rq_floor_ms, self.est_rq_item_ms, n, inflight
        )

    def predict_host_ms(self, n: int, inflight_chunks: int = 0,
                        inflight_device: int = 0) -> float:
        return predict_host_ms(
            self.est_chunk_ms, self.est_floor_ms, self.chunk, n,
            inflight_chunks, inflight_device,
        )

    def host_qps(self) -> float:
        """Host-chunk route drain throughput estimate."""
        return self.chunk / max(self.est_chunk_ms, 1e-3) * 1000.0

    def min_route_qps(self, n: int) -> float:
        """Conservative drain throughput at drain size n: the SLOWER
        of the host/cold-device routes.  Kept for comparison and the
        planner's last-resort fallback; the Retry-After estimate now
        quotes the throughput of the route the planner would actually
        choose for the queued shape (Planner.backlog_qps) instead of
        this unconditional minimum."""
        dev = n / max(self.predict_device_ms(n), 1e-3) * 1000.0
        return min(self.host_qps(), dev)

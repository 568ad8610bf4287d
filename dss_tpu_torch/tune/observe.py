"""Observer: fit route-cost parameters from live stage histograms.

The offline autotuner (plan/autotune.py) measures kernels on an IDLE
host at boot; this module re-fits the same cost scalars from what the
serving stack actually measured under load — the bounded-cardinality
dss_stage_duration_seconds{stage,route} histograms, aggregated across
the whole shm front when one is attached.

The fit is deliberately modest.  A stage histogram records the
DISTRIBUTION of per-batch durations t = floor + slope * n, with the
batch size n unobserved — floor and slope are not identifiable from
the histogram alone.  The decision-trace recorder (tune/shadow.py)
closes the gap: it knows the batch-size moments of the same window, so

    floor ~ q_low(t) - slope * n_min        (small batches pay ~floor)
    slope ~ (mean(t) - floor) / mean(n)     (E[t] = floor + slope*E[n])

solved with one fixed-point pass.  Crude — but the fit only ever
PROPOSES; the shadow evaluator and the guard window (tune/controller)
are what decide, which is the whole design: a cheap analytical model
prunes the knob space (the GOMA / mapper framing in PAPERS.md), and
the guarded actuator keeps a wrong fit from costing more than one
guard window.

Confidence gating lives here: a window with fewer than min_count
observations for a key yields NO fit for it, so thin traffic can never
propose anything (the overnight-idle case — exactly when a boot
profile is still right).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from dss_tpu_torch.obs.metrics import (
    stage_hist_delta,
    stage_hist_quantile,
)

__all__ = ["Observer", "StageFit", "fit_stage"]

# the quantile the floor estimate reads: low enough to sit under the
# bulk of the mass (big batches), high enough to dodge bucket-edge
# noise on small windows
FLOOR_QUANTILE = 0.10


@dataclasses.dataclass(frozen=True)
class StageFit:
    """One (route, stage) key's fitted window: cost-scalar estimates
    plus the distribution summary the guard window compares against."""

    route: str
    stage: str
    count: int
    mean_ms: float
    floor_ms: float  # fitted dispatch floor (low-quantile based)
    slope_ms: float  # fitted per-item cost (0 without size moments)
    p50_ms: float
    p99_ms: float
    # recorded mean batch size of the window's traffic (None without
    # decision-recorder moments) — the proposer needs it to turn a
    # per-BATCH duration into a per-chunk cost
    n_mean: Optional[float] = None


def fit_stage(counts, sum_s: float, cnt: int, *,
              route: str = "", stage: str = "",
              n_mean: Optional[float] = None,
              n_min: Optional[float] = None) -> Optional[StageFit]:
    """Fit one histogram row (cumulative bucket counts, sum, count)
    into a StageFit; None for an empty row.  n_mean/n_min are the
    recorded batch-size moments for the traffic that produced the row
    (from the decision recorder); without them the slope stays 0 and
    the floor is the raw low quantile — still a usable level estimate
    for floor-like knobs."""
    cnt = int(cnt)
    if cnt <= 0:
        return None
    q_floor = stage_hist_quantile(counts, cnt, FLOOR_QUANTILE)
    p50 = stage_hist_quantile(counts, cnt, 0.50)
    p99 = stage_hist_quantile(counts, cnt, 0.99)
    mean_ms = 1000.0 * float(sum_s) / cnt
    q_floor_ms = 1000.0 * (q_floor or 0.0)
    slope_ms = 0.0
    floor_ms = q_floor_ms
    if n_mean is not None and n_mean > 0:
        nm = float(n_mean)
        n0 = max(1.0, float(n_min if n_min is not None else 1.0))
        # one fixed-point pass: slope from the mean identity using the
        # raw quantile as the first floor guess, then the floor
        # corrected for the slope the smallest batches still pay
        if nm > n0:
            slope_ms = max(0.0, (mean_ms - q_floor_ms) / (nm - n0))
        floor_ms = max(0.0, q_floor_ms - slope_ms * n0)
    return StageFit(
        route=route, stage=stage, count=cnt,
        mean_ms=mean_ms, floor_ms=floor_ms, slope_ms=slope_ms,
        p50_ms=1000.0 * (p50 or 0.0), p99_ms=1000.0 * (p99 or 0.0),
        n_mean=None if n_mean is None else float(n_mean),
    )


class Observer:
    """Windows a stage-histogram provider into per-key fits.

    provider() -> {(route, stage): (bucket_counts, sum_s, cnt)} — a
    MetricsRegistry.stage_hist_snapshot, the shm whole-front merge
    (parallel/shmring.shm_stage_hist), or a bench scrape all satisfy
    it.  Each observe() call diffs against the previous snapshot, so a
    fit always describes the traffic BETWEEN ticks, never the
    boot-to-now blur."""

    def __init__(self, provider, *, min_count: int = 200):
        self._provider = provider
        self.min_count = max(1, int(min_count))
        self._last: dict = {}
        self.windows = 0
        self.thin_windows = 0  # windows gated entirely (no fit at all)

    def prime(self) -> None:
        """Swallow the boot-to-now histograms so the first real window
        starts at the controller's first tick."""
        self._last = self._provider() or {}

    def observe(
        self, moments: Optional[Dict[str, Tuple[float, float]]] = None
    ) -> Dict[Tuple[str, str], StageFit]:
        """One window: snapshot, diff, fit every key past the
        confidence gate.  `moments` maps a stage name to recorded
        (n_mean, n_min) batch-size moments for the window."""
        snap = self._provider() or {}
        delta = stage_hist_delta(self._last, snap)
        self._last = snap
        self.windows += 1
        fits: Dict[Tuple[str, str], StageFit] = {}
        for (route, stage), (counts, sum_s, cnt) in delta.items():
            if cnt < self.min_count:
                continue  # the confidence gate: thin traffic fits nothing
            mom = (moments or {}).get(stage)
            fit = fit_stage(
                counts, sum_s, cnt, route=route, stage=stage,
                n_mean=None if mom is None else mom[0],
                n_min=None if mom is None else mom[1],
            )
            if fit is not None:
                fits[(route, stage)] = fit
        if not fits:
            self.thin_windows += 1
        return fits

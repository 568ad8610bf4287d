"""RED metrics with Prometheus text exposition.

Closes the reference's app-metrics gap (its deploy scrapes only CRDB /
Istio; the Go services expose nothing — SURVEY.md §5).  Exposes:

  dss_requests_total{method,route,status}        counter
  dss_request_duration_seconds{method,route}     histogram
  dss_dar_entities / dss_dar_postings / ...      gauges via set_gauge
  dss_dar_<class>_tier_*                         tiered-snapshot gauges
      (tier sizes, shadowed rows, minor-fold vs major-compaction
      counts/durations — DarTable.stats via the index stats)
  dss_dar_<class>_co_*                           serving-pipeline gauges
      (queue/batch/stage series plus the deadline router's route-mix
      counters — co_route_{host,hostchunk,device,resident}_batches —
      co_deadline_shed, the co_est_* live cost-model estimates incl.
      the resident floor, and the resident loop's co_res_* ring /
      graph-cache series — QueryCoalescer.stats via the index stats)

Route labels are templatized (UUID path segments -> ":id") to bound
cardinality.  Scrape at GET /metrics.

A copy of the reference's `dss_tpu/obs/metrics.py`, with the shm
front's stage-histogram mirror and whole-front aggregate.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Tuple

_UUID = re.compile(
    r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}"
    r"-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}"
)
_VERSIONISH = re.compile(r"^[0-9a-z]{10,}$")

BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)

# dss_stage_duration_seconds{stage,route} histogram buckets: finer at
# the microsecond end than the request histogram — cache hits and
# host scans live there, and the per-stage p99 attribution table
# (bench.py http-curve) interpolates inside these
STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0,
)

# bounded stage-label cardinality: sink keys outside this set collapse
# to "other" (a service adding a new stage name cannot mint unbounded
# series; add it here AND — for the shm whole-front blocks — keep
# parallel/shmring.STAGE_SLOTS in lockstep)
STAGE_NAMES = (
    "auth_ms", "covering_ms", "store_ms", "serialize_ms", "service_ms",
    "coalesce_wait_ms", "shm_ring_ms", "proxy_ms", "catchup_ms",
    "push_match_ms", "push_deliver_ms",
    "other",
)
_STAGE_SET = frozenset(STAGE_NAMES)

# bounded route-class cardinality for the fixed-layout shm stage
# blocks (the per-process /metrics keeps full route templates; the
# whole-front aggregate collapses to these three)
ROUTE_CLASSES = ("search", "write", "other")


def stage_name(stage: str) -> str:
    return stage if stage in _STAGE_SET else "other"


def route_class(route: str) -> str:
    """Collapse a templatized route onto the fixed-cardinality class
    set the shm stage-histogram blocks are laid out over.  Routes
    arrive as aiohttp canonical patterns ("/v1/dss/.../{id}") from the
    access log, or as route_template output (":id") from raw paths —
    both placeholder spellings mark the per-entity class."""
    if "query" in route:
        return "search"
    if "{" in route or ":id" in route or ":version" in route:
        return "write"
    if route.startswith("/v1/dss/"):
        return "search"
    return "other"


def route_template(path: str) -> str:
    parts = path.split("/")
    out = []
    for p in parts:
        if _UUID.fullmatch(p):
            out.append(":id")
        elif _VERSIONISH.fullmatch(p) and len(out) >= 2 and out[-1] == ":id":
            out.append(":version")
        else:
            out.append(p)
    return "/".join(out)


def _esc_label(v) -> str:
    """Prometheus exposition-format label escaping (backslash, quote,
    newline)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class MetricsRegistry:
    def __init__(self, proc: str = None):
        # proc: constant `process` label stamped on every series.
        # REQUIRED in multi-process serving (--workers): the processes
        # share one port via SO_REUSEPORT, so consecutive scrapes land
        # on different processes' registries — without a
        # distinguishing label the series would appear to reset on
        # every scrape.  The leader additionally aggregates every
        # worker's shm stats block into dss_shm_worker_*{process}
        # families (parallel/shmring.ShmOwner.stats), so one scrape of
        # ANY process sees the whole front's counters coherently.
        self._proc = proc
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str, int], int] = {}
        self._hist: Dict[Tuple[str, str], list] = {}
        self._hist_sum: Dict[Tuple[str, str], float] = {}
        self._hist_cnt: Dict[Tuple[str, str], int] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_vecs: Dict[str, Tuple[str, Dict[str, float]]] = {}
        self._scalar_counters: Dict[str, float] = {}
        self._infos: Dict[str, Dict[str, str]] = {}
        self._stage_sum: Dict[Tuple[str, str], float] = {}
        self._stage_cnt: Dict[Tuple[str, str], int] = {}
        # dss_stage_duration_seconds{stage,route}: (route, stage) ->
        # [bucket counts..., sum_s, count]
        self._shist: Dict[Tuple[str, str], list] = {}
        # optional shm mirror (parallel/shmring.StageHistWriter): each
        # observation also lands in this process's shared block so ANY
        # process of the front can render the whole front's histograms
        self._stage_writer = None
        # optional whole-front aggregate provider: when set, render()
        # emits dss_stage_duration_seconds from it (merged across the
        # shm blocks, no process label — every process of the front
        # then exports the SAME coherent family, the dss_shm_worker_*
        # pattern) instead of the local-only histograms
        self._stage_agg = None

    def observe_request(
        self, method: str, path: str, status: int, duration_s: float
    ) -> None:
        route = route_template(path)
        with self._lock:
            k = (method, route, status)
            self._counters[k] = self._counters.get(k, 0) + 1
            hk = (method, route)
            if hk not in self._hist:
                self._hist[hk] = [0] * len(BUCKETS)
                self._hist_sum[hk] = 0.0
                self._hist_cnt[hk] = 0
            for i, b in enumerate(BUCKETS):
                if duration_s <= b:
                    self._hist[hk][i] += 1
            self._hist_sum[hk] += duration_s
            self._hist_cnt[hk] += 1

    def observe_stage(self, route: str, stage: str, duration_s: float) -> None:
        """Per-stage serving-time accounting (parse/auth/covering/
        store/serialize) so the p50 breakdown is measured, not guessed.
        Feeds both the legacy dss_request_stage_seconds summary and the
        dss_stage_duration_seconds{stage,route} histogram — tail
        percentiles per stage, which a sum/count pair cannot give."""
        rt = route_template(route)
        with self._lock:
            k = (rt, stage)
            self._stage_sum[k] = self._stage_sum.get(k, 0.0) + duration_s
            self._stage_cnt[k] = self._stage_cnt.get(k, 0) + 1
            hk = (rt, stage_name(stage))
            row = self._shist.get(hk)
            if row is None:
                row = self._shist[hk] = [0] * (len(STAGE_BUCKETS) + 2)
            for i, b in enumerate(STAGE_BUCKETS):
                if duration_s <= b:
                    row[i] += 1
            row[-2] += duration_s
            row[-1] += 1
        if self._stage_writer is not None:
            # outside the lock: the shm block is single-writer per
            # process and numpy increments are cheap
            self._stage_writer.observe(rt, stage, duration_s)

    def attach_stage_writer(self, writer) -> None:
        """Mirror every stage observation into this process's shared
        stage-histogram block (parallel/shmring.StageHistWriter)."""
        self._stage_writer = writer

    def set_stage_agg(self, provider) -> None:
        """provider() -> {(route, stage): (bucket_counts, sum_s, cnt)}
        merged across the whole front; replaces the local histograms in
        the exposition (see __init__ note)."""
        self._stage_agg = provider

    def stage_hist_snapshot(self) -> Dict[Tuple[str, str], tuple]:
        """{(route, stage): (cumulative bucket counts, sum_s, cnt)} —
        this process's stage histograms, in the SAME shape a whole-front
        shm aggregate provider returns (parallel/shmring.shm_stage_hist)
        and the bench /metrics scrape parses, so the tune observer reads
        any of the three through one seam."""
        with self._lock:
            return {
                k: (tuple(row[:-2]), row[-2], row[-1])
                for k, row in self._shist.items()
            }

    def stage_hist_front(self) -> Dict[Tuple[str, str], tuple]:
        """The widest stage-histogram view this process can see: the
        whole-front shm aggregate when one is wired (set_stage_agg),
        else this process's own histograms.  The tune observer's
        default provider — the tuner fits what the FRONT measured, not
        just the owner process."""
        agg = self._stage_agg
        if agg is not None:
            try:
                return agg() or {}
            except Exception:  # noqa: BLE001 — fall back to local
                pass
        return self.stage_hist_snapshot()

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def set_gauge_vec(
        self, name: str, label: str, values: Dict[str, float]
    ) -> None:
        """Labeled gauge family: <name>{<label>="<key>"} <value> per
        entry (e.g. dss_shard_load{shard="3"} — the per-shard heat the
        skew dashboard panel renders).  Each call replaces the whole
        family, so a shard count change never leaves stale series."""
        with self._lock:
            self._gauge_vecs[name] = (
                label,
                {str(k): float(v) for k, v in values.items()},
            )

    def set_counter(self, name: str, value: float) -> None:
        """Label-less monotonic counter exposed with the proper
        `# TYPE ... counter` so rate()/increase() semantics hold for
        restart-reset series (the region server's failover counters).
        The caller owns monotonicity; this just publishes the value."""
        with self._lock:
            self._scalar_counters[name] = float(value)

    def set_info(self, name: str, labels: Dict[str, str]) -> None:
        """Prometheus info-pattern gauge: <name>{k="v",...} 1 (e.g.
        dss_build_info with commit/host labels)."""
        with self._lock:
            self._infos[name] = dict(labels)

    def render(self) -> str:
        """Prometheus text exposition format.  Every label value is
        escaped: route labels come from request paths (remotely
        supplied), and one bad value must not invalidate the whole
        scrape."""
        lines = []
        pl = (
            "" if self._proc is None
            else f'process="{_esc_label(self._proc)}"'
        )

        def lab(extra: str) -> str:
            if not pl:
                return extra
            return f"{extra},{pl}" if extra else pl
        with self._lock:
            for name, labels in sorted(self._infos.items()):
                l = ",".join(
                    f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items())
                )
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{{{lab(l)}}} 1")
            lines.append("# TYPE dss_requests_total counter")
            for (m, r, s), v in sorted(self._counters.items()):
                l = (
                    f'method="{_esc_label(m)}",'
                    f'route="{_esc_label(r)}",status="{s}"'
                )
                lines.append(f"dss_requests_total{{{lab(l)}}} {v}")
            lines.append(
                "# TYPE dss_request_duration_seconds histogram"
            )
            for hk in sorted(self._hist):
                m, r = hk
                l = lab(
                    f'method="{_esc_label(m)}",route="{_esc_label(r)}"'
                )

                cum = 0
                for i, b in enumerate(BUCKETS):
                    cum = self._hist[hk][i]
                    lines.append(
                        f"dss_request_duration_seconds_bucket{{{l},"
                        f'le="{b}"}} {cum}'
                    )
                lines.append(
                    f"dss_request_duration_seconds_bucket{{{l},"
                    f'le="+Inf"}} {self._hist_cnt[hk]}'
                )
                lines.append(
                    f"dss_request_duration_seconds_sum{{{l}}} "
                    f"{self._hist_sum[hk]:.6f}"
                )
                lines.append(
                    f"dss_request_duration_seconds_count{{{l}}} "
                    f"{self._hist_cnt[hk]}"
                )
            agg = None
            if self._stage_agg is not None:
                try:
                    agg = self._stage_agg()
                except Exception:  # noqa: BLE001 — scrape must survive
                    agg = None
            shist = (
                agg if agg is not None
                else {
                    k: (tuple(row[:-2]), row[-2], row[-1])
                    for k, row in self._shist.items()
                }
            )
            if shist:
                lines.append(
                    "# TYPE dss_stage_duration_seconds histogram"
                )
                for rk in sorted(shist):
                    r, st = rk
                    counts, ssum, scnt = shist[rk]
                    base = (
                        f'route="{_esc_label(r)}",'
                        f'stage="{_esc_label(st)}"'
                    )
                    # whole-front aggregates carry NO process label:
                    # every process exports the same merged family
                    l = base if agg is not None else lab(base)
                    for i, b in enumerate(STAGE_BUCKETS):
                        lines.append(
                            f"dss_stage_duration_seconds_bucket{{{l},"
                            f'le="{b}"}} {counts[i]}'
                        )
                    lines.append(
                        f"dss_stage_duration_seconds_bucket{{{l},"
                        f'le="+Inf"}} {scnt}'
                    )
                    lines.append(
                        f"dss_stage_duration_seconds_sum{{{l}}} "
                        f"{ssum:.6f}"
                    )
                    lines.append(
                        f"dss_stage_duration_seconds_count{{{l}}} "
                        f"{scnt}"
                    )
            if self._stage_cnt:
                lines.append("# TYPE dss_request_stage_seconds summary")
                for k in sorted(self._stage_cnt):
                    r, st = k
                    l = lab(
                        f'route="{_esc_label(r)}",stage="{_esc_label(st)}"'
                    )
                    lines.append(
                        f"dss_request_stage_seconds_sum{{{l}}} "
                        f"{self._stage_sum[k]:.6f}"
                    )
                    lines.append(
                        f"dss_request_stage_seconds_count{{{l}}} "
                        f"{self._stage_cnt[k]}"
                    )
            for name, v in sorted(self._scalar_counters.items()):
                lines.append(f"# TYPE {name} counter")
                if pl:
                    lines.append(f"{name}{{{pl}}} {v}")
                else:
                    lines.append(f"{name} {v}")
            for name, v in sorted(self._gauges.items()):
                lines.append(f"# TYPE {name} gauge")
                if pl:
                    lines.append(f"{name}{{{pl}}} {v}")
                else:
                    lines.append(f"{name} {v}")
            for name, (label, vals) in sorted(self._gauge_vecs.items()):
                lines.append(f"# TYPE {name} gauge")
                for k, v in sorted(vals.items()):
                    l = f'{_esc_label(label)}="{_esc_label(k)}"'
                    # a family keyed BY process (the leader's
                    # aggregated shm worker counters) already carries
                    # the label the constant would duplicate
                    if label != "process":
                        l = lab(l)
                    lines.append(f"{name}{{{l}}} {v}")
        return "\n".join(lines) + "\n"


# -- stage-histogram window math (the tune observer's inputs) -----------------


def stage_hist_delta(h0: dict, h1: dict) -> dict:
    """Per-key difference of two stage-histogram snapshots (h1 - h0):
    what was observed INSIDE the window between them.  Keys that first
    appear in h1 count from zero; negative deltas (a restarted worker's
    shm block, a reset registry) clamp to zero rather than poisoning a
    fit; keys with no new observations are dropped."""
    out = {}
    for k, (c1, s1, n1) in h1.items():
        c0, s0, n0 = h0.get(k, ((0,) * len(c1), 0.0, 0))
        dn = max(0, int(n1) - int(n0))
        if dn <= 0:
            continue
        dc = tuple(
            max(0, int(a) - int(b)) for a, b in zip(c1, c0)
        )
        out[k] = (dc, max(0.0, float(s1) - float(s0)), dn)
    return out


def stage_hist_quantile(counts, cnt, q: float,
                        buckets=STAGE_BUCKETS):
    """Linear-interpolated quantile (seconds) of one histogram row:
    cumulative bucket counts + total count -> the q-quantile
    interpolated inside the breached bucket.  THE shared interpolation:
    bench.py's stage-attribution table and the tune observer's
    cost-model fitter both call this, so a fitted floor can never
    disagree with the p99 the operator reads in the bench report.

    Edge cases are policy, not accidents: an empty histogram returns
    None (nothing to claim), a tail living past the last bucket returns
    the last edge as a FLOOR (the histogram cannot resolve further — a
    number beyond it would be invented), and a single occupied bucket
    interpolates from the previous edge exactly like any other."""
    cnt = float(cnt)
    if cnt <= 0:
        return None
    target = max(0.0, min(1.0, float(q))) * cnt
    prev_edge, prev_cum = 0.0, 0.0
    for i, edge in enumerate(buckets[: len(counts)]):
        cum = float(counts[i])
        if cum >= target:
            span_n = cum - prev_cum
            frac = (target - prev_cum) / span_n if span_n > 0 else 1.0
            return prev_edge + frac * (edge - prev_edge)
        prev_edge, prev_cum = edge, cum
    # the tail lives past the last bucket: report its edge as the
    # floor rather than inventing a number
    return float(buckets[len(counts) - 1] if counts else 0.0)

"""TuneController: the observe -> propose -> shadow -> guard loop.

The port of the reference's `dss_tpu/tune/controller.py`; it installs
its recorder through the port's `plan.planner.set_decision_hook` and
`close()` removes it.

One slow background loop (DSS_TUNE_INTERVAL_S, default 30 s) drives
four stages, each of which can veto:

  observe — window the whole-front stage histograms into fits
            (tune/observe.py); thin traffic fits nothing.
  propose — fits + the recorded route mix + current knob values into
            an allowlisted, step-limited profile delta
            (tune/propose.py); inside-deadband drift proposes nothing.
  shadow  — replay the decision-trace ring under the proposed knobs
            (tune/shadow.py); a predicted p99 regression, or a trace
            that does not replay identically (recording unsound),
            rejects before anything goes live.
  guard   — apply through the actuator (configure_serving fan-out),
            then watch the SAME histograms for one guard window; a
            measured p99 regression past the rollback bound — or a
            window with no evidence at all — reverts to the pre-apply
            values.  A failed apply (the chaos `tune.apply` fault
            site: mid-swap crash drill) reverts immediately.

Every proposal/apply/rollback is logged (dss.tune), traced
(tune.propose / tune.apply spans riding the flight recorder), and
counted in the dss_tune_* stats the store exports.  The controller
never holds the store lock and owns no serving state: everything it
does goes through the same configure() seams an operator's runtime
tuning uses, so freezing it (freeze(), or DSS_TUNE=0 at boot) leaves
a fully ordinary server.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from dss_tpu_torch import chaos
from dss_tpu_torch.obs import trace
from dss_tpu_torch.obs.logging import get_logger
from dss_tpu_torch.plan import planner as _planner
from dss_tpu_torch.tune.observe import Observer
from dss_tpu_torch.tune.propose import (
    Proposal,
    make_probe,
    make_proposal,
)
from dss_tpu_torch.tune.shadow import DecisionRecorder, shadow_eval

__all__ = ["TuneController"]

log = get_logger("dss.tune")


def _traced(name: str, fn, **attrs):
    """Run fn under a root trace span (the flight recorder keeps it
    when sampling/tail-capture is armed; free no-op otherwise)."""
    h = trace.new_trace()
    if h is None:
        return fn()
    t0 = time.perf_counter()
    try:
        with trace.use(trace.SpanHandle(h, h.root_span_id)):
            with trace.span(name, **attrs):
                return fn()
    finally:
        trace.finish_root(
            h, name, (time.perf_counter() - t0) * 1000.0
        )


class TuneController:
    """The closed loop.  Injectable everywhere it touches the world:

      hist_provider() -> {(route, stage): (counts, sum_s, cnt)}
      actuator(knobs)  — apply {env-knob: value} to the serving stack
                         (the server wires configure_serving through
                         propose.KNOB_TO_CONFIGURE)
      current_fn()     -> {env-knob: live value} (one representative
                         coalescer's cost model + resident geometry)

and `device` names the host class its proposals are stamped with
(plan/autotune.host_class; `cuda` unless the caller names the CPU)

    so tests and the bench drive tick() deterministically with a fake
    clock while the server runs the thread."""

    def __init__(self, *, hist_provider, actuator,
                 current_fn: Callable[[], Dict[str, float]],
                 interval_s: float = 30.0, guard_s: float = 30.0,
                 min_count: int = 200, deadband: float = 0.25,
                 p99_tol: float = 0.10, rollback_frac: float = 1.25,
                 ring: int = 512, min_decisions: int = 32,
                 guard_key: Tuple[str, str] = ("search", "store_ms"),
                 env=None, profile_seeded=(),
                 clock=time.monotonic, device="cuda"):
        self._observer = Observer(hist_provider, min_count=min_count)
        self._recorder = DecisionRecorder(ring)
        self._actuator = actuator
        self._current = current_fn
        self.interval_s = float(interval_s)
        self.guard_s = float(guard_s)
        self._deadband = float(deadband)
        self._p99_tol = float(p99_tol)
        self._rollback_frac = float(rollback_frac)
        self._min_decisions = int(min_decisions)
        self._guard_key = tuple(guard_key)
        self._env = os.environ if env is None else env
        self._profile_seeded = frozenset(profile_seeded)
        self._clock = clock
        # the device whose host class stamps each profile delta
        self._device = device
        self._lock = threading.Lock()
        self._boot: Dict[str, float] = {}
        self._guard: Optional[dict] = None
        # knob -> observe windows left before it may probe again (a
        # probe that guard-rolled-back earned a time-out: the route it
        # explored measured WORSE, re-probing every window would cost
        # one guard window of regression per cycle)
        self._probe_block: Dict[str, int] = {}
        self.probe_block_windows = 16
        self._frozen = False
        self._seq = 0
        self._last_proposal: Optional[Proposal] = None
        self._last_p99_ms = 0.0
        self._guard_p99_ms = 0.0
        # counters (monotonic; dss_tune_* in /metrics)
        self.proposals = 0
        self.applied = 0
        self.rollbacks = 0
        self.shadow_rejected = 0
        self.apply_failed = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self, *, thread: bool = True) -> None:
        """Arm the loop: remember the boot knob values (the rollback
        floor — a misbehaving tuner is always one freeze(pin_boot=True)
        from exactly the boot-profile server), install the decision
        recorder hook, swallow the boot-to-now histograms, and
        (thread=True) start the interval thread."""
        self._boot = dict(self._current() or {})
        self._observer.prime()
        _planner.set_decision_hook(self._recorder.record)
        if thread:
            self._thread = threading.Thread(
                target=self._run, name="dss-tune", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(
            self.interval_s if self._guard is None else self.guard_s
        ):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("tune tick failed")

    def close(self) -> None:
        self._stop.set()
        _planner.set_decision_hook(None)
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- operator controls -------------------------------------------------

    def freeze(self, *, pin_boot: bool = False) -> None:
        """Stop proposing (the runbook's first move).  pin_boot=True
        additionally re-applies the boot knob values — the 'make it
        exactly the boot-profile server again' lever."""
        with self._lock:
            self._frozen = True
            self._guard = None
        if pin_boot and self._boot:
            self._apply(self._boot, why="freeze: pin boot profile")
        log.warning(
            "tuner frozen%s", " (boot profile pinned)" if pin_boot
            else "",
        )

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen = False

    def inject(self, knobs: Dict[str, float],
               reason: str = "injected") -> dict:
        """Drill hook (bench tune-smoke, chaos tests): force a
        proposal into the shadow->apply->guard path, bypassing the
        observe/deadband gates but NOT the safety machinery — an
        injected bad proposal must be shadow-rejected or guard-rolled-
        back exactly like an organic one."""
        cur = self._current() or {}
        self._seq += 1
        prop = Proposal(
            seq=self._seq,
            knobs={k: float(v) for k, v in knobs.items()},
            based_on={
                k: float(cur.get(k, 0.0)) for k in knobs
            },
            reason=reason,
            kind="injected",
        )
        return self._evaluate_and_apply(prop, self._clock())

    # -- the loop ----------------------------------------------------------

    def tick(self) -> dict:
        """One loop iteration; returns an event dict (bench/tests read
        it, the thread discards it)."""
        now = self._clock()
        with self._lock:
            if self._frozen:
                return {"event": "frozen"}
            guard = self._guard
        if guard is not None:
            if now < guard["until"]:
                return {"event": "guard_wait"}
            return self._finish_guard(now)
        moments = self._recorder.batch_moments()
        fits = self._observer.observe(moments)
        gf = fits.get(self._guard_key)
        if gf is not None:
            self._last_p99_ms = gf.p99_ms
        if not fits:
            return {"event": "thin_window"}
        for k in list(self._probe_block):
            self._probe_block[k] -= 1
            if self._probe_block[k] <= 0:
                del self._probe_block[k]
        mix = self._recorder.route_mix()
        cur = self._current() or {}
        prop = make_proposal(
            fits, mix, cur,
            seq=self._seq + 1, deadband=self._deadband,
            env=self._env, profile_seeded=self._profile_seeded,
        )
        fit_result = None
        if prop is not None:
            self._seq = prop.seq
            fit_result = self._evaluate_and_apply(prop, now)
            if fit_result["event"] != "shadow_rejected":
                return fit_result
            # a rejected fit proposal must not starve exploration —
            # the probe below is how a poisoned-HIGH floor ever heals
        probe = make_probe(
            mix, cur, seq=self._seq + 1, env=self._env,
            profile_seeded=self._profile_seeded,
            blocked=frozenset(self._probe_block),
        )
        if probe is None:
            return fit_result or {"event": "no_proposal"}
        self._seq = probe.seq
        return self._evaluate_and_apply(probe, now)

    def _evaluate_and_apply(self, prop: Proposal, now: float) -> dict:
        self.proposals += 1
        self._last_proposal = prop
        delta = prop.to_profile_delta(device=self._device)
        report = _traced(
            "tune.propose",
            lambda: shadow_eval(
                self._recorder.entries(), prop.knobs,
                p99_tol=self._p99_tol,
                min_decisions=self._min_decisions,
            ),
            seq=prop.seq,
        )
        log.info(
            "tune proposal #%d: %s | shadow: %s", prop.seq,
            delta["knobs"], report.reason,
        )
        if not report.accept:
            self.shadow_rejected += 1
            return {
                "event": "shadow_rejected", "proposal": delta,
                "shadow": report.reason,
            }
        cur = self._current() or {}
        prev = {
            k: float(cur.get(k, prop.based_on.get(k, 0.0)))
            for k in prop.knobs
        }
        try:
            self._apply(
                prop.knobs, why=f"proposal #{prop.seq}",
                fault_site=True,
            )
        except Exception as e:  # noqa: BLE001 — mid-swap crash drill
            self.apply_failed += 1
            log.exception(
                "tune apply #%d failed mid-swap; reverting", prop.seq
            )
            self._revert(prev, why=f"apply #{prop.seq} failed: {e}")
            return {
                "event": "apply_failed", "proposal": delta,
                "error": str(e),
            }
        self.applied += 1
        with self._lock:
            self._guard = {
                "until": now + self.guard_s,
                "prev": prev,
                "baseline_p99": self._last_p99_ms,
                "seq": prop.seq,
                "kind": prop.kind,
            }
        log.info(
            "tune apply #%d live: %s (guard window %.1fs, baseline "
            "p99 %.3f ms)", prop.seq, delta["knobs"], self.guard_s,
            self._last_p99_ms,
        )
        return {"event": "applied", "proposal": delta}

    def _finish_guard(self, now: float) -> dict:
        with self._lock:
            g, self._guard = self._guard, None
        if g is None:
            return {"event": "no_guard"}
        fits = self._observer.observe(self._recorder.batch_moments())
        gf = fits.get(self._guard_key)
        guard_p99 = None if gf is None else gf.p99_ms
        self._guard_p99_ms = 0.0 if guard_p99 is None else guard_p99
        base = g["baseline_p99"]
        if guard_p99 is None:
            # no evidence either way: revert.  The conservative arm of
            # 'never worse than boot for longer than one guard window'
            # — an unverifiable change does not get to stay
            self.rollbacks += 1
            self._block_probe(g)
            self._revert(
                g["prev"],
                why=f"guard #{g['seq']}: no guard-window evidence",
            )
            return {"event": "rollback", "reason": "no_evidence"}
        if base > 0.0 and guard_p99 > base * self._rollback_frac:
            self.rollbacks += 1
            self._block_probe(g)
            self._revert(
                g["prev"],
                why=(
                    f"guard #{g['seq']}: p99 {base:.3f} -> "
                    f"{guard_p99:.3f} ms"
                ),
            )
            return {
                "event": "rollback", "reason": "p99_regression",
                "baseline_p99_ms": base, "guard_p99_ms": guard_p99,
            }
        self._last_p99_ms = guard_p99
        log.info(
            "tune guard #%d held: p99 %.3f -> %.3f ms; knobs commit",
            g["seq"], base, guard_p99,
        )
        return {
            "event": "committed", "baseline_p99_ms": base,
            "guard_p99_ms": guard_p99,
        }

    def _block_probe(self, g: dict) -> None:
        """A rolled-back probe earns its knob a probing time-out —
        without it the probe/flip/rollback cycle would cost one guard
        window of regression per observe window, forever."""
        if g.get("kind") != "probe":
            return
        for k in g["prev"]:
            self._probe_block[k] = self.probe_block_windows

    # -- actuation ---------------------------------------------------------

    def _apply(self, knobs: Dict[str, float], *, why: str,
               fault_site: bool = False) -> None:
        def do():
            if fault_site:
                # the drillable mid-swap crash (chaos/faults.py)
                chaos.fault_point("tune.apply", why)
            self._actuator(dict(knobs))

        _traced(
            "tune.apply", do,
            knobs=",".join(
                f"{k}={v:.6g}" for k, v in sorted(knobs.items())
            ),
            why=why,
        )

    def _revert(self, prev: Dict[str, float], *, why: str) -> None:
        """Roll back to pre-apply values.  NEVER runs the fault site —
        a rollback must succeed even mid-drill — and absorbs actuator
        errors (the values will be re-imposed by freeze(pin_boot=True)
        or a restart; crashing the loop would leave the bad knobs
        live)."""
        log.warning("tune rollback: %s; restoring %s", why, prev)
        try:
            self._apply(prev, why=f"rollback: {why}")
        except Exception:  # noqa: BLE001
            log.exception("tune rollback actuation failed")

    # -- introspection -----------------------------------------------------

    @property
    def recorder(self) -> DecisionRecorder:
        return self._recorder

    def stats(self) -> dict:
        cur = {}
        try:
            cur = {
                k: float(v) for k, v in (self._current() or {}).items()
            }
        except Exception:  # noqa: BLE001 — scrape must survive
            pass
        prop = self._last_proposal
        return {
            "dss_tune_enabled": 1,
            "dss_tune_frozen": int(self._frozen),
            "dss_tune_guard_open": int(self._guard is not None),
            "dss_tune_proposals_total": self.proposals,
            "dss_tune_applied_total": self.applied,
            "dss_tune_rollbacks_total": self.rollbacks,
            "dss_tune_shadow_rejected_total": self.shadow_rejected,
            "dss_tune_apply_failed_total": self.apply_failed,
            "dss_tune_windows_total": self._observer.windows,
            "dss_tune_thin_windows_total": self._observer.thin_windows,
            "dss_tune_last_p99_ms": round(self._last_p99_ms, 3),
            "dss_tune_guard_p99_ms": round(self._guard_p99_ms, 3),
            "dss_tune_recorder_depth": len(self._recorder),
            "dss_tune_recorder_allocs_total": self._recorder.allocs,
            "dss_tune_knob_active": cur,
            "dss_tune_knob_proposed": (
                {} if prop is None else dict(prop.knobs)
            ),
        }

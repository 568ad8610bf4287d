"""Self-tuning serving: observe -> propose -> shadow -> guarded apply.

The port of the reference's `dss_tpu/tune` package: host code over the
port's planner hook, stage histograms, chaos sites and trace recorder.
The controller takes `device=` (default `cuda`) for the host class it
stamps on each proposal's profile delta.

The offline autotuner (plan/autotune.py) fits cost-model knobs on an
idle host at boot; this package closes the loop at runtime.  Four
stages, each a separate module, each able to veto:

  observe.py    fit per-route cost parameters from the live
                dss_stage_duration_seconds histograms (whole shm front
                when attached), confidence-gated so thin traffic never
                proposes anything
  propose.py    format-versioned profile DELTA on the same KNOB_KEYS
                allowlist as the offline profile, env > profile >
                tuner precedence, per-knob step limits
  shadow.py     replay the recorded decision trace (bounded ring fed
                by plan.set_decision_hook) under the proposed knobs —
                predicted p99 / route-mix shift before anything goes
                live
  controller.py guarded actuator: hot-swap through configure_serving,
                watch the same histograms for one guard window, roll
                back automatically on measured regression

Boot contract: DSS_TUNE=0 (default) builds NOTHING — no recorder hook
is installed, so the planner hot path pays one module-global read and
the recorder allocation counter provably stays zero (same discipline
as the trace flight recorder).  A misbehaving tuner is bounded by
design: one guard window of regression, then automatic rollback; the
runbook lever is freeze(pin_boot=True) or a DSS_TUNE=0 restart.
"""

from __future__ import annotations

import os

from dss_tpu_torch.tune.controller import TuneController  # noqa: F401
from dss_tpu_torch.tune.observe import (  # noqa: F401
    Observer,
    StageFit,
    fit_stage,
)
from dss_tpu_torch.tune.propose import (  # noqa: F401
    HOT_KNOBS,
    KNOB_TO_CONFIGURE,
    Proposal,
    STEP_LIMITS,
    TUNE_FORMAT,
    clamp_step,
    make_probe,
    make_proposal,
)
from dss_tpu_torch.tune.shadow import (  # noqa: F401
    DecisionRecorder,
    KNOB_TO_STATE,
    ShadowReport,
    apply_knobs_to_state,
    shadow_eval,
)

__all__ = [
    "DecisionRecorder",
    "HOT_KNOBS",
    "KNOB_TO_CONFIGURE",
    "KNOB_TO_STATE",
    "Observer",
    "Proposal",
    "STEP_LIMITS",
    "ShadowReport",
    "StageFit",
    "TUNE_FORMAT",
    "TuneController",
    "apply_knobs_to_state",
    "clamp_step",
    "empty_stats",
    "env_knobs",
    "fit_stage",
    "make_probe",
    "make_proposal",
    "shadow_eval",
]


def env_knobs(env=None) -> dict:
    """DSS_TUNE_* -> TuneController kwargs (+ the master 'enabled'
    switch).  One parse point, mirrored in docs/OPERATIONS.md."""
    env = os.environ if env is None else env

    def _f(k, d):
        try:
            return float(env.get(k, d))
        except (TypeError, ValueError):
            return d

    return {
        "enabled": str(env.get("DSS_TUNE", "0")).lower()
        in ("1", "true", "yes", "on"),
        "interval_s": _f("DSS_TUNE_INTERVAL_S", 30.0),
        "guard_s": _f("DSS_TUNE_GUARD_S", 30.0),
        "min_count": int(_f("DSS_TUNE_MIN_COUNT", 200)),
        "deadband": _f("DSS_TUNE_DEADBAND", 0.25),
        "p99_tol": _f("DSS_TUNE_P99_TOL", 0.10),
        "rollback_frac": _f("DSS_TUNE_ROLLBACK_FRAC", 1.25),
        "ring": int(_f("DSS_TUNE_RING", 512)),
    }


def empty_stats() -> dict:
    """The dss_tune_* keys a store without a tuner still exports —
    stable /metrics names (dashboards and alerts never see a series
    appear only once someone flips DSS_TUNE=1)."""
    return {
        "dss_tune_enabled": 0,
        "dss_tune_frozen": 0,
        "dss_tune_guard_open": 0,
        "dss_tune_proposals_total": 0,
        "dss_tune_applied_total": 0,
        "dss_tune_rollbacks_total": 0,
        "dss_tune_shadow_rejected_total": 0,
        "dss_tune_apply_failed_total": 0,
        "dss_tune_windows_total": 0,
        "dss_tune_thin_windows_total": 0,
        "dss_tune_last_p99_ms": 0.0,
        "dss_tune_guard_p99_ms": 0.0,
        "dss_tune_recorder_depth": 0,
        "dss_tune_recorder_allocs_total": 0,
        "dss_tune_knob_active": {},
        "dss_tune_knob_proposed": {},
    }

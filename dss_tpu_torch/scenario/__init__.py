"""City-scale scenario harness: deterministic, seeded, replayable
workloads with real spatial structure (the port of the reference's
`dss_tpu/scenario`; docs/OPERATIONS.md has the `DSS_SCENARIO_*` knob
table).  plan/autotune.py costs its shapes."""

from dss_tpu_torch.scenario.generator import (  # noqa: F401
    SCENARIOS,
    Phase,
    Request,
    Scenario,
    build_scenario,
    env_knobs,
    materialize_body,
    stream_digest,
)

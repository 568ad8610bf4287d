"""Deterministic fault injection (the port of the reference's
`dss_tpu/chaos`): named fault sites consulting a seeded, replayable
FaultPlan loaded from DSS_FAULT_PLAN, zero overhead when no plan is
installed.  The degradation ladder and the retry policy come with the
store slice.  Stdlib only.
"""

from dss_tpu_torch.chaos.faults import (  # noqa: F401
    DeviceLostError,
    FaultError,
    FaultEvent,
    FaultPlan,
    FaultRegistry,
    clear_plan,
    fault_point,
    install_plan,
    is_device_loss,
    load_env_plan,
    registry,
)

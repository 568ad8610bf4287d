"""Deterministic fault injection + the graceful-degradation ladder
(the port of the reference's `dss_tpu/chaos`).

  faults   named fault sites (`chaos.fault_point("wal.fsync")`)
           consulting a seeded, replayable FaultPlan loaded from
           DSS_FAULT_PLAN — zero overhead when no plan is installed
           (sync seams only; the event-loop seams come with the API
           slice)
  retry    ONE jittered-backoff policy + per-remote circuit breakers
  ladder   the store-level degradation state machine
           (HEALTHY -> DEVICE_LOST -> MESH_DEGRADED ->
           FEDERATION_DEGRADED -> REGION_LOG_DOWN) with
           re-warm-before-re-admit recovery

Import cost matters (dar/wal.py imports this): no torch, no numpy,
stdlib only.
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
from dss_tpu_torch.chaos.ladder import (  # noqa: F401
    CONDITIONS,
    DEVICE_LOST,
    FEDERATION_DEGRADED,
    HEALTHY,
    MESH_DEGRADED,
    MODE_NAMES,
    PUSH_DEGRADED,
    REGION_LOG_DOWN,
    DegradationLadder,
)
from dss_tpu_torch.chaos.retry import (  # noqa: F401
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BreakerRegistry,
    CircuitBreaker,
    Deadline,
    RetryPolicy,
)

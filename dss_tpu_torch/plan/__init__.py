"""The query-plan layer: one planner over every serving route.

A copy of the reference's `dss_tpu/plan` package (with `shmroute`,
the shm front's route, and `autotune`, the offline sweep that seeds
the cost models from measurements on the card):

  costs.CostModel   — the online EWMA cost estimates (device floor /
                      per-item / host chunk / resident floor+latency).
  ModelState        — an immutable snapshot of (cost estimates +
                      pipeline pressure + route availability): the
                      full input of a routing decision.
  BatchShape        — what is being routed (size, staleness, owner
                      scoping, inline-ness).
  Plan              — the decision record: chosen route, predicted
                      cost, every candidate considered, deadline and
                      freshness class.
  Planner           — produces Plans, owns the CostModel, sizes
                      drains, and answers Retry-After throughput from
                      the route it would actually choose.  `decide`
                      is a pure function of (shape, state, headroom).
"""

from dss_tpu_torch.plan.costs import CostModel
from dss_tpu_torch.plan.planner import (
    HEADROOM_SAFETY,
    ROUTES,
    BatchShape,
    ModelState,
    Plan,
    Planner,
    decide,
    plan_drain_cap,
    set_decision_hook,
)

__all__ = [
    "BatchShape",
    "CostModel",
    "HEADROOM_SAFETY",
    "ModelState",
    "Plan",
    "Planner",
    "ROUTES",
    "decide",
    "plan_drain_cap",
    "set_decision_hook",
]

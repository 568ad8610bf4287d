"""Reverse-query push pipeline: device-matched subscription
notifications with durable per-USS delivery.

The port of the reference's `dss_tpu/push` (same classes, stats keys,
WAL records and routes); the match runs B1 (the fused window filter,
dss_tpu_torch/csrc/fused_filter.cu) on the card.

The read path answers "which entities intersect this volume?" at
device-kernel throughput; this package makes the WRITE path do the
same for "which subscribers care about this write?" — a write is a
reverse query, the same fused geometry kernel with the query and data
roles swapped over the subscription classes' DAR — and then actually
tells them, instead of returning a subscriber list the USS must poll
to act on (the paper's "notify a million subscribers without polling"
capability).

Four pieces (see each module's docstring):

  match     MatchStage — write-side match batches through the planner's
            `rqmatch` route (plan/planner.py): the fused kernel over
            the subscription DAR when the device class is admissible,
            the bit-identical host oracle otherwise.
  queue     DeliveryLog — a WAL-backed per-USS notification queue with
            cursor + ack semantics: an acked notification survives any
            crash and is never redelivered; an unacked one is
            redelivered at-least-once after restart.
  deliver   DeliveryPool — webhook fan-out workers with per-USS
            circuit breakers, the shared chaos RetryPolicy, and a QoS
            tier where emergency-scenario operations preempt bulk.
  pipeline  PushPipeline — ties the stages to a DSSStore
            (DSSStore.attach_push), owns webhook registration, the
            /aux/v1/push/* surface, federation fan-out of cross-region
            events, the dss_push_* gauges, and the push_degraded
            ladder condition.

Fault sites: `push.match` (before a match batch executes; device-class
faults are absorbed onto the host oracle) and `push.deliver` (before a
webhook attempt; counted against the USS's breaker).
"""

from dss_tpu_torch.push.match import MatchStage  # noqa: F401
from dss_tpu_torch.push.queue import DeliveryLog, Notification  # noqa: F401
from dss_tpu_torch.push.deliver import DeliveryPool  # noqa: F401
from dss_tpu_torch.push.pipeline import (  # noqa: F401
    PushPipeline,
    empty_stats,
    env_knobs,
)

"""replica_batch_p95_ms.bulk: the 95th percentile ms of one
ShardedReplica.query_batch call, the harness's clock."""

from portbench.metrics._spans import p95_ms


def read(run):
    return p95_ms(run, "query_batch")

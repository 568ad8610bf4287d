"""The harness drives a run with the timed path broken underneath and
sees `correct` come out false: an answer altered where it is produced
(an intent left out, or an id changed), and half of a batch left out.  (A cell on one card has no exchange
between chips, and no state that a step returns.)  The CPU runs the
port's plain versions under the same entries the card runs."""

import pytest
from conftest import TINY

from portbench import run


def drop_last(answers):
    return [a[:-1] if len(a) else a for a in answers]


def half_left_out(answers):
    half = len(answers) // 2
    return answers[:half] + [[] for _ in answers[half:]]


def altered_id(answers):
    def alter(i):
        return i[:-1] + ("1" if i[-1] == "0" else "0")

    return [[alter(a[0])] + a[1:] if len(a) else a for a in answers]


@pytest.mark.parametrize("fault", [drop_last, half_left_out, altered_id])
def test_replica_fault_is_not_correct(monkeypatch, fault):
    from dss_tpu_torch.parallel.replica import ShardedReplica

    real = ShardedReplica.query_batch
    monkeypatch.setattr(ShardedReplica, "query_batch",
                        lambda self, *a, **k: fault(real(self, *a, **k)))
    result, _, lines = run.run_cell("scd_mesh_1m.search64", 5, 0.5, False,
                                    dev="cpu", overrides=TINY)
    assert result["correct"] is False
    assert result["check"]["mismatched_queries"]["value"] > 0
    assert lines[-1] == "check correct false"

"""The churn cell (`scd_mesh_1m_churn.churn64`): its write stream, its
reference and its check, on the CPU at the tiny size.

The stream keeps the delta tier and the shadow set at their sizes; the
reference (`conflict_churn`) agrees with a brute-force 4D test over the
state the stream leaves after each round; the check catches answers
held to a stale state, a replica whose refresh is skipped in the
window and one whose shadow drop is removed; a traced window reads the
five per-layer metrics, which read nothing where the program has no
fold spans or counter; a run that needs more rounds than the stream
holds raises."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import TINY

from portbench import churn, gen, run
from portbench.reference import conflict_churn

CELL = "scd_mesh_1m_churn.churn64"
METRICS = ("replica_fold_ms.churn", "replica_fold_share.churn",
           "replica_poll_share.churn", "fold_h2d_mb.churn",
           "delta_query_share.churn")
# the tiny cell, with a stream long enough for a 1 s window
SHORT = {"data": TINY["data"], "traffic": dict(TINY["traffic"],
                                               stream_rounds=160)}


def _cell():
    cell = run.load_cell(CELL)
    cell["config"]["data"].update(TINY["data"])
    recipe = importlib.import_module(
        f"portbench.recipes.{cell['config']['recipe']}")
    return cell, recipe


def test_the_stream_keeps_the_tiers_at_their_sizes():
    cell, recipe = _cell()
    cfg, traffic = cell["config"], cell["traffic"]
    data = recipe.intents(cfg["data"], 11)
    w = churn.draw(recipe, cfg["data"], data, cfg["backlog"],
                   traffic["round"], 12, 11)
    n = len(data.ids)
    upd, ins, dele = churn.counts(cfg["backlog"], n)
    assert (upd, ins, dele) == (246, 123, 123)
    back = w.of_round(0)
    kind, ent = w.kind[back], w.ent[back]
    assert len(np.unique(ent[kind != churn.INSERT])) == upd + dele
    assert (ent[kind != churn.INSERT] < n).all()
    assert (ent[kind == churn.INSERT] >= n).all()
    # after each round: as many written since the load and as many of
    # the loaded intents hidden, as a replica's delta and shadow sets
    live, touched = set(), set()
    for r in range(0, w.rounds + 1):
        part = w.of_round(r)
        k = w.kind[part]
        if r:
            assert [(k == x).sum() for x in (
                churn.UPDATE, churn.INSERT, churn.DELETE)] == [32, 16, 16]
        for e, kk in zip(w.ent[part].tolist(), k.tolist()):
            if r and kk != churn.INSERT:
                # a round re-files or deletes a live intent written
                # since the load, never a loaded one
                assert e in live and (e in touched or e >= n)
            if e < n:
                touched.add(e)
            if kk == churn.DELETE:
                live.discard(e)
            else:
                live.add(e)
        assert len(live) == upd + ins and len(touched) == upd + dele
    # each put has its own new version, inserts their own ids
    assert len(np.unique(w.row[w.kind != churn.DELETE])) == (
        (w.kind != churn.DELETE).sum())
    assert len(np.unique(w.ids)) == len(w.ids) == n + ins + 16 * 12


def test_reference_agrees_with_brute_force_at_every_round():
    cell, recipe = _cell()
    cfg, traffic = cell["config"], cell["traffic"]
    data = recipe.intents(cfg["data"], 12)
    w = churn.draw(recipe, cfg["data"], data, cfg["backlog"],
                   traffic["round"], 5, 12)
    q = recipe.queries(cfg["data"], traffic["query"], gen.rng(12, 9), 96)
    ref = conflict_churn.Reference(churn.versions(data, w))
    # the state after each round, replayed write by write
    state = {i: (data.keys[i], data.alt_lo[i], data.alt_hi[i],
                 data.t_start[i], data.t_end[i]) for i in range(len(data.ids))}
    f = w.fresh
    for r in range(0, w.rounds + 1):
        part = w.of_round(r)
        for j in range(part.start, part.stop):
            e, k = int(w.ent[j]), int(w.row[j])
            if w.kind[j] == churn.DELETE:
                del state[e]
            else:
                state[e] = (f.keys[k], f.alt_lo[k], f.alt_hi[k],
                            f.t_start[k], f.t_end[k])
        ents = np.array(sorted(state))
        keys = np.stack([state[e][0] for e in ents])
        lo, hi, t0, t1 = (np.array([state[e][c] for e in ents])
                          for c in range(1, 5))
        got = ref.answer(q, gen.NOW, np.full(len(q), r))
        hits = 0
        for i in range(len(q)):
            ok = (np.isin(keys, q.keys[i]).any(axis=1)
                  & (hi >= q.alt_lo[i]) & (lo <= q.alt_hi[i])
                  & (t1 >= q.t_start[i]) & (t0 <= q.t_end[i])
                  & (t1 >= gen.NOW))
            np.testing.assert_array_equal(got[i], ents[ok])
            hits += int(ok.sum())
        assert hits > len(q)


@pytest.fixture
def stale(monkeypatch):
    """The check's readings of each run, and of the same answers held
    to the state the window opened on."""
    seen = []
    real = conflict_churn.judge

    def judge(run, data, stale=False):
        seen.append(real(run, data, stale=True))
        return real(run, data)

    monkeypatch.setattr(conflict_churn, "judge", judge)
    return seen


def test_answers_held_to_the_opening_state_fail_the_check(stale):
    result, info, lines = run.run_cell(CELL, 2**31 + 9, 1.0, False,
                                       dev="cpu", overrides=SHORT)
    assert result["correct"] is True
    (compared, readings), = stale
    assert compared == info["compared"] > 0
    assert readings["mismatched_queries"] > 0
    # the window's rounds leave the tiers at their sizes, minor folds only
    c = info["counters"]
    assert c["replica_delta_refreshes"] == info["batches"] > 0
    assert c["replica_major_rebuilds"] == 0
    assert c["replica_ops_delta_records"] == c["replica_ops_shadowed"] == 0
    assert c["replica_applied_records"] == 64 * info["batches"]


def _skip_refresh_in_the_window(monkeypatch):
    from dss_tpu_torch.parallel.replica import ShardedReplica

    window = []
    real_refresh, real_open = ShardedReplica.refresh, run.Run.open

    def refresh(self, **kw):
        return False if window else real_refresh(self, **kw)

    def open_(self):
        window.append(True)
        return real_open(self)

    monkeypatch.setattr(ShardedReplica, "refresh", refresh)
    monkeypatch.setattr(run.Run, "open", open_)


def _no_shadow_drop(monkeypatch):
    from dss_tpu_torch.parallel.replica import ShardedReplica

    real = ShardedReplica.query_padded

    def query_padded(self, cls, *args):
        snap = self._snapshots[cls]
        self._snapshots[cls] = snap._replace(shadow=frozenset())
        try:
            return real(self, cls, *args)
        finally:
            self._snapshots[cls] = snap

    monkeypatch.setattr(ShardedReplica, "query_padded", query_padded)


@pytest.mark.parametrize("fault", [_skip_refresh_in_the_window,
                                   _no_shadow_drop])
def test_replica_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, _, lines = run.run_cell(CELL, 5, 1.0, False, dev="cpu",
                                    overrides=SHORT)
    assert result["correct"] is False
    assert result["check"]["mismatched_queries"]["value"] > 0
    assert lines[-1] == "check correct false"


def test_traced_window_reads_the_five_metrics():
    result, info, _ = run.run_cell(CELL, 2**33 + 1, 1.0, True, dev="cpu",
                                   overrides=SHORT)
    assert result["correct"] is True
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == set(METRICS)
    assert m["replica_fold_ms.churn"] > 0
    assert 0 < m["replica_poll_share.churn"] < m[
        "replica_fold_share.churn"] < 100
    assert 0 < m["delta_query_share.churn"] < 100
    c = info["counters"]
    assert m["fold_h2d_mb.churn"] == pytest.approx(
        c["replica_fold_h2d_bytes"] / c["replica_delta_refreshes"] / 1e6)


def test_readers_read_nothing_without_the_fold_spans_or_counter():
    blank = SimpleNamespace(program_spans=[], spans=SimpleNamespace(
        of=lambda name: [(0.0, 1.0)]), entry_span="query_batch",
        t_open=0.0, t_close=1.0, window_s=1.0, counters0={},
        counters1={"replica_delta_refreshes": 3},
        counter_delta=lambda k: 3)
    assert all(run.reader(name)(blank) is None for name in METRICS)


def test_a_run_past_the_stream_raises():
    over = {"data": TINY["data"],
            "traffic": dict(TINY["traffic"], stream_rounds=8)}
    with pytest.raises(RuntimeError, match="stream holds 8 rounds"):
        run.run_cell(CELL, 3, 1.0, False, dev="cpu", overrides=over)

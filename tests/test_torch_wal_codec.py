"""The port's WAL and codec against the reference's.

The same op sequence writes byte-identical WAL files in both packages;
a WAL written by either package boots the other's store to equal state;
the codecs produce equal docs, key for key; the log's recovery rules
(torn tails, mid-log corruption, torn headers, the format gate) give
equal results on the same bytes; and a port WalFollower tails a port
leader to the leader's state, as the reference's follower does.
"""

from __future__ import annotations

import json
import random
import uuid
from datetime import timedelta

import numpy as np
import pytest

from dss_tpu.dar import wal as r_wal
from dss_tpu.dar.follower import WalFollower as RFollower
from dss_tpu_torch.dar import wal as p_wal
from dss_tpu_torch.dar.follower import WalFollower as PFollower
from tests.test_torch_store_contract import PORT, REF, T0
from tests.test_torch_store_parity import Side, _pair, run_sequence, sweep


def state_of(store):
    """Everything a store holds, as codec docs."""
    return {
        "rid": store.rid.serialize_state(),
        "scd": store.scd.serialize_state(),
        "seq": store.wal.seq,
    }


@pytest.mark.parametrize("backend", ["cuda", "memory"])
@pytest.mark.parametrize("seed", [2, 5])
def test_same_ops_write_byte_identical_wals(seed, backend, tmp_path,
                                            monkeypatch):
    paths = (str(tmp_path / "ref.wal"), str(tmp_path / "port.wal"))
    ref, port = _pair(monkeypatch, backend, wal_paths=paths)
    try:
        run_sequence(ref, port, seed, steps=60)
        assert port.store.wal.seq == ref.store.wal.seq > 0
    finally:
        ref.store.close()
        port.store.close()
    a, b = (open(p, "rb").read() for p in paths)
    assert b == a
    head = json.loads(b.splitlines()[0])
    assert head == {"t": "__format__", "version": 1}


@pytest.mark.parametrize("seed", [4])
def test_each_package_boots_from_the_others_wal(seed, tmp_path,
                                                monkeypatch):
    paths = (str(tmp_path / "ref.wal"), str(tmp_path / "port.wal"))
    ref, port = _pair(monkeypatch, "cuda", wal_paths=paths)
    try:
        run_sequence(ref, port, seed, steps=60)
        live = state_of(ref.store)
        assert state_of(port.store) == live
        now = ref.clock.now()
    finally:
        ref.store.close()
        port.store.close()
    # cross boot: the reference's log into the port and the reverse,
    # each on a fresh clock at the same instant
    p2 = PORT.Store(storage="cuda", device="cpu",
                    clock=PORT.FakeClock(now), wal_path=paths[0])
    r2 = REF.Store(storage="tpu", clock=REF.FakeClock(now),
                   wal_path=paths[1])
    try:
        assert state_of(p2) == live
        assert state_of(r2) == live
        sweep(Side(REF, r2, r2.clock), Side(PORT, p2, p2.clock))
    finally:
        p2.close()
        r2.close()


def _records(p, rng):
    """One record of each kind, with seeded fields (some left None)."""
    cells = np.sort(rng.integers(1, 2**63, 7, dtype=np.uint64))
    t0 = T0 + timedelta(seconds=int(rng.integers(0, 10**6)))
    t1 = t0 + timedelta(microseconds=int(rng.integers(1, 10**10)))
    maybe = (lambda v: None if rng.random() < 0.3 else v)
    return [
        ("isa", p.ridm.IdentificationServiceArea(
            id=str(uuid.UUID(int=int(rng.integers(0, 2**62)), version=4)),
            owner="uss-a", url="https://a.example/f", cells=cells,
            start_time=t0, end_time=t1,
            version=maybe(p.Version.from_time(t0)),
            altitude_lo=maybe(float(rng.uniform(0, 100))),
            altitude_hi=maybe(float(rng.uniform(100, 900))))),
        ("rid_sub", p.ridm.Subscription(
            id="s1", owner="uss-b", url="https://b.example/i",
            notification_index=int(rng.integers(0, 99)), cells=cells,
            start_time=t0, end_time=maybe(t1),
            version=p.Version.from_time(t1),
            altitude_lo=maybe(1.5), altitude_hi=2.5)),
        ("op", p.scdm.Operation(
            id="o1", owner="uss-c", version=int(rng.integers(1, 9)),
            ovn="ovn-" + str(int(rng.integers(0, 10**9))),
            start_time=t0, end_time=t1,
            altitude_lower=float(np.float32(rng.uniform(0, 3000))),
            altitude_upper=maybe(600.25), uss_base_url="https://c.example",
            state=p.scdm.OperationState.ACTIVATED, cells=cells,
            subscription_id="sub-9",
            constraint_aware=bool(rng.integers(0, 2)))),
        ("constraint", p.scdm.Constraint(
            id="c1", owner="uss-d", version=3, ovn="ovn-c", start_time=t0,
            end_time=t1, altitude_lower=maybe(10.0), altitude_upper=20.0,
            uss_base_url="https://d.example", cells=cells)),
        ("scd_sub", p.scdm.Subscription(
            id="ss1", owner="uss-e", version=2, notification_index=4,
            start_time=t0, end_time=t1, altitude_hi=maybe(5.0),
            altitude_lo=1.0, base_url="https://e.example",
            notify_for_operations=True,
            notify_for_constraints=bool(rng.integers(0, 2)),
            implicit_subscription=True, dependent_operations=["o1", "o2"],
            cells=cells)),
    ]


CODEC = {
    "isa": ("isa_to_doc", "doc_to_isa"),
    "rid_sub": ("rid_sub_to_doc", "doc_to_rid_sub"),
    "op": ("op_to_doc", "doc_to_op"),
    "constraint": ("constraint_to_doc", "doc_to_constraint"),
    "scd_sub": ("scd_sub_to_doc", "doc_to_scd_sub"),
}


@pytest.mark.parametrize("seed", range(4))
def test_codec_docs_equal_key_for_key(seed):
    for (kind, r_rec), (_, p_rec) in zip(
        _records(REF, np.random.default_rng(seed)),
        _records(PORT, np.random.default_rng(seed)),
    ):
        enc, dec = CODEC[kind]
        r_doc = getattr(REF.codec, enc)(r_rec)
        p_doc = getattr(PORT.codec, enc)(p_rec)
        assert list(p_doc) == list(r_doc), kind
        assert json.dumps(p_doc) == json.dumps(r_doc), kind
        # each package decodes the other's doc back to the same doc
        assert getattr(PORT.codec, enc)(
            getattr(PORT.codec, dec)(r_doc)) == r_doc
        assert getattr(REF.codec, enc)(
            getattr(REF.codec, dec)(p_doc)) == p_doc


# -- the log's recovery rules on the same bytes --------------------------------


def _open(mod, path):
    """-> what one package's log makes of a file: (seq, replayed
    records, truncated?, bytes after open) or the error's class name."""
    try:
        w = mod.WriteAheadLog(path)
    except (mod.LogCorruptError, mod.LogFormatError) as e:
        return type(e).__name__
    try:
        return (w.seq, list(w.replay()), w.recovered_truncation,
                open(path, "rb").read())
    finally:
        w.close()


def _both(tmp_path, name, data):
    out = []
    for mod in (r_wal, p_wal):
        path = str(tmp_path / f"{mod.__name__}.{name}")
        with open(path, "wb") as fh:
            fh.write(data)
        out.append(_open(mod, path))
    return out


def test_wal_recovery_equals_reference_on_every_cut(tmp_path):
    path = str(tmp_path / "full.wal")
    w = p_wal.WriteAheadLog(path)
    for i in range(12):
        w.append({"t": "isa_put", "doc": {"id": f"i{i}", "n": i}})
    w.close()
    full = open(path, "rb").read()
    rng = random.Random(7)
    cuts = sorted(rng.sample(range(1, len(full)), 24)) + [len(full)]
    for cut in cuts:
        r, p = _both(tmp_path, f"cut{cut}", full[:cut])
        assert p == r, cut


def test_wal_damage_equals_reference(tmp_path):
    path = str(tmp_path / "dmg.wal")
    w = p_wal.WriteAheadLog(path)
    for t in ("a", "b", "c"):
        w.append({"t": t})
    w.close()
    lines = open(path, "rb").read().splitlines(keepends=True)
    rotted = lines[:2] + [b"\x00" * (len(lines[2]) - 1) + b"\n"] + lines[3:]
    cases = {
        "mid_log_rot": b"".join(rotted),
        "torn_tail": b"".join(lines[:2]) + b'{"t": "d", "se',
        "torn_header": b'{"t": "__form',
        "future_format": b'{"t":"__format__","version":2}\n',
        "headerless": b'{"t":"x","seq":1}\n',
    }
    for name, data in cases.items():
        r, p = _both(tmp_path, name, data)
        assert p == r, name
    assert _both(tmp_path, "rot2", cases["mid_log_rot"])[1] == (
        "LogCorruptError"
    )
    assert _both(tmp_path, "fut2", cases["future_format"])[1] == (
        "LogFormatError"
    )


# -- the follower ----------------------------------------------------------------


@pytest.mark.parametrize("follower", ["port", "reference"])
def test_wal_follower_tails_a_port_leader(follower, tmp_path, monkeypatch):
    path = str(tmp_path / "leader.wal")
    ref, leader = _pair(monkeypatch, "cuda", wal_paths=(None, path))
    if follower == "port":
        replica = PORT.Store(storage="memory")
        tail = PFollower(replica, path, interval_s=0.01)
    else:
        replica = REF.Store(storage="memory")
        tail = RFollower(replica, path, interval_s=0.01)
    try:
        tail.start()
        run_sequence(ref, leader, 8, steps=30)
        assert tail.wait_for(leader.store.wal.seq, timeout_s=10.0)
        run_sequence(ref, leader, 9, steps=30)
        assert tail.wait_for(leader.store.wal.seq, timeout_s=10.0)
        assert tail.applied_seq == leader.store.wal.seq
        assert tail.stats()["follower_apply_errors"] == 0
        want = state_of(leader.store)
        got = {"rid": replica.rid.serialize_state(),
               "scd": replica.scd.serialize_state()}
        assert got == {"rid": want["rid"], "scd": want["scd"]}
    finally:
        tail.close()
        replica.close()
        ref.store.close()
        leader.store.close()

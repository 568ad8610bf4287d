"""The port's services (dss_tpu_torch/services) against the reference's.

Every case of tests/test_rid_service.py, tests/test_scd_service.py and
tests/test_scd_constraints.py runs, with the reference test's own
assertions, against a Twin: each service call goes to the reference's
service and to the port's, each over its own store under its own
FakeClock started at the same instant, and the two answers (response
JSON with its versions and OVNs, or the error's code, message and
details) must be equal before the reference's answer goes back to the
test.  The port's `cuda` store on `device="cpu"` (the kernels' plain
versions) meets the reference's `tpu` store, and the port's `memory`
store the reference's.  Both SCD services draw the implicit
subscription's id from the same seeded sequence.  The two cases that build their own stores (WAL
replay, the read cache on the constraint query) run as scenarios on
both packages, their observations compared.
"""

from __future__ import annotations

import copy
import random
import uuid
from types import SimpleNamespace

import pytest

from dss_tpu import errors as r_errors
from dss_tpu.clock import FakeClock as RFakeClock
from dss_tpu.dar.dss_store import DSSStore as RStore
from dss_tpu.services.rid import RIDService as RRIDService
from dss_tpu.services import scd as r_scd_mod
from dss_tpu.services.scd import SCDService as RSCDService
from dss_tpu_torch import errors as p_errors
from dss_tpu_torch.clock import FakeClock as PFakeClock
from dss_tpu_torch.dar.dss_store import DSSStore as PStore
from dss_tpu_torch.services.rid import RIDService as PRIDService
from dss_tpu_torch.services import scd as p_scd_mod
from dss_tpu_torch.services.scd import SCDService as PSCDService
from tests import test_rid_service as ref_rid
from tests import test_scd_constraints as ref_cst
from tests import test_scd_service as ref_scd
from tests.test_store_contract import T0

REF = SimpleNamespace(errors=r_errors, FakeClock=RFakeClock, Store=RStore,
                      RID=RRIDService, SCD=RSCDService)
PORT = SimpleNamespace(errors=p_errors, FakeClock=PFakeClock, Store=PStore,
                       RID=PRIDService, SCD=PSCDService)
# (port backend, reference backend)
PAIRS = (("cuda", "tpu"), ("memory", "memory"))


def port_store(backend, **kw):
    if backend == "cuda":
        kw["device"] = "cpu"
    return PStore(storage=backend, **kw)


def outcome(p, fn, *args, **kw):
    """-> (("ok", answer) or ("err", code, message, details), error)."""
    try:
        return ("ok", fn(*args, **kw)), None
    except p.errors.StatusError as e:
        return ("err", int(e.code), e.message, e.details), e


class TwinClock:
    """advance()/set() move both FakeClocks together."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def advance(self, *a, **kw):
        self.ref.advance(*a, **kw)
        self.port.advance(*a, **kw)

    def set(self, *a, **kw):
        self.ref.set(*a, **kw)
        self.port.set(*a, **kw)

    def now(self):
        assert self.ref.now() == self.port.now()
        return self.ref.now()


class SeededUUID:
    """Stands in for the `uuid` module of one package's SCD service:
    the implicit subscription's id comes from a seeded sequence, the
    same on both sides, so answers that carry it compare exactly."""

    def __init__(self, seed=7):
        self._rng = random.Random(seed)

    def uuid4(self):
        return uuid.UUID(int=self._rng.getrandbits(128), version=4)


@pytest.fixture(autouse=True)
def seeded_uuids(monkeypatch):
    monkeypatch.setattr(r_scd_mod, "uuidlib", SeededUUID())
    monkeypatch.setattr(p_scd_mod, "uuidlib", SeededUUID())


class Twin:
    """One service on both packages: each call runs on both with its
    own copy of the arguments; the answers must be equal, and the
    reference's is returned (or its error raised)."""

    def __init__(self, ref, port, clock, stores):
        self._ref, self._port = ref, port
        self.fake_clock = clock
        self.stores = stores
        self.calls = 0

    def __getattr__(self, name):
        rf, pf = getattr(self._ref, name), getattr(self._port, name)

        def call(*args, **kw):
            r, r_exc = outcome(REF, rf, *copy.deepcopy(args),
                               **copy.deepcopy(kw))
            p, _ = outcome(PORT, pf, *copy.deepcopy(args),
                           **copy.deepcopy(kw))
            assert p == r, (name, args, kw)
            self.calls += 1
            if r_exc is not None:
                raise r_exc
            return r[1]

        return call


def make_twin(pair, service):
    port_backend, ref_backend = pair
    rc, pc = RFakeClock(T0), PFakeClock(T0)
    rs = RStore(storage=ref_backend, clock=rc)
    ps = port_store(port_backend, clock=pc)
    kind = "rid" if service == "rid" else "scd"
    ref = (RRIDService if kind == "rid" else RSCDService)(getattr(rs, kind), rc)
    port = (PRIDService if kind == "rid" else PSCDService)(
        getattr(ps, kind), pc
    )
    return Twin(ref, port, TwinClock(rc, pc), (rs, ps))


def _svc_cases(mod):
    return [
        getattr(mod, n) for n in dir(mod)
        if n.startswith("test_")
        and callable(getattr(mod, n))
        and getattr(mod, n).__code__.co_varnames[:1] == ("svc",)
        and getattr(mod, n).__code__.co_argcount == 1
    ]


CASES = (
    [("rid", f) for f in _svc_cases(ref_rid)]
    + [("scd", f) for f in _svc_cases(ref_scd)]
    + [("scd", f) for f in _svc_cases(ref_cst)]
)


def test_every_svc_case_of_the_reference_is_here():
    names = {f.__name__ for _, f in CASES}
    assert len(names) == len(CASES) == 21
    for mod in (ref_rid, ref_scd, ref_cst):
        assert {n for n in dir(mod) if n.startswith("test_")} - names <= {
            "test_constraint_wal_replay",
            "test_constraint_query_rides_the_read_cache",
        }


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize(
    "service,case", CASES, ids=[f.__name__ for _, f in CASES]
)
def test_service_case_matches_reference(service, case, pair):
    twin = make_twin(pair, service)
    try:
        case(twin)
        assert twin.calls > 0
    finally:
        for s in twin.stores:
            s.close()


# -- the two cases that build their own stores --------------------------------


def _wal_replay(p, backend, wal):
    """tests/test_scd_constraints.py::test_constraint_wal_replay on one
    package -> the observations."""
    cst, ext = ref_cst.cst_params, ref_cst.scd_extent
    clock = p.FakeClock(T0)
    store = (port_store(backend, clock=clock, wal_path=wal) if p is PORT
             else p.Store(storage=backend, clock=clock, wal_path=wal))
    svc = p.SCD(store.scd, clock)
    seen = [
        svc.put_constraint(ref_cst.CST1, cst(), "authority"),
        svc.put_constraint(ref_cst.CST2, cst(), "authority"),
        svc.put_constraint(ref_cst.CST1, cst(old_version=1), "authority"),
        svc.delete_constraint(ref_cst.CST2, "authority"),
    ]
    store.close()
    store2 = (port_store(backend, clock=clock, wal_path=wal) if p is PORT
              else p.Store(storage=backend, clock=clock, wal_path=wal))
    svc2 = p.SCD(store2.scd, clock)
    got = svc2.get_constraint(ref_cst.CST1, "authority")
    assert got["constraint_reference"]["version"] == 2
    seen.append(got)
    seen.append(outcome(p, svc2.get_constraint, ref_cst.CST2,
                        "authority")[0])
    q = svc2.query_constraints({"area_of_interest": ext()}, "x")
    assert [c["id"] for c in q["constraint_references"]] == [ref_cst.CST1]
    seen.append(q)
    store2.close()
    return seen


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_constraint_wal_replay(pair, tmp_path):
    """The reference case runs on the memory store; here each pair's
    backends, and each package replays its own WAL."""
    port_backend, ref_backend = pair
    ref = _wal_replay(REF, ref_backend, str(tmp_path / "ref.wal"))
    port = _wal_replay(PORT, port_backend, str(tmp_path / "port.wal"))
    assert port == ref
    # the two logs are the same bytes: either package boots the other's
    assert ((tmp_path / "ref.wal").read_bytes()
            == (tmp_path / "port.wal").read_bytes())


def _read_cache(p, backend):
    cst, ext = ref_cst.cst_params, ref_cst.scd_extent
    clock = p.FakeClock(T0)
    store = (port_store(backend, clock=clock) if p is PORT
             else p.Store(storage=backend, clock=clock))
    svc = p.SCD(store.scd, clock)
    try:
        seen = [svc.put_constraint(ref_cst.CST1, cst(), "authority")]
        aoi = {"area_of_interest": ext()}

        def cls_hits():
            return store.cache.class_stats("constraint")["co_cache_hits"]

        r1 = svc.query_constraints(aoi, "x")
        h0 = cls_hits()
        r2 = svc.query_constraints(aoi, "x")
        assert cls_hits() == h0 + 1, "repeat constraint poll must hit"
        assert r2 == r1
        seen += [r1, r2, cls_hits()]
        seen.append(svc.put_constraint(ref_cst.CST2, cst(), "authority"))
        r3 = svc.query_constraints(aoi, "x")
        assert sorted(c["id"] for c in r3["constraint_references"]) == [
            ref_cst.CST1, ref_cst.CST2,
        ]
        seen.append(r3)
        return seen
    finally:
        store.close()


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_constraint_query_rides_the_read_cache(pair, monkeypatch):
    monkeypatch.setenv("DSS_CACHE_ENABLE", "1")
    port_backend, ref_backend = pair
    assert _read_cache(PORT, port_backend) == _read_cache(REF, ref_backend)

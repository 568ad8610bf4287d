"""The port's server binary, black-box: `python -m dss_tpu_torch.cmds.server`.

The stack shape of tests/e2e/conftest.py (dummy-oauth plus one DSS
server, real processes over real sockets, RS256 tokens), with the
port's dummy-oauth.  State carries across the two packages: a reference
server (`python -m dss_tpu.cmds.server --storage memory`) writes a WAL
over HTTP and answers a set of reads; then a port server
(`--storage cuda --device cpu`, the kernels' plain versions) boots from
that WAL and must answer the same reads with the same status and body
(versions and OVNs included; search hits compared as sets, since a
memory store lists them in insertion order).  A few cases of tests/e2e/test_blackbox.py
then run against the port server, which must stop within
--shutdown_grace on SIGTERM.

The flags of later slices exit naming their slice, and `--device` left
at its default (`cuda`) raises on a machine without a card.  Every wait
has its own time limit.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
import uuid

import pytest
import requests
import torch

pytest.importorskip("cryptography")

from dss_tpu_torch.cmds import server as p_server
from tests.e2e import test_blackbox as bb
from tests.e2e.conftest import AUD, REPO, OauthClient, free_port

BOOT_S = 60.0
GRACE_S = 5.0


def _popen(module, *argv, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=env,
    )


def _wait_http(url, proc, what, ok=(200,)):
    deadline = time.monotonic() + BOOT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            err = proc.stderr.read().decode(errors="replace")[-4000:]
            raise RuntimeError(f"{what} exited at startup:\n{err}")
        try:
            if requests.get(url, timeout=1).status_code in ok:
                return
        except requests.RequestException:
            pass
        time.sleep(0.1)
    raise RuntimeError(f"{what} never answered {url}")


def _stop(proc, grace=GRACE_S):
    """SIGTERM -> (exit code, seconds to exit); kills past the grace."""
    if proc.poll() is not None:
        return proc.returncode, 0.0
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)
        return None, time.monotonic() - t0
    return proc.returncode, time.monotonic() - t0


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    d = tmp_path_factory.mktemp("certs")
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    (d / "oauth.key").write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ))
    (d / "oauth.pem").write_bytes(key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    ))
    return d


@pytest.fixture(scope="module")
def oauth(certs):
    """The port's dummy-oauth (/token doubles as its health probe)."""
    port = free_port()
    p = _popen("dss_tpu_torch.cmds.dummy_oauth", "--addr", f":{port}",
               "--private_key_file", str(certs / "oauth.key"))
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_http(f"{base}/token?scope=x", p, "dummy-oauth")
        yield OauthClient(base)
    finally:
        _stop(p)


def _server(module, certs, wal, *extra, env=None):
    port = free_port()
    p = _popen(
        module, "--addr", f"127.0.0.1:{port}", "--enable_scd",
        "--wal_path", str(wal),
        "--public_key_files", str(certs / "oauth.pem"),
        "--accepted_jwt_audiences", AUD,
        "--shutdown_grace", str(GRACE_S - 2), *extra, env=env,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_http(f"{base}/healthy", p, module)
    except BaseException:
        _stop(p)
        raise
    return p, base


def _port_env():
    # a one-entry graph grid a table and three units an entry: the boot
    # warm runs on the CPU without building the card's grid
    env = dict(os.environ)
    env.update(DSS_RES_BATCH_BUCKETS="128", DSS_RES_WINDOW_BUCKETS="256",
               DSS_CO_RES_INFLIGHT="1")
    return env


def _write_state(base, oauth):
    """ISAs, a RID subscription, two USSs' operations (one keyed with
    the other's OVN) and a constraint -> the reads to replay."""
    rid = oauth.hdr(bb.RID_SCOPE)
    scd1 = oauth.hdr(bb.SCD_SCOPE, sub="uss1")
    scd2 = oauth.hdr(bb.SCD_SCOPE, sub="uss2")
    cm = oauth.hdr("utm.constraint_management", sub="authority")
    ids = {k: str(uuid.uuid4()) for k in
           ("isa1", "isa2", "sub", "op1", "op2", "cst")}
    lat = 44.1

    def ok(r):
        assert r.status_code == 200, r.text
        return r.json()

    ok(requests.put(f"{base}/v1/dss/subscriptions/{ids['sub']}", json={
        "extents": bb.isa_params(lat=lat)["extents"],
        "callbacks": {"identification_service_area_url":
                      "https://u2.example.com/isa"},
    }, headers=oauth.hdr(bb.RID_SCOPE, sub="uss2"), timeout=5))
    for k, dl in (("isa1", 0.0), ("isa2", 0.01)):
        ok(requests.put(
            f"{base}/v1/dss/identification_service_areas/{ids[k]}",
            json=bb.isa_params(lat=lat + dl), headers=rid, timeout=5))
    ovn1 = ok(requests.put(
        f"{base}/dss/v1/operation_references/{ids['op1']}",
        json=bb.op_body("uss1", lat=lat), headers=scd1, timeout=5,
    ))["operation_reference"]["ovn"]
    ok(requests.put(
        f"{base}/dss/v1/operation_references/{ids['op2']}",
        json=bb.op_body("uss2", lat=lat, key=[ovn1]), headers=scd2,
        timeout=5))
    ok(requests.put(
        f"{base}/dss/v1/constraint_references/{ids['cst']}",
        json={"extents": [bb.scd_extent(lat=lat)],
              "uss_base_url": "https://authority.example.com"},
        headers=cm, timeout=5))
    area = {"area_of_interest": bb.scd_extent(lat=lat)}
    return [
        ("GET", f"/v1/dss/identification_service_areas/{ids['isa1']}",
         rid, None),
        ("GET", "/v1/dss/identification_service_areas?area="
         + bb.area_str(lat=lat), rid, None),
        ("GET", "/v1/dss/subscriptions?area=" + bb.area_str(lat=lat),
         oauth.hdr(bb.RID_SCOPE, sub="uss2"), None),
        ("GET", f"/dss/v1/operation_references/{ids['op1']}", scd1, None),
        ("POST", "/dss/v1/operation_references/query", scd1, area),
        ("POST", "/dss/v1/operation_references/query", scd2, area),
        ("POST", "/dss/v1/constraint_references/query", scd1, area),
        ("GET", f"/dss/v1/constraint_references/{ids['cst']}", cm, None),
        # a conflict answer: uss2 without uss1's OVN
        ("PUT", f"/dss/v1/operation_references/{uuid.uuid4()}", scd2,
         bb.op_body("uss2", lat=lat)),
    ]


def _ordered(x):
    """Lists of records sorted by id: a memory store lists search hits
    in insertion order and a DAR store sorts them (ROADMAP.md, "not a
    fault"); every record's fields still compare exactly."""
    if isinstance(x, dict):
        return {k: _ordered(v) for k, v in x.items()}
    if isinstance(x, list):
        x = [_ordered(v) for v in x]
        if all(isinstance(v, dict) and "id" in v for v in x):
            x.sort(key=lambda v: v["id"])
        return x
    return x


def _answers(base, reads):
    out = []
    for method, path, h, body in reads:
        r = requests.request(method, base + path, headers=h, json=body,
                             timeout=10)
        out.append((r.status_code, _ordered(r.json())))
    return out


def test_port_server_boots_from_a_reference_wal_and_serves(
        certs, oauth, tmp_path):
    wal = tmp_path / "dss.wal"
    ref, base = _server("dss_tpu.cmds.server", certs, wal,
                        "--storage", "memory")
    try:
        reads = _write_state(base, oauth)
        want = _answers(base, reads)
    finally:
        rc, _ = _stop(ref)
    assert rc is not None, "the reference server outlived its grace"
    assert [s for s, _ in want] == [200] * 8 + [409]

    port, base = _server("dss_tpu_torch.cmds.server", certs, wal,
                         "--storage", "cuda", "--device", "cpu",
                         env=_port_env())
    try:
        assert _answers(base, reads) == want
        stack = {"base": base, "oauth": oauth}
        bb.test_healthy_and_validate_oauth(stack)
        bb.test_isa_lifecycle_notifications_and_expiry(stack)
        bb.test_two_uss_ovn_conflict_over_http(stack)
        m = requests.get(base + "/metrics", timeout=10)
        assert m.status_code == 200
        assert "dss_dar_op_co_res_graph_capture_failures 0" in m.text
    finally:
        rc, dt = _stop(port)
    err = port.stderr.read().decode(errors="replace")
    # run_app turns SIGTERM into a graceful stop and returns
    assert rc == 0 and dt < GRACE_S, (rc, dt, err[-3000:])
    assert "Traceback" not in err


def test_later_slice_flags_name_their_slice(monkeypatch):
    for flag in ("DSS_FED_MAP", "DSS_PUSH", "DSS_TUNE",
                 "DSS_AUTOTUNE_PROFILE", "DSS_JAX_COORDINATOR"):
        monkeypatch.delenv(flag, raising=False)
    cases = {
        "--workers 2": "shm front", "--worker_reader": "shm front",
        "--shm_region /x": "shm front", "--federation_map m.json": "region",
        "--region_url http://x": "region", "--sharded_replica 1,2": "mesh",
        "--jax_coordinator h:1": "mesh", "--process_id 0": "mesh",
        "--num_processes 2": "mesh", "--multihost_dryrun 2": "mesh",
        "--push": "push", "--self_tune": "tuner",
        "--autotune_profile p.json": "tuner",
    }
    assert {f"--{k}" for k in p_server.LATER_SLICE_FLAGS} == {
        c.split()[0] for c in cases
    }
    parser = p_server.make_parser()
    p_server.refuse_later_slices(parser.parse_args([]))
    for argv, slice_ in cases.items():
        with pytest.raises(SystemExit, match=f"the {slice_} slice"):
            p_server.refuse_later_slices(parser.parse_args(argv.split()))
    monkeypatch.setenv("DSS_JAX_COORDINATOR", "h:1")
    with pytest.raises(SystemExit, match="the mesh slice"):
        p_server.refuse_later_slices(parser.parse_args([]))


def test_the_binary_refuses_later_slices_and_a_missing_card():
    """As processes: a later-slice flag exits 1 naming its slice before
    anything boots; `--device` left at `cuda` raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSS_PUSH", "DSS_TUNE", "DSS_FED_MAP")}
    procs = {
        "push": _popen("dss_tpu_torch.cmds.server", "--push", env=env),
        "mesh": _popen("dss_tpu_torch.cmds.server", "--sharded_replica",
                       "1,2", env=env),
        "card": _popen("dss_tpu_torch.cmds.server", "--insecure_no_auth",
                       "--addr", f"127.0.0.1:{free_port()}", env=env),
    }
    out = {}
    for k, p in procs.items():
        try:
            p.wait(timeout=BOOT_S)
        finally:
            if p.poll() is None:
                p.kill()
        out[k] = (p.returncode, p.stderr.read().decode(errors="replace"))
    assert out["push"][0] == 1 and "the push slice" in out["push"][1]
    assert out["mesh"][0] == 1 and "the mesh slice" in out["mesh"][1]
    assert out["card"][0] != 0
    assert "torch.cuda.is_available() is False" in out["card"][1]

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

The read-worker fleet (`--workers 2 --storage memory`) boots as
processes too: a search rides the shm ring, a write proxied to the
leader reads back on a worker, a SIGKILLed worker is respawned, SIGTERM
exits 0, `DSS_SHM_ENABLE=0` boots plain WAL-tail workers, and TLS is
refused with workers, as the reference refuses it.

`--sharded_replica 1,2 --virtual_devices 2` (the mesh route on two CPU
positions) serves every `/aux/v1/replica/<surface>` equal to the
store's own route once the replica has tailed the WAL; a mesh larger
than its positions exits.

The multihost flags exit naming their slice, and `--device` left at its
default (`cuda`) raises on a machine without a card, `--self_tune`
included.  `--device cpu --autotune_profile <the shipped CPU profile>
--self_tune` boots, logs the knobs the profile seeded and exports them
(and the armed tuner) in /metrics.  Every wait has its own time
limit.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

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
    """A DSS server process booted from the WAL `wal` (None: no
    --wal_path, as a region instance) -> (process, base URL)."""
    port = free_port()
    p = _popen(
        module, "--addr", f"127.0.0.1:{port}", "--enable_scd",
        *(("--wal_path", str(wal)) if wal is not None else ()),
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
        "--jax_coordinator h:1": "multihost", "--process_id 0": "multihost",
        "--num_processes 2": "multihost",
        "--multihost_dryrun 2": "multihost",
    }
    assert {f"--{k}" for k in p_server.LATER_SLICE_FLAGS} == {
        c.split()[0] for c in cases
    }
    parser = p_server.make_parser()
    p_server.refuse_later_slices(parser.parse_args([]))
    # the shm front's flags are this package's own now
    p_server.refuse_later_slices(parser.parse_args(
        "--workers 2 --worker_reader --shm_region /x".split()
    ))
    for argv, slice_ in cases.items():
        with pytest.raises(SystemExit, match=f"the {slice_} slice"):
            p_server.refuse_later_slices(parser.parse_args(argv.split()))
    # the tuner's flags are this package's own now
    tuned = parser.parse_args(
        "--self_tune --autotune_profile p.json".split())
    p_server.refuse_later_slices(tuned)
    assert tuned.self_tune and tuned.autotune_profile == "p.json"
    # the single-process mesh's flags are this package's own now
    p_server.refuse_later_slices(parser.parse_args(
        "--sharded_replica 1,2 --virtual_devices 2 "
        "--replica_refresh_interval 0.1 --no_shard_rebalance".split()
    ))
    # and so are the region's (test_region_url_boots_from_a_region_log)
    p_server.refuse_later_slices(parser.parse_args(
        "--region_url http://a,http://b --region_token_file t "
        "--region_poll_interval 0.1 --region_snapshot_every 64 "
        "--instance_id dss-a".split()
    ))
    # and so are the federation's (tests/test_torch_federation.py);
    # as in the reference, a federated region is refused with read
    # workers, before the store boots, and by a worker reader
    fed = parser.parse_args("--federation_map m.json --federation_region a"
                            .split())
    p_server.refuse_later_slices(fed)
    with pytest.raises(SystemExit, match="--workers > 0 is not supported"):
        p_server.build(parser.parse_args(
            "--federation_map m.json --workers 2".split()))
    with pytest.raises(SystemExit, match="cannot serve a federated region"):
        p_server.build(parser.parse_args(
            "--worker_reader --wal_path w --leader_url http://l "
            "--federation_map m.json".split()))
    monkeypatch.setenv("DSS_JAX_COORDINATOR", "h:1")
    with pytest.raises(SystemExit, match="the multihost slice"):
        p_server.refuse_later_slices(parser.parse_args([]))


def test_the_binary_refuses_later_slices_and_a_missing_card():
    """As processes: a later-slice flag exits 1 naming its slice before
    anything boots; `--device` left at `cuda` raises without a card,
    and `--self_tune` now gets past the arguments to that card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSS_PUSH", "DSS_TUNE", "DSS_FED_MAP")}
    procs = {
        "tuner": _popen("dss_tpu_torch.cmds.server", "--self_tune",
                        env=env),
        "multihost": _popen("dss_tpu_torch.cmds.server",
                            "--jax_coordinator", "h:1", env=env),
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
    assert out["tuner"][0] != 0
    assert "not ported yet" not in out["tuner"][1]
    assert "torch.cuda.is_available() is False" in out["tuner"][1]
    assert out["multihost"][0] == 1
    assert "the multihost slice" in out["multihost"][1]
    assert out["card"][0] != 0
    assert "torch.cuda.is_available() is False" in out["card"][1]


def test_autotune_profile_and_self_tune_boot_on_the_cpu(tmp_path):
    """`--device cpu --autotune_profile deploy/autotune/cpu-cpu-c2.json
    --self_tune`: the profile seeds every knob the environment leaves
    unset (logged), /metrics carries them as the armed tuner's active
    knobs beside the profile's age, and SIGTERM exits 0."""
    import json

    profile = REPO / "deploy" / "autotune" / "cpu-cpu-c2.json"
    knobs = json.loads(profile.read_text())["knobs"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DSS_CO_", "DSS_RES_", "DSS_SHARD_",
                                "DSS_SHM_", "DSS_TUNE"))
           and k not in ("DSS_PUSH", "DSS_FED_MAP", "DSS_AUTOTUNE_PROFILE")}
    port = free_port()
    p = _popen("dss_tpu_torch.cmds.server", "--addr", f"127.0.0.1:{port}",
               "--storage", "cuda", "--device", "cpu", "--insecure_no_auth",
               "--enable_scd", "--no_warmup",
               "--wal_path", str(tmp_path / "dss.wal"),
               "--autotune_profile", str(profile), "--self_tune", env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_http(base + "/healthy", p, "tuned server")
        text = requests.get(base + "/metrics", timeout=10).text
    finally:
        rc, dt = _stop(p)
    err = p.stderr.read().decode(errors="replace")
    assert rc == 0 and dt < GRACE_S, (rc, dt, err[-3000:])
    seeded = re.search(r"autotune profile .* \(host class cpu-cpu-c2\): "
                       r'seeded ([^"]*)', err)
    assert seeded, err[-3000:]
    assert seeded.group(1).split(", ") == [
        f"{k}={v}" for k, v in sorted(knobs.items())]
    assert "self-tuning armed" in err
    assert "Traceback" not in err
    assert _metric(text, "dss_tune_enabled") == 1.0
    assert _metric(text, "dss_autotune_profile_age_s") == 0.0  # unstamped
    active = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^dss_tune_knob_active\{knob="(\w+)"\} (\S+)$', text, re.M)}
    want = {k: float(v) for k, v in knobs.items()
            if k.startswith("DSS_CO_")}
    assert active == want


# -- the read-worker fleet (--workers) -----------------------------------------

FLEET_S = 60.0
FLEET_STOP_S = 15.0  # the leader's stop, then each worker's, under load


def _children(pid):
    """Every thread's child processes: the leader respawns from a
    watcher thread (a `children` file may list a child's threads too,
    so only thread-group leaders count)."""
    out = set()
    for task in Path(f"/proc/{pid}/task").iterdir():
        try:
            kids = (task / "children").read_text().split()
        except OSError:  # a thread that ended meanwhile
            continue
        for kid in map(int, kids):
            try:
                status = Path(f"/proc/{kid}/status").read_text()
            except OSError:
                continue
            if re.search(rf"^Tgid:\s+{kid}$", status, re.M):
                out.add(kid)
    return sorted(out)


def _fleet(tmp_path, *extra, env=None, workers=2):
    """The fleet's processes log every request: their stderr goes to a
    file (a pipe nobody drains would block them once full)."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    env["TMPDIR"] = str(tmp_path)  # the shm region's directory
    p = subprocess.Popen(
        [sys.executable, "-m", "dss_tpu_torch.cmds.server",
         "--addr", f"127.0.0.1:{port}", "--enable_scd",
         "--insecure_no_auth", "--storage", "memory",
         "--workers", str(workers), "--wal_path", str(tmp_path / "dss.wal"),
         "--shutdown_grace", str(GRACE_S - 2), *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / "fleet.log", "wb"),
    )
    base = f"http://127.0.0.1:{port}"
    try:
        # every worker up: each holds the public port
        deadline = time.monotonic() + FLEET_S
        while time.monotonic() < deadline:
            if p.poll() is not None:
                raise RuntimeError(
                    (tmp_path / "fleet.log").read_text()[-4000:])
            kids = _children(p.pid)
            up = set()
            for _ in range(8 * workers):
                try:
                    r = requests.get(base + "/metrics", timeout=2)
                except requests.RequestException:
                    break
                m = re.search(r'process="worker-?(\d*):(\d+)"', r.text)
                if m:
                    up.add(int(m.group(2)))
            if len(kids) == workers and up >= set(kids):
                return p, base
            time.sleep(0.2)
        raise RuntimeError("the fleet never came up")
    except BaseException:
        _stop(p)
        raise


def _metric(text, name):
    return sum(float(v) for v in re.findall(
        rf"^{name}(?:{{[^}}]*}})? ([0-9.e+-]+)$", text, re.M))


def _isa(base, lat):
    r = requests.put(
        f"{base}/v1/dss/identification_service_areas/{uuid.uuid4()}",
        json=bb.isa_params(lat=lat), timeout=10)
    assert r.status_code == 200, r.text
    return r.json()["service_area"]["id"]


def _search(base, lat):
    r = requests.get(f"{base}/v1/dss/identification_service_areas",
                     params={"area": bb.area_str(lat=lat)}, timeout=10)
    return r.status_code, (
        {a["id"] for a in r.json()["service_areas"]}
        if r.status_code == 200 else None)


def test_worker_fleet_serves_through_the_ring_and_respawns(tmp_path):
    p, base = _fleet(tmp_path)
    try:
        leader_cmd = Path(f"/proc/{p.pid}/cmdline").read_bytes()
        assert b"--device" not in leader_cmd
        for kid in _children(p.pid):
            argv = Path(f"/proc/{kid}/cmdline").read_bytes().split(b"\0")
            assert argv[argv.index(b"--device") + 1] == b"cpu"
            assert b"--shm_region" in argv
        # a write proxied to the leader, read back on a worker at once
        ids = set()
        for k in range(6):
            ids.add(_isa(base, 44.3))
            st, got = _search(base, 44.3)
            assert st == 200 and got == ids, k
        for _ in range(20):  # repeat polls: worker cache hits
            assert _search(base, 44.3) == (200, ids)
        m = requests.get(base + "/metrics", timeout=10).text
        assert _metric(m, "dss_shm_served_total") > 0
        assert _metric(m, "dss_shm_worker_plan_shm") > 0
        assert _metric(m, "dss_shm_worker_cache_hits") > 0
        assert _metric(m, "dss_shm_workers") == 2
        # SIGKILL one worker: the survivor serves, the leader respawns
        kids = _children(p.pid)
        os.kill(kids[0], signal.SIGKILL)
        deadline = time.monotonic() + FLEET_S
        while time.monotonic() < deadline:
            try:
                assert _search(base, 44.3) == (200, ids)
            except requests.ConnectionError:
                pass  # a connection the dead worker had accepted
            now = _children(p.pid)
            if len(now) == 2 and kids[0] not in now:
                break
            time.sleep(0.2)
        now = _children(p.pid)
        assert len(now) == 2 and kids[0] not in now, (kids, now)
        assert kids[1] in now
        deadline = time.monotonic() + FLEET_S
        seen = set()
        while time.monotonic() < deadline and seen != set(now):
            r = requests.get(base + "/metrics", timeout=10)
            mm = re.search(r'process="worker-\d+:(\d+)"', r.text)
            if mm:
                seen.add(int(mm.group(1)))
            time.sleep(0.05)
        assert seen == set(now), (seen, now)
        assert _search(base, 44.3) == (200, ids)
    finally:
        rc, dt = _stop(p, FLEET_STOP_S)
    err = (tmp_path / "fleet.log").read_text()
    assert rc == 0 and dt < FLEET_STOP_S, (rc, dt, err[-3000:])
    assert "respawned" in err and "reclaimed" in err
    assert "Traceback" not in err
    assert not list(tmp_path.glob("dss-shm-*")), "region left behind"


def test_worker_fleet_without_the_ring_tails_the_wal(tmp_path):
    env = dict(os.environ, DSS_SHM_ENABLE="0")
    p, base = _fleet(tmp_path, env=env)
    try:
        for kid in _children(p.pid):
            argv = Path(f"/proc/{kid}/cmdline").read_bytes().split(b"\0")
            assert b"--shm_region" not in argv
        i = _isa(base, 44.5)
        deadline = time.monotonic() + 10
        while _search(base, 44.5) != (200, {i}):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        m = requests.get(base + "/metrics", timeout=10).text
        assert _metric(m, "dss_shm_served_total") == 0
        assert _metric(m, "dss_shm_workers") == 0
    finally:
        rc, _ = _stop(p, FLEET_STOP_S)
    assert rc == 0


def test_workers_refuse_tls(tmp_path):
    import datetime as dt

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = dt.datetime.now(dt.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(1)
            .not_valid_before(now).not_valid_after(now + dt.timedelta(days=1))
            .sign(key, hashes.SHA256()))
    (tmp_path / "c.pem").write_bytes(
        cert.public_bytes(serialization.Encoding.PEM))
    (tmp_path / "k.pem").write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    p = _popen("dss_tpu_torch.cmds.server", "--insecure_no_auth",
               "--storage", "memory", "--workers", "2",
               "--addr", f"127.0.0.1:{free_port()}",
               "--tls_cert", str(tmp_path / "c.pem"),
               "--tls_key", str(tmp_path / "k.pem"))
    try:
        p.wait(timeout=BOOT_S)
    finally:
        if p.poll() is None:
            p.kill()
    err = p.stderr.read().decode(errors="replace")
    assert p.returncode == 1 and "--tls_cert is single-process only" in err


# -- the mesh route (--sharded_replica) ------------------------------------------


def _replica_ids(base, surface, key, h, area):
    r = requests.get(f"{base}/aux/v1/replica/{surface}",
                     params={"area": area}, headers=h, timeout=10)
    assert r.status_code == 200, r.text
    return sorted(r.json()[key]), r.json()["replica"]


def test_sharded_replica_surfaces_equal_the_store_routes(
        certs, oauth, tmp_path):
    """`--sharded_replica 1,2 --virtual_devices 2 --device cpu`: once
    the replica has tailed the WAL, every replica surface answers the
    ids its store route answers; SIGTERM exits 0."""
    wal = tmp_path / "dss.wal"
    port, base = _server(
        "dss_tpu_torch.cmds.server", certs, wal, "--storage", "cuda",
        "--device", "cpu", "--sharded_replica", "1,2",
        "--virtual_devices", "2", "--replica_refresh_interval", "0.1",
        env=_port_env(),
    )
    try:
        _write_state(base, oauth)
        lat = 44.1
        area = bb.area_str(lat=lat)
        aoi = {"area_of_interest": bb.scd_extent(lat=lat)}
        scd1 = oauth.hdr(bb.SCD_SCOPE, sub="uss1")
        rid2 = oauth.hdr(bb.RID_SCOPE, sub="uss2")

        def post(path, h):
            r = requests.post(base + path, json=aoi, headers=h, timeout=10)
            assert r.status_code == 200, r.text
            return r.json()

        want = {
            "identification_service_areas": sorted(
                x["id"] for x in requests.get(
                    f"{base}/v1/dss/identification_service_areas",
                    params={"area": area}, headers=rid2, timeout=10,
                ).json()["service_areas"]),
            "subscriptions": sorted(
                x["id"] for x in requests.get(
                    f"{base}/v1/dss/subscriptions", params={"area": area},
                    headers=rid2, timeout=10,
                ).json()["subscriptions"]),
            "operations": sorted(
                x["id"] for x in post("/dss/v1/operation_references/query",
                                      scd1)["operation_references"]),
            "scd_subscriptions": sorted(
                x["id"] for x in post("/dss/v1/subscriptions/query",
                                      scd1)["subscriptions"]),
            "constraints": sorted(
                x["id"] for x in post("/dss/v1/constraint_references/query",
                                      scd1)["constraint_references"]),
        }
        assert [len(v) for v in want.values()] == [2, 1, 2, 1, 1]
        surfaces = {
            "identification_service_areas": ("service_area_ids", rid2),
            "subscriptions": ("subscription_ids", rid2),
            "operations": ("operation_ids", scd1),
            "scd_subscriptions": ("subscription_ids", scd1),
            "constraints": ("constraint_ids", scd1),
        }
        deadline = time.monotonic() + BOOT_S
        got = {}
        while time.monotonic() < deadline:
            got = {s: _replica_ids(base, s, k, h, area)[0]
                   for s, (k, h) in surfaces.items()}
            if got == want:
                break
            time.sleep(0.2)
        assert got == want
        # another owner sees none of the owner-scoped ids
        assert _replica_ids(base, "subscriptions", "subscription_ids",
                            oauth.hdr(bb.RID_SCOPE, sub="ussx"),
                            area)[0] == []
        _, stats = _replica_ids(base, "operations", "operation_ids", scd1,
                                area)
        assert stats["replica_ops_snapshot_records"] == 2
        assert stats["dss_shard_members"] == 1
        m = requests.get(base + "/metrics", timeout=10).text
        assert "replica_rebuilds" in m and "dss_shard_boundary_moves" in m
    finally:
        rc, dt = _stop(port)
    err = port.stderr.read().decode(errors="replace")
    assert rc == 0 and dt < GRACE_S, (rc, dt, err[-3000:])
    assert "sharded replica serving all entity classes on a 1x2" in err
    assert "Traceback" not in err


def test_sharded_replica_needs_its_positions_and_a_wal():
    parser = p_server.make_parser()
    for argv, msg in (
        ("--sharded_replica 1,4 --virtual_devices 2", "needs 4 devices, "
         "have 2"),
        ("--sharded_replica 1,2", "needs 2 devices, have 1"),
        ("--sharded_replica 2", "must be 'dp,sp'"),
    ):
        args = parser.parse_args(
            f"{argv} --device cpu --wal_path /nonexistent/dss.wal".split())
        with pytest.raises(SystemExit, match=msg):
            p_server.make_replica(args, None, None)
    args = parser.parse_args("--sharded_replica 1,2 --device cpu".split())
    with pytest.raises(SystemExit, match="needs --wal_path"):
        p_server.make_replica(args, None, None)
    assert p_server.make_replica(parser.parse_args([]), None, None) is None
    assert len(p_server.mesh_devices(parser.parse_args(
        "--device cpu --virtual_devices 3".split()))) == 3


def test_region_url_boots_from_a_region_log_and_serves(certs, oauth,
                                                       tmp_path):
    """A region of processes: the port's region log server; a
    reference server with --region_url takes the writes; the port's
    server with --region_url (cuda on the CPU) boots from the log and
    answers every read as the reference instance does; a write on the
    port instance is read on the reference's.  `--workers` with
    `--region_url` exits, as in the reference."""
    rport = free_port()
    rlog = _popen("dss_tpu_torch.cmds.region_server", "--addr",
                  f"127.0.0.1:{rport}", "--wal_path",
                  str(tmp_path / "region.wal"))
    region = f"http://127.0.0.1:{rport}"
    procs = [rlog]
    try:
        _wait_http(f"{region}/healthy", rlog, "region log server")
        ref, ref_base = _server(
            "dss_tpu.cmds.server", certs, None, "--storage", "memory",
            "--region_url", region, "--region_poll_interval", "0.02",
            "--instance_id", "ref")
        procs.append(ref)
        reads = _write_state(ref_base, oauth)
        want = _answers(ref_base, reads)
        assert [st for st, _ in want] == [200] * 8 + [409]
        port, base = _server(
            "dss_tpu_torch.cmds.server", certs, None, "--storage", "cuda",
            "--device", "cpu", "--region_url", region,
            "--region_poll_interval", "0.02", "--instance_id", "port",
            env=_port_env())
        procs.append(port)
        assert _answers(base, reads) == want
        status = requests.get(base + "/status", timeout=5).json()
        assert status["epoch"] == requests.get(
            region + "/status", timeout=5).json()["epoch"]
        # a write on the port instance, read on the reference's
        isa = str(uuid.uuid4())
        rid = oauth.hdr(bb.RID_SCOPE)
        r = requests.put(
            f"{base}/v1/dss/identification_service_areas/{isa}",
            json=bb.isa_params(lat=44.3), headers=rid, timeout=5)
        assert r.status_code == 200, r.text
        deadline = time.monotonic() + 15
        while True:
            g = requests.get(
                f"{ref_base}/v1/dss/identification_service_areas/{isa}",
                headers=rid, timeout=5)
            if g.status_code == 200 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert g.status_code == 200
        assert g.json() == requests.get(
            f"{base}/v1/dss/identification_service_areas/{isa}",
            headers=rid, timeout=5).json()
        m = requests.get(base + "/metrics", timeout=10).text
        assert "region_applied" in m and "dss_breaker_state" in m
    finally:
        codes = [_stop(p)[0] for p in reversed(procs)]
    assert codes == [0] * len(procs), codes
    w = _popen("dss_tpu_torch.cmds.server", "--workers", "2",
               "--region_url", region, "--storage", "memory")
    w.wait(timeout=BOOT_S)
    assert w.returncode == 1
    assert "--workers is standalone-only" in w.stderr.read().decode()

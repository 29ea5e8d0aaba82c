"""The port's kvconfig at rest against ``minio_tpu``'s: bound to a layer,
the same ``set`` calls leave byte-equal sealed
``.mt.sys/config/config.json`` on every drive of the metadata set (with
``os.urandom`` pinned, ``_torch_iam.pin_random``); each package reads
the other's, and a plaintext blob or one sealed under an old secret is
read and resealed alike.  Over HTTP (``_torch_control.servers``) the same
admin ``set-config-kv`` calls seal the same bytes, and a restart of the
port's server in a subprocess keeps its users, service account and
``api`` knobs.  Without libcrypto the port's server does not start."""

import json
import os
import subprocess
import sys

import pytest

from minio_tpu.utils import kvconfig as ref_kv
from minio_tpu_torch import server_main
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.crypto import libcrypto
from minio_tpu_torch.utils import kvconfig as port_kv

from ._torch_control import AK, PER, SK, client, servers
from ._torch_iam import pin_random, sealed
from ._torch_versions import close, port_layer, ref_layer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS_ = [("api", "requests_max", "64"), ("api", "mem_limit", "256MiB"),
         ("pipeline", "depth", "1"), ("commit", "max_batch", "8"),
         ("heal", "max_sleep", "250ms"), ("api", "requests_max", "32")]


@pytest.fixture
def layers(tmp_path, monkeypatch):
    pin_random(monkeypatch)
    ref = ref_layer(tmp_path / "ref")
    port = port_layer(tmp_path / "port")
    yield ref, port, tmp_path
    close(ref, port)


def test_sets_seal_the_same_bytes(layers):
    ref_l, port_l, root = layers
    ref = ref_kv.Config(ref_l, secret=SK)
    port = port_kv.Config(port_l, secret=SK)
    for subsys, key, value in SETS_:
        ref.set(subsys, key, value)
        port.set(subsys, key, value)
        want = sealed(root / "ref", 6, "config/config.json")
        assert sealed(root / "port", 6, "config/config.json") == want
    for subsys in ("api", "pipeline", "commit", "heal"):
        got = port.get_subsys(subsys)
        assert got == {k: ref.get(subsys, k) for k in got}


def test_each_reads_the_others_config(layers):
    ref_l, port_l, root = layers
    for subsys, key, value in SETS_:
        ref_kv.Config(ref_l, secret=SK).set(subsys, key, value)
        port_kv.Config(port_l, secret=SK).set(subsys, key, value)
    lay = port_layer(root / "ref")
    try:
        port = port_kv.Config(lay, secret=SK)
        assert port.get("api", "requests_max") == "32"
        assert port.get("heal", "max_sleep") == "250ms"
    finally:
        close(lay)
    lay = ref_layer(root / "port")
    try:
        ref = ref_kv.Config(lay, secret=SK)
        assert ref.get("api", "mem_limit") == "256MiB"
        assert ref.get("commit", "max_batch") == "8"
    finally:
        close(lay)
    # a secret that opens nothing reads nothing
    assert port_kv.Config(port_l, secret="other").get(
        "api", "requests_max") == "0"


@pytest.mark.parametrize("start", ["plaintext", "old-secret"])
def test_a_blob_is_resealed_alike(layers, monkeypatch, start):
    ref_l, port_l, root = layers
    doc = {"api": {"requests_max": "5"}, "cache": {"enable": "off"}}
    for tag, lay in (("ref", ref_l), ("port", port_l)):
        if start == "plaintext":
            for i in range(6):
                os.makedirs(root / tag / f"d{i}/.mt.sys/config",
                            exist_ok=True)
                (root / tag / f"d{i}/.mt.sys/config/config.json"
                 ).write_bytes(json.dumps(doc).encode())
        else:
            cfg = (ref_kv if tag == "ref" else port_kv).Config(
                lay, secret="old-root-secret")
            cfg.set("api", "requests_max", "5")
    if start == "old-secret":
        monkeypatch.setenv("MT_ADMIN_SECRET_OLD", "old-root-secret")
    pin_random(monkeypatch, seed=7)
    ref = ref_kv.Config(ref_l, secret=SK)
    port = port_kv.Config(port_l, secret=SK)
    assert port.get("api", "requests_max") == ref.get(
        "api", "requests_max") == "5"
    want = sealed(root / "ref", 6, "config/config.json")
    got = sealed(root / "port", 6, "config/config.json")
    assert got == want and got[0].startswith(b"MTCFGE1\x00")
    monkeypatch.delenv("MT_ADMIN_SECRET_OLD", raising=False)
    assert port_kv.Config(port_l, secret=SK).get("api",
                                                 "requests_max") == "5"


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_each_reseals_the_others_old_config(layers, monkeypatch, direction):
    ref_l, port_l, root = layers
    w_kv, tag, r_kv, r_layer = (ref_kv, "ref", port_kv, port_layer) \
        if direction == "ref-to-port" else (port_kv, "port", ref_kv,
                                            ref_layer)
    writer_l = ref_l if tag == "ref" else port_l
    w_kv.Config(writer_l, secret="old-root-secret").set("api",
                                                        "mem_limit", "1GiB")
    monkeypatch.setenv("MT_ADMIN_SECRET_OLD", "old-root-secret")
    lay = r_layer(root / tag)
    try:
        assert r_kv.Config(lay, secret=SK).get("api", "mem_limit") == "1GiB"
    finally:
        close(lay)
    monkeypatch.delenv("MT_ADMIN_SECRET_OLD")
    assert w_kv.Config(writer_l, secret=SK).get("api",
                                                "mem_limit") == "1GiB"


# -- over HTTP, and a restart ------------------------------------------------

RESTART = r"""
import json, sys
from minio_tpu_torch import server_main
srv = server_main.build_server(sys.argv[1:], "127.0.0.1:0", "{ak}",
                               "{sk}", block_size=4096, device="cpu",
                               set_drive_count={per})
try:
    print(json.dumps({{
        "users": sorted(u.access_key for u in srv.iam.list_users()),
        "sas": sorted(u.access_key for u in srv.iam.list_service_accounts()),
        "u1": srv.iam.lookup_secret("u1"),
        "api": srv.config.get_subsys("api"),
        "req_max": srv._req_max,
        "allowed": srv.iam.is_allowed("u1", "s3:PutObject", "cfg/k")}}))
finally:
    srv.httpd.server_close()
    srv.layer.close()
"""


def test_admin_sets_seal_alike_and_survive_a_restart(tmp_path, monkeypatch):
    pin_random(monkeypatch)
    with servers(tmp_path, monkeypatch) as (ref, port):
        for srv in (ref, port):
            adm = AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)
            for subsys, key, value in SETS_:
                adm.set_config_kv(subsys, key, value)
            adm.add_policy("cfg-rw", {"Statement": [{
                "Effect": "Allow", "Action": ["s3:*"],
                "Resource": ["arn:aws:s3:::cfg/*"]}]})
            adm.add_user("u1", "u1-secret-key", ["cfg-rw"])
            sa = adm.add_service_account("u1")
            client(srv).make_bucket("cfg")
        for path in ("config/config.json", "config/iam.json"):
            want = sealed(tmp_path / "ref", PER, path)
            assert sealed(tmp_path / "port", PER, path) == want
        dirs = [str(tmp_path / "port" / f"d{i}") for i in range(2 * PER)]
    script = RESTART.format(ak=AK, sk=SK, per=PER)
    out = subprocess.run(
        [sys.executable, "-c", script, *dirs], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["users"] == ["u1"] and got["sas"] == [sa["accessKey"]]
    assert got["u1"] == "u1-secret-key" and got["allowed"]
    assert got["api"]["requests_max"] == "32" and got["req_max"] == 32
    assert got["api"]["mem_limit"] == "256MiB"


def test_without_libcrypto_the_server_does_not_start(tmp_path, monkeypatch):
    monkeypatch.setattr(libcrypto, "available", lambda: False)
    monkeypatch.setattr(libcrypto, "unavailable_reason",
                        lambda: "no libcrypto here")
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    with pytest.raises(RuntimeError, match="no libcrypto here"):
        server_main.build_server(dirs, "127.0.0.1:0", AK, SK,
                                 block_size=4096, device="cpu")
    assert not any(os.path.exists(os.path.join(d, ".mt.sys")) for d in dirs)

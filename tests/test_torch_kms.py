"""The port's key services against ``minio_tpu``'s: the local master-key
service (its data keys equal under the same draws and each package
unsealing the other's, the context bound into the seal, the key stored
on the drives and read back at the next boot, a malformed key refused),
the choice of service from the environment (KES, then Vault, then the
local one), the KES and Vault clients against the stubs the reference's
tests use (``tests/kes_stub.py``, ``tests/vault_stub.py``), SSE-KMS on
the port's server through KES and Vault, and the admin
``kms-key-status`` route."""

import base64
import json
import os

import pytest

from minio_tpu.crypto import kms as ref_kms
from minio_tpu.objectlayer.sets import ErasureSets as RefSets
from minio_tpu_torch.crypto import kms as port_kms
from minio_tpu_torch.crypto.kes import KESKMS
from minio_tpu_torch.crypto.vault import VaultKMS
from minio_tpu_torch.objectlayer.sets import ErasureSets as PortSets
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server

from ._torch_control import both, servers
from ._torch_versions import Draws, body, pin
from .kes_stub import API_KEY, KESStubServer
from .vault_stub import ROLE_ID, ROOT_TOKEN, SECRET_ID, VaultStubServer

CTX = {"bucket": "b", "object": "o"}


def test_local_data_keys_equal_the_references(monkeypatch):
    pin(monkeypatch, draws=5)
    ref = ref_kms.LocalKMS("kid", bytes(range(32)))
    port = port_kms.LocalKMS("kid", bytes(range(32)))
    for _ in range(3):
        (rp, rs), (pp, ps) = ref.generate_key(CTX), port.generate_key(CTX)
        assert (pp, ps) == (rp, rs)
        assert port.unseal_key(rs, CTX) == ref.unseal_key(ps, CTX) == rp


def test_local_seal_is_bound_to_its_context_and_key():
    kms = port_kms.LocalKMS("kid", bytes(32))
    plain, sealed = kms.generate_key(CTX)
    with pytest.raises(port_kms.KMSError):
        kms.unseal_key(sealed, {"bucket": "b", "object": "other"})
    with pytest.raises(port_kms.KMSError):
        port_kms.LocalKMS("other-id", bytes(32)).unseal_key(sealed, CTX)
    with pytest.raises(port_kms.KMSError):
        port_kms.LocalKMS("kid", bytes([1] * 32)).unseal_key(sealed, CTX)
    with pytest.raises(port_kms.KMSError):
        kms.unseal_key("not base64 at all", CTX)
    assert kms.unseal_key(sealed, CTX) == plain


@pytest.mark.parametrize("spec", ["nocolon", "id:!!!", "id:" +
                                  base64.b64encode(b"short").decode(),
                                  ":" + base64.b64encode(bytes(32)).decode()])
def test_malformed_master_keys_are_refused_alike(monkeypatch, spec):
    monkeypatch.setenv(port_kms.MASTER_KEY_ENV, spec)
    with pytest.raises(ref_kms.KMSError):
        ref_kms.LocalKMS()
    with pytest.raises(port_kms.KMSError):
        port_kms.LocalKMS()


def _layers(root, n=4):
    dirs = {t: [str(root / t / f"d{i}") for i in range(n)]
            for t in ("ref", "port")}
    for ds in dirs.values():
        for d in ds:
            os.makedirs(d)
    ref = RefSets.from_dirs(dirs["ref"], 1, n, backend="numpy",
                            block_size=4096)
    port = PortSets.from_dirs(dirs["port"], 1, n, block_size=4096,
                              device="cpu")
    return ref, port


def _close(ref, port):
    port.close()
    for s in ref.sets:
        s._pool.shutdown(wait=True)


def test_master_key_is_stored_and_read_back_alike(tmp_path, monkeypatch):
    """Without the environment's key each package mints one, stores it
    in the system volume as the other does, and reads it back at the
    next boot; a stored key that does not parse fails the boot."""
    monkeypatch.delenv(port_kms.MASTER_KEY_ENV, raising=False)
    monkeypatch.setattr(os, "urandom", Draws(9))
    ref, port = _layers(tmp_path)
    try:
        rk = ref_kms.LocalKMS.from_env_or_store(ref)
        pk = port_kms.LocalKMS.from_env_or_store(port)
        assert (pk.key_id, pk._master) == (rk.key_id, rk._master)
        stored = [(tmp_path / t / f"d{i}" / ".mt.sys" / "config" /
                   "kms-master.key").read_bytes()
                  for t in ("ref", "port") for i in range(4)]
        assert len(set(stored)) == 1
        again = port_kms.LocalKMS.from_env_or_store(port)
        assert again._master == pk._master
        # the port reads the reference's store
        other = PortSets.from_dirs(
            [str(tmp_path / "ref" / f"d{i}") for i in range(4)], 1, 4,
            block_size=4096, device="cpu")
        try:
            assert port_kms.LocalKMS.from_env_or_store(other)._master \
                == rk._master
        finally:
            other.close()
        for i in range(4):
            (tmp_path / "port" / f"d{i}" / ".mt.sys" / "config" /
             "kms-master.key").write_bytes(b"garbage")
        with pytest.raises(port_kms.KMSError):
            port_kms.LocalKMS.from_env_or_store(port)
    finally:
        _close(ref, port)


def test_environment_picks_kes_then_vault_then_local(tmp_path, monkeypatch):
    kes, vault = KESStubServer().start(), VaultStubServer().start()
    ref, port = _layers(tmp_path)
    try:
        monkeypatch.setenv(port_kms.MASTER_KEY_ENV,
                           "env-key:" + base64.b64encode(bytes(32)).decode())
        assert type(port_kms.kms_from_env(port)).__name__ == "LocalKMS"
        assert port_kms.kms_from_env(port).key_id == "env-key"
        monkeypatch.setenv(port_kms.VAULT_ENDPOINT_ENV, vault.endpoint)
        monkeypatch.setenv(port_kms.VAULT_TOKEN_ENV, ROOT_TOKEN)
        assert isinstance(port_kms.kms_from_env(port), VaultKMS)
        monkeypatch.setenv(port_kms.KES_ENDPOINT_ENV, kes.endpoint)
        monkeypatch.setenv(port_kms.KES_APIKEY_ENV, API_KEY)
        got = port_kms.kms_from_env(port)
        assert isinstance(got, KESKMS) and got.key_id == "minio-tpu-sse"
        assert type(ref_kms.kms_from_env(ref)).__name__ == "KESKMS"
        # a KES that refuses fails the boot, never falls back
        monkeypatch.setenv(port_kms.KES_APIKEY_ENV, "wrong")
        with pytest.raises(port_kms.KMSError):
            port_kms.kms_from_env(port)
    finally:
        _close(ref, port)
        kes.stop()
        vault.stop()


# -- KES and Vault (the reference's tests/test_sse.py:407-540) -----------------

def test_kes_round_trip_and_context_binding():
    stub = KESStubServer().start()
    try:
        k = KESKMS(stub.endpoint, "sse-key", api_key=API_KEY)
        plain, sealed = k.generate_key(CTX)
        assert len(plain) == 32
        assert plain not in base64.b64decode(sealed)
        assert k.unseal_key(sealed, CTX) == plain
        with pytest.raises(port_kms.KMSError):
            k.unseal_key(sealed, {"bucket": "b", "object": "other"})
        assert stub.generated == 1 and stub.decrypted == 1
        # the reference's client unseals what the port's sealed
        from minio_tpu.crypto.kes import KESKMS as RefKES
        assert RefKES(stub.endpoint, "sse-key",
                      api_key=API_KEY).unseal_key(sealed, CTX) == plain
    finally:
        stub.stop()


def test_kes_refuses_a_bad_api_key_and_creates_idempotently():
    stub = KESStubServer().start()
    try:
        with pytest.raises(port_kms.KMSError):
            KESKMS(stub.endpoint, "k2", api_key="wrong")
        KESKMS(stub.endpoint, "samekey", api_key=API_KEY)
        KESKMS(stub.endpoint, "samekey", api_key=API_KEY)
        assert list(stub.keys) == ["samekey"]
    finally:
        stub.stop()
    with pytest.raises(port_kms.KMSError, match="unreachable"):
        KESKMS(stub.endpoint, "k3", api_key=API_KEY)


def test_vault_token_and_approle():
    stub = VaultStubServer().start()
    try:
        kt = VaultKMS(stub.endpoint, "vkey", token=ROOT_TOKEN)
        ctx = {"bucket": "vb", "object": "vo"}
        plain, sealed = kt.generate_key(ctx)
        assert kt.unseal_key(sealed, ctx) == plain
        _, ct = base64.b64decode(sealed).split(b"\x00", 1)
        assert ct.startswith(b"vault:v1:")
        ka = VaultKMS(stub.endpoint, "vkey", role_id=ROLE_ID,
                      secret_id=SECRET_ID)
        assert ka.unseal_key(sealed, ctx) == plain
        with pytest.raises(port_kms.KMSError):
            ka.unseal_key(sealed, {"bucket": "vb", "object": "x"})
        with pytest.raises(port_kms.KMSError):
            VaultKMS(stub.endpoint, "vkey", role_id=ROLE_ID,
                     secret_id="wrong")
        with pytest.raises(port_kms.KMSError):
            VaultKMS(stub.endpoint, "vkey", token="s.bogus")
        with pytest.raises(port_kms.KMSError):
            VaultKMS(stub.endpoint, "vkey")
    finally:
        stub.stop()


@pytest.mark.parametrize("service", ["kes", "vault"])
def test_sse_kms_on_the_port_server_through_the_service(tmp_path,
                                                        monkeypatch,
                                                        service):
    """The server's key service comes from the environment; a GET unseals
    through it, and with the service's keys gone the object cannot be
    read: the key lives in the service, not in the process or on the
    drives."""
    stub = (KESStubServer() if service == "kes" else VaultStubServer()
            ).start()
    if service == "kes":
        monkeypatch.setenv(port_kms.KES_ENDPOINT_ENV, stub.endpoint)
        monkeypatch.setenv(port_kms.KES_APIKEY_ENV, API_KEY)
    else:
        monkeypatch.setenv(port_kms.VAULT_ENDPOINT_ENV, stub.endpoint)
        monkeypatch.setenv(port_kms.VAULT_ROLE_ID_ENV, ROLE_ID)
        monkeypatch.setenv(port_kms.VAULT_SECRET_ID_ENV, SECRET_ID)
    _, layer = _layers(tmp_path)
    srv = S3Server(layer, access_key="k", secret_key="secret-key")
    srv.start()
    try:
        assert isinstance(srv.kms, KESKMS if service == "kes" else VaultKMS)
        c = S3Client(srv.endpoint, "k", "secret-key")
        c.make_bucket("kmsb")
        data = body(200_000, 1)
        c.put_object("kmsb", "doc.bin", data,
                     headers={"x-amz-server-side-encryption": "aws:kms"})
        got = c.get_object("kmsb", "doc.bin")
        assert got.body == data
        assert got.headers["x-amz-server-side-encryption"] == "aws:kms"
        on_disk = b"".join(p.read_bytes()
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
        assert data[:4096] not in on_disk
        for secret in getattr(stub, "keys", {}).values():
            assert secret not in on_disk
        if service == "kes":
            stub.keys.clear()
            assert c.request("GET", "/kmsb/doc.bin", expect=()).status >= 400
    finally:
        srv.stop()
        layer.close()
        stub.stop()


def test_kms_key_status_answers_alike(tmp_path):
    mp = pytest.MonkeyPatch()
    mp.setenv(port_kms.MASTER_KEY_ENV,
              "status-key:" + base64.b64encode(bytes(32)).decode())
    try:
        with servers(tmp_path, mp) as (ref, port):
            r, p = both(ref, port, "GET", "/minio-tpu/admin/v1/kms-key-status")
            assert p.status == r.status == 200
            assert json.loads(p.body) == json.loads(r.body) == {
                "key_id": "status-key", "encryption_ok": True,
                "decryption_ok": True}
    finally:
        mp.undo()

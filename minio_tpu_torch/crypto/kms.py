"""The key service of SSE-S3 and SSE-KMS (``minio_tpu/crypto/kms.py``,
cmd/crypto/kms.go): fresh data keys, sealed by a master key and bound to
the (bucket, object) they were made for.

``LocalKMS`` keeps its master key in the process: from
``MINIO_TPU_KMS_SECRET_KEY`` (``<key-id>:<base64 of 32 bytes>``), else the
key stored in the system volume (``config/kms-master.key``), else a new
one that it stores there (``from_env_or_store``).  A data key is sealed
with DARE under an HMAC of the master key, the key id and the context,
so a sealed key moved onto another object's path does not open.
``kms_from_env`` picks the server's service in the reference's order:
KES (``crypto/kes.py``), then Vault (``crypto/vault.py``), then the local
one; each has ``key_id``, ``generate_key`` and ``unseal_key``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os

from . import dare

MASTER_KEY_ENV = "MINIO_TPU_KMS_SECRET_KEY"   # "<key-id>:<base64-32-bytes>"
KES_ENDPOINT_ENV = "MINIO_TPU_KMS_KES_ENDPOINT"
KES_KEY_ENV = "MINIO_TPU_KMS_KES_KEY_NAME"
KES_APIKEY_ENV = "MINIO_TPU_KMS_KES_API_KEY"
VAULT_ENDPOINT_ENV = "MINIO_TPU_KMS_VAULT_ENDPOINT"
VAULT_KEY_ENV = "MINIO_TPU_KMS_VAULT_KEY_NAME"
VAULT_TOKEN_ENV = "MINIO_TPU_KMS_VAULT_TOKEN"
VAULT_ROLE_ID_ENV = "MINIO_TPU_KMS_VAULT_APPROLE_ID"
VAULT_SECRET_ID_ENV = "MINIO_TPU_KMS_VAULT_APPROLE_SECRET"
DEFAULT_KEY_NAME = "minio-tpu-sse"


class KMSError(Exception):
    pass


_default: "LocalKMS | None" = None


def default_kms() -> "LocalKMS":
    """A process-wide local service, for use without a server (a server
    builds its own with ``kms_from_env``)."""
    global _default
    if _default is None:
        _default = LocalKMS()
    return _default


def kms_from_env(layer):
    """The server's key service: KES when its endpoint is set, else
    Vault, else ``LocalKMS.from_env_or_store(layer)``.  A KES or Vault
    that cannot be reached fails the boot: falling back to a local key
    would seal new objects under a key nobody configured."""
    kes_ep = os.environ.get(KES_ENDPOINT_ENV, "")
    if kes_ep:
        from .kes import KESKMS
        return KESKMS(kes_ep, os.environ.get(KES_KEY_ENV, DEFAULT_KEY_NAME),
                      api_key=os.environ.get(KES_APIKEY_ENV, ""))
    vault_ep = os.environ.get(VAULT_ENDPOINT_ENV, "")
    if vault_ep:
        from .vault import VaultKMS
        return VaultKMS(vault_ep,
                        os.environ.get(VAULT_KEY_ENV, DEFAULT_KEY_NAME),
                        token=os.environ.get(VAULT_TOKEN_ENV, ""),
                        role_id=os.environ.get(VAULT_ROLE_ID_ENV, ""),
                        secret_id=os.environ.get(VAULT_SECRET_ID_ENV, ""))
    return LocalKMS.from_env_or_store(layer)


class LocalKMS:
    """One master key in the process (cmd/crypto/kms.go masterKeyKMS)."""

    _STORE_PATH = "config/kms-master.key"

    def __init__(self, key_id: str = "minio-tpu-default-key",
                 master_key: bytes | None = None):
        """Without ``master_key``: the environment's, else a random one
        that lives as long as the process."""
        if master_key is None:
            spec = os.environ.get(MASTER_KEY_ENV, "")
            if spec:
                key_id, master_key = self._parse_spec(spec)
            else:
                master_key = os.urandom(32)
        if len(master_key) != 32:
            raise KMSError("master key must be 32 bytes")
        self.key_id = key_id
        self._master = master_key

    @staticmethod
    def _parse_spec(spec: str) -> tuple[str, bytes]:
        """``<key-id>:<base64 key>``; a malformed one raises, never falls
        back to another key."""
        key_id, sep, b64 = spec.partition(":")
        if not sep:
            raise KMSError(
                f"malformed {MASTER_KEY_ENV}: want '<key-id>:<base64-key>'")
        try:
            key = base64.b64decode(b64, validate=True)
        except Exception as e:  # noqa: BLE001 — any malformed base64
            raise KMSError(f"malformed {MASTER_KEY_ENV}: bad base64 key") \
                from e
        if len(key) != 32 or not key_id:
            raise KMSError(f"malformed {MASTER_KEY_ENV}: key must be 32 "
                           "bytes")
        return key_id, key

    @classmethod
    def from_env_or_store(cls, layer) -> "LocalKMS":
        """The environment's key, else the one stored on the drives of the
        layer's metadata set, else a new one stored there, so SSE-S3 and
        SSE-KMS objects outlive a restart.  A stored key that does not
        parse, or a store no drive could be read from, fails: a new key
        would orphan every object sealed under the old one."""
        spec = os.environ.get(MASTER_KEY_ENV, "")
        if spec:
            return cls(*cls._parse_spec(spec))
        from ..storage import errors as serrors
        from ..storage.xl_storage import SYS_DIR
        er = layer.meta_set
        blobs, errs = er._fanout(
            lambda d: d.read_all(SYS_DIR, cls._STORE_PATH), er.disks)
        for b in blobs:
            if b:
                return cls(*cls._parse_spec(b.decode()))
        hard = [e for e in errs if e is not None and not isinstance(
            e, (serrors.FileNotFound, serrors.VolumeNotFound))]
        if hard:
            raise KMSError(f"cannot read KMS master key store: {hard[0]}")
        kms = cls("minio-tpu-auto-key", os.urandom(32))
        stored = (kms.key_id + ":" +
                  base64.b64encode(kms._master).decode()).encode()
        er._fanout(lambda d: d.write_all(SYS_DIR, cls._STORE_PATH, stored),
                   er.disks)
        return kms

    def _kek(self, key_id: str, context: dict[str, str]) -> bytes:
        ctx = json.dumps(context, sort_keys=True,
                         separators=(",", ":")).encode()
        return hmac.new(self._master, key_id.encode() + b"\x00" + ctx,
                        hashlib.sha256).digest()

    def generate_key(self, context: dict[str, str]) -> tuple[bytes, str]:
        """A new 256-bit data key: (plain, sealed as base64)."""
        plain = os.urandom(32)
        sealed = dare.encrypt(self._kek(self.key_id, context), plain)
        return plain, base64.b64encode(
            self.key_id.encode() + b"\x00" + sealed).decode()

    def unseal_key(self, sealed_b64: str, context: dict[str, str]) -> bytes:
        try:
            key_id, sealed = base64.b64decode(sealed_b64).split(b"\x00", 1)
        except Exception as e:  # noqa: BLE001 — any malformed blob
            raise KMSError("malformed sealed key") from e
        if key_id.decode() != self.key_id:
            raise KMSError(f"unknown KMS key id {key_id!r}")
        try:
            return dare.decrypt(self._kek(self.key_id, context), sealed)
        except dare.DAREError as e:
            raise KMSError("failed to unseal data key") from e

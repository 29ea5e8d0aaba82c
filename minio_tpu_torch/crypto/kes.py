"""KES as the key service (``minio_tpu/crypto/kes.py``,
cmd/crypto/kes.go).

KES keeps the master key: ``/v1/key/create/<name>`` makes it,
``/v1/key/generate/<name>`` returns a new data key in plain and sealed
under it, ``/v1/key/decrypt/<name>`` unseals one; the context (bucket,
object) is bound into the seal.  The client sends its API key as a
bearer token.  ``KESKMS`` has ``LocalKMS``'s surface, so SSE-S3 and
SSE-KMS run through it unchanged, and the master key is never in this
process.
"""

from __future__ import annotations

import base64
from urllib.parse import quote

from ._rest import JSONService, context_bytes
from .kms import KMSError


class KESClient:
    """The KES calls the port makes: create, generate, decrypt."""

    def __init__(self, endpoint: str, api_key: str = "",
                 timeout: float = 10.0):
        self._svc = JSONService("kes", endpoint, 7373, timeout)
        self.api_key = api_key

    def _request(self, path: str, doc: dict | None = None,
                 ok=(200,)) -> dict:
        hdrs = {"Authorization": f"Bearer {self.api_key}"} \
            if self.api_key else {}
        return self._svc.request("POST", path, doc, hdrs, ok,
                                 lambda d: d.get("message", ""))

    def create_key(self, name: str) -> None:
        """Make the master key; one that exists already is fine."""
        try:
            self._request(f"/v1/key/create/{quote(name)}", ok=(200, 201))
        except KMSError as e:
            if "already exists" not in str(e):
                raise

    def generate_key(self, name: str, context: bytes
                     ) -> tuple[bytes, bytes]:
        """(plain data key, its sealed bytes)."""
        doc = self._request(f"/v1/key/generate/{quote(name)}",
                            {"context": base64.b64encode(context).decode()})
        return (base64.b64decode(doc["plaintext"]),
                base64.b64decode(doc["ciphertext"]))

    def decrypt_key(self, name: str, ciphertext: bytes,
                    context: bytes) -> bytes:
        doc = self._request(
            f"/v1/key/decrypt/{quote(name)}",
            {"ciphertext": base64.b64encode(ciphertext).decode(),
             "context": base64.b64encode(context).decode()})
        return base64.b64decode(doc["plaintext"])


class KESKMS:
    """A key service whose master key lives in KES (kesService)."""

    def __init__(self, endpoint: str, key_name: str, api_key: str = "",
                 create: bool = True):
        self.client = KESClient(endpoint, api_key)
        self.key_id = key_name
        if create:
            self.client.create_key(key_name)

    def generate_key(self, context: dict[str, str]) -> tuple[bytes, str]:
        plain, sealed = self.client.generate_key(self.key_id,
                                                 context_bytes(context))
        return plain, base64.b64encode(
            self.key_id.encode() + b"\x00" + sealed).decode()

    def unseal_key(self, sealed_b64: str, context: dict[str, str]) -> bytes:
        try:
            key_id, sealed = base64.b64decode(sealed_b64).split(b"\x00", 1)
        except Exception as e:  # noqa: BLE001 — any malformed blob
            raise KMSError("malformed sealed key") from e
        return self.client.decrypt_key(key_id.decode(), sealed,
                                       context_bytes(context))

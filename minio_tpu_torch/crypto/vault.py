"""HashiCorp Vault's transit engine as the key service
(``minio_tpu/crypto/vault.py``, cmd/crypto/vault.go).

Data keys come from ``/v1/transit/datakey/plaintext/<name>`` and are
unsealed by ``/v1/transit/decrypt/<name>``, with the (bucket, object)
context bound into the ciphertext.  The client signs in with a static
token (``X-Vault-Token``) or an AppRole login
(``/v1/auth/approle/login``).  ``VaultKMS`` has ``LocalKMS``'s surface,
and the master key never leaves Vault.
"""

from __future__ import annotations

import base64
from urllib.parse import quote

from ._rest import JSONService, context_bytes
from .kms import KMSError


class VaultClient:
    """Token or AppRole sign-in, and the transit calls."""

    def __init__(self, endpoint: str, token: str = "", role_id: str = "",
                 secret_id: str = "", timeout: float = 10.0):
        self._svc = JSONService("vault", endpoint, 8200, timeout)
        self.token = token
        if not token:
            if not role_id:
                raise KMSError("vault: need a token or approle role_id")
            self.token = self._approle_login(role_id, secret_id)

    def _request(self, path: str, doc: dict | None, auth: bool = True
                 ) -> dict:
        hdrs = {"X-Vault-Token": self.token} if auth else {}
        return self._svc.request("POST", path, doc, hdrs, (200, 204),
                                 lambda d: ",".join(d.get("errors", [])))

    def _approle_login(self, role_id: str, secret_id: str) -> str:
        doc = self._request("/v1/auth/approle/login",
                            {"role_id": role_id, "secret_id": secret_id},
                            auth=False)
        token = doc.get("auth", {}).get("client_token", "")
        if not token:
            raise KMSError("vault approle login returned no token")
        return token

    def create_transit_key(self, name: str) -> None:
        """Make the key (Vault answers 204 when it exists already)."""
        self._request(f"/v1/transit/keys/{quote(name)}", {})

    def generate_data_key(self, name: str, context: bytes
                          ) -> tuple[bytes, str]:
        d = self._request(f"/v1/transit/datakey/plaintext/{quote(name)}",
                          {"context": base64.b64encode(context).decode()}
                          ).get("data", {})
        return base64.b64decode(d["plaintext"]), d["ciphertext"]

    def decrypt(self, name: str, ciphertext: str, context: bytes) -> bytes:
        doc = self._request(f"/v1/transit/decrypt/{quote(name)}",
                            {"ciphertext": ciphertext,
                             "context": base64.b64encode(context).decode()})
        return base64.b64decode(doc["data"]["plaintext"])


class VaultKMS:
    """A key service over Vault transit (vaultService)."""

    def __init__(self, endpoint: str, key_name: str, token: str = "",
                 role_id: str = "", secret_id: str = "",
                 create: bool = True):
        self.client = VaultClient(endpoint, token=token, role_id=role_id,
                                  secret_id=secret_id)
        self.key_id = key_name
        if create:
            self.client.create_transit_key(key_name)

    def generate_key(self, context: dict[str, str]) -> tuple[bytes, str]:
        plain, ct = self.client.generate_data_key(self.key_id,
                                                  context_bytes(context))
        return plain, base64.b64encode(
            self.key_id.encode() + b"\x00" + ct.encode()).decode()

    def unseal_key(self, sealed_b64: str, context: dict[str, str]) -> bytes:
        try:
            key_id, ct = base64.b64decode(sealed_b64).split(b"\x00", 1)
        except Exception as e:  # noqa: BLE001 — any malformed blob
            raise KMSError("malformed sealed key") from e
        return self.client.decrypt(key_id.decode(), ct.decode(),
                                   context_bytes(context))

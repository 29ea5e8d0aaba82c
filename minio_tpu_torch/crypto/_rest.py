"""One JSON request to a key service over HTTP(S), for the KES and
Vault clients (``crypto/kes.py``, ``crypto/vault.py``)."""

from __future__ import annotations

import http.client
import json
from urllib.parse import urlsplit

from .kms import KMSError


class JSONService:
    """A key service's endpoint: ``request`` sends one JSON document and
    returns the answer's; a status outside ``ok``, a malformed answer or
    a service that cannot be reached raise KMSError naming it."""

    def __init__(self, name: str, endpoint: str, default_port: int,
                 timeout: float = 10.0):
        u = urlsplit(endpoint)
        self.name = name
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if u.scheme == "https" else default_port)
        self._cls = http.client.HTTPSConnection \
            if u.scheme == "https" else http.client.HTTPConnection
        self.timeout = timeout

    def request(self, method: str, path: str, doc: dict | None,
                headers: dict, ok, error_of) -> dict:
        conn = self._cls(self._host, self._port, timeout=self.timeout)
        try:
            body = json.dumps(doc).encode() if doc is not None else b""
            hdrs = dict(headers)
            if body:
                hdrs["Content-Type"] = "application/json"
            conn.request(method, path, body=body or None, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status not in ok:
                try:
                    msg = error_of(json.loads(data))
                except (ValueError, UnicodeDecodeError, AttributeError):
                    msg = ""
                raise KMSError(f"{self.name} {method} {path}: "
                               f"{resp.status} {msg}")
            try:
                return json.loads(data) if data else {}
            except ValueError as e:
                raise KMSError(f"{self.name} returned malformed JSON: "
                               f"{e}") from e
        except OSError as e:
            raise KMSError(f"{self.name} unreachable: {e}") from e
        finally:
            conn.close()


def context_bytes(context: dict[str, str]) -> bytes:
    """The (bucket, object) context as the services bind it."""
    return json.dumps(context, sort_keys=True,
                      separators=(",", ":")).encode()

"""An etcd v3 client over the grpc-gateway JSON API
(``minio_tpu/utils/etcd.py``, cmd/etcd.go).

Every etcd v3 server answers the KV API as JSON POSTs with base64 keys
and values (``/v3/kv/put``, ``/range``, ``/deleterange``, ``/txn``); this
client speaks that, trying each endpoint in turn.  IAM keeps its state
here when the ``etcd`` subsystem names endpoints (``iam/sys.py``
``attach_etcd``).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request


class EtcdError(Exception):
    pass


def _b64(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode()
    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def prefix_range_end(prefix: bytes) -> bytes:
    """The ``range_end`` of a prefix query: the prefix with its last byte
    below 0xFF raised by one (the whole keyspace, ``\\0``, for none)."""
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[:i + 1])
    return b"\x00"


class EtcdClient:
    """put, put_if_absent, get, get_prefix, delete, delete_prefix and
    status over the endpoints (``host:port`` or URLs, a list or a comma
    list), failing over in order."""

    def __init__(self, endpoints: list[str] | str, timeout: float = 10.0):
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",")
                         if e.strip()]
        if not endpoints:
            raise EtcdError("no etcd endpoints configured")
        self._eps = [e.rstrip("/") if e.startswith("http")
                     else f"http://{e.rstrip('/')}" for e in endpoints]
        self._timeout = timeout

    def _call(self, path: str, body: dict) -> dict:
        payload = json.dumps(body).encode()
        last: Exception | None = None
        for ep in self._eps:
            try:
                req = urllib.request.Request(
                    ep + path, data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=self._timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except (urllib.error.URLError, OSError,
                    json.JSONDecodeError) as e:
                last = e
        raise EtcdError(f"all etcd endpoints failed: {last}")

    def put(self, key: str | bytes, value: bytes | str) -> None:
        self._call("/v3/kv/put", {"key": _b64(key), "value": _b64(value)})

    def put_if_absent(self, key: str | bytes, value: bytes | str) -> bool:
        """Create ``key`` in one transaction guarded by its create
        revision: True when this call created it."""
        out = self._call("/v3/kv/txn", {
            "compare": [{"key": _b64(key), "target": "CREATE",
                         "result": "EQUAL", "create_revision": "0"}],
            "success": [{"request_put": {"key": _b64(key),
                                         "value": _b64(value)}}],
            "failure": [],
        })
        return bool(out.get("succeeded"))

    def get(self, key: str | bytes) -> bytes | None:
        kvs = self._call("/v3/kv/range", {"key": _b64(key)}).get("kvs") or []
        return _unb64(kvs[0]["value"]) if kvs else None

    def get_prefix(self, prefix: str | bytes) -> list[tuple[bytes, bytes]]:
        p = prefix.encode() if isinstance(prefix, str) else prefix
        out = self._call("/v3/kv/range", {
            "key": _b64(p), "range_end": _b64(prefix_range_end(p))})
        return [(_unb64(kv["key"]), _unb64(kv["value"]))
                for kv in out.get("kvs") or []]

    def delete(self, key: str | bytes) -> int:
        out = self._call("/v3/kv/deleterange", {"key": _b64(key)})
        return int(out.get("deleted", 0))

    def delete_prefix(self, prefix: str | bytes) -> int:
        p = prefix.encode() if isinstance(prefix, str) else prefix
        out = self._call("/v3/kv/deleterange", {
            "key": _b64(p), "range_end": _b64(prefix_range_end(p))})
        return int(out.get("deleted", 0))

    def status(self) -> bool:
        try:
            self._call("/v3/kv/range", {"key": _b64(b"\x00")})
            return True
        except EtcdError:
            return False


def from_config(cfg) -> EtcdClient | None:
    """The client the ``etcd`` subsystem's ``endpoints`` name; None when
    they are empty (IAM then stays on the drives)."""
    try:
        eps = cfg.get("etcd", "endpoints")
    except KeyError:
        return None
    return EtcdClient(eps) if eps else None

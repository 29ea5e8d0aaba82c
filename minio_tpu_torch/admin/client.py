"""Admin client (``minio_tpu/admin/client.py``, the pkg/madmin role): the
routes of ``admin/handlers.py`` over the S3 client's SigV4 transport, and
the metrics scrape.

    adm = AdminClient("http://127.0.0.1:9000", "minioadmin", "minioadmin")
    adm.set_config_kv("pipeline", "depth", "0")
    adm.heal("bucket")
    text = adm.metrics()
"""

from __future__ import annotations

import json
from typing import Any

from ..s3.client import S3Client, S3ClientError

__all__ = ["AdminClient", "AdminError"]


class AdminError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class AdminClient:
    PREFIX = "/minio-tpu/admin/v1"

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        self._c = S3Client(endpoint, access_key, secret_key, region)

    def _call(self, method: str, route: str, query: str = "",
              body: bytes = b"") -> Any:
        """One signed admin call; its JSON answer.  AdminError carries the
        route's own message ({"error": ...}) or the S3 error's code."""
        try:
            r = self._c.request(method, f"{self.PREFIX}/{route}", query,
                                body, expect=())
        except S3ClientError as e:
            raise AdminError(e.status, str(e)) from e
        if r.status != 200:
            try:
                msg = json.loads(r.body).get("error", "")
            except (ValueError, AttributeError):
                try:
                    msg = r.xml().findtext("Code") or ""
                except Exception:  # noqa: BLE001 — neither JSON nor XML
                    msg = r.body.decode("utf-8", "replace")[:200]
            raise AdminError(r.status, msg or f"HTTP {r.status}")
        return json.loads(r.body) if r.body else None

    def server_info(self) -> dict:
        return self._call("GET", "info")

    def storage_info(self) -> dict:
        return self._call("GET", "storageinfo")

    def get_config_kv(self, subsys: str = "") -> dict:
        """One subsystem's keys, or with no name every subsystem's."""
        return self._call("GET", f"config/{subsys}" if subsys else "config")

    def set_config_kv(self, subsys: str, key: str, value: str) -> None:
        self._call("PUT", f"config/{subsys}/{key}", body=value.encode())

    def heal(self, bucket: str, prefix: str = "", deep: bool = False,
             remove: bool = False) -> dict:
        q = []
        if deep:
            q.append("scan=deep")
        if remove:
            q.append("remove=true")
        route = f"heal/{bucket}" + (f"/{prefix}" if prefix else "")
        return self._call("POST", route, "&".join(q))

    def heal_status(self) -> dict:
        return self._call("GET", "heal-status")

    def service_stop(self) -> dict:
        return self._call("POST", "service", "action=stop")

    def service_restart(self) -> dict:
        return self._call("POST", "service", "action=restart")

    def metrics(self) -> str:
        """The Prometheus scrape (unsigned, as a scraper sends it)."""
        r = self._c.request("GET", "/minio-tpu/metrics", sign=False)
        return r.body.decode()

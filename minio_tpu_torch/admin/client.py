"""Admin client (``minio_tpu/admin/client.py``, the pkg/madmin role): the
routes of ``admin/handlers.py`` over the S3 client's SigV4 transport, and
the metrics scrape.

    adm = AdminClient("http://127.0.0.1:9000", "minioadmin", "minioadmin")
    adm.set_config_kv("pipeline", "depth", "0")
    adm.heal("bucket")
    adm.add_policy("alpha-rw", {"Statement": [...]})
    adm.add_user("u1", "u1-secret", ["alpha-rw"])
    adm.set_bucket_quota("bucket", 1 << 30)
    usage = adm.data_usage_info()
    adm.pool_add(dirs, 1, 16, parity=4)       # a pools layer only
    adm.set_remote_target("src", {"arn": arn, "endpoint": url,
                                  "target_bucket": "dst", ...})
    text = adm.metrics()
"""

from __future__ import annotations

import json
from typing import Any, Optional

from ..s3.client import S3Client, S3ClientError

__all__ = ["AdminClient", "AdminError"]


class AdminError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class AdminClient:
    PREFIX = "/minio-tpu/admin/v1"

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", ca_file: str | None = None):
        self._c = S3Client(endpoint, access_key, secret_key, region,
                           ca_file=ca_file)

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

    # -- identities ----------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: Optional[list[str]] = None) -> None:
        self._call("POST", "add-user", body=json.dumps(
            {"accessKey": access_key, "secretKey": secret_key,
             "policies": policies or []}).encode())

    def remove_user(self, access_key: str) -> None:
        self._call("POST", "remove-user", f"accessKey={access_key}")

    def list_users(self) -> dict:
        return self._call("GET", "list-users")

    def set_user_status(self, access_key: str, enabled: bool) -> None:
        self._call("POST", "set-user-status",
                   f"accessKey={access_key}&status="
                   f"{'enabled' if enabled else 'disabled'}")

    def set_user_policy(self, access_key: str, policies: list[str]) -> None:
        self._call("POST", "set-user-policy",
                   f"accessKey={access_key}&policies={','.join(policies)}")

    def add_service_account(self, parent: str,
                            access_key: Optional[str] = None,
                            secret_key: Optional[str] = None) -> dict:
        doc = {"parent": parent}
        if access_key:
            doc["accessKey"] = access_key
        if secret_key:
            doc["secretKey"] = secret_key
        return self._call("POST", "add-service-account",
                          body=json.dumps(doc).encode())

    def list_service_accounts(self, parent: Optional[str] = None) -> dict:
        return self._call("GET", "list-service-accounts",
                          f"parent={parent}" if parent else "")

    def delete_service_account(self, access_key: str) -> None:
        self._call("POST", "delete-service-account", f"accessKey={access_key}")

    def list_groups(self) -> dict:
        return self._call("GET", "list-groups")

    def add_user_to_group(self, access_key: str, group: str) -> None:
        self._call("POST", "add-user-to-group",
                   f"accessKey={access_key}&group={group}")

    def set_group_policy(self, group: str, policies: list[str]) -> None:
        self._call("POST", "set-group-policy", body=json.dumps(
            {"group": group, "policies": policies}).encode())

    # -- policies ------------------------------------------------------------

    def list_policies(self) -> Any:
        return self._call("GET", "policy")

    def get_policy(self, name: str) -> dict:
        return self._call("GET", f"policy/{name}")

    def add_policy(self, name: str, policy_doc: dict) -> None:
        self._call("PUT", f"policy/{name}",
                   body=json.dumps(policy_doc).encode())

    def remove_policy(self, name: str) -> None:
        self._call("DELETE", f"policy/{name}")

    # -- heal --------------------------------------------------------------

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

    # -- usage and quotas ------------------------------------------------------

    def data_usage_info(self) -> dict:
        """The crawler's last persisted usage (AdminError 404 before the
        first cycle)."""
        return self._call("GET", "datausageinfo")

    def get_bucket_quota(self, bucket: str) -> dict:
        return self._call("GET", "get-bucket-quota", f"bucket={bucket}")

    def set_bucket_quota(self, bucket: str, quota: int,
                         quota_type: str = "hard") -> None:
        self._call("POST", "set-bucket-quota", f"bucket={bucket}",
                   json.dumps({"quota": quota,
                               "quotatype": quota_type}).encode())

    def clear_bucket_quota(self, bucket: str) -> None:
        self._call("POST", "clear-bucket-quota", f"bucket={bucket}")

    # -- server pools --------------------------------------------------------

    def pool_status(self) -> dict:
        """Each pool's index, id, status, geometry and free bytes, with
        the crawler's usage once a cycle ran."""
        return self._call("GET", "pool-status")

    def pool_add(self, dirs: list[str], set_count: int,
                 set_drive_count: int, **kwargs) -> dict:
        """Attach a pool (``kwargs``: parity, block_size, ...); the
        manifest keeps it across restarts."""
        doc = {"dirs": dirs, "setCount": set_count,
               "setDriveCount": set_drive_count}
        if kwargs:
            doc["kwargs"] = kwargs
        return self._call("POST", "pool-add", body=json.dumps(doc).encode())

    def pool_decommission(self, pool) -> dict:
        """Drain a pool (index or id): new names go elsewhere and the
        rebalancer moves everything off."""
        return self._call("POST", "pool-decommission", f"pool={pool}")

    def pool_decommission_abort(self, pool) -> dict:
        return self._call("POST", "pool-decommission-abort", f"pool={pool}")

    def rebalance_status(self) -> dict | None:
        """The rebalancer's state: enabled, draining pools, bandwidth,
        counters, cycle progress."""
        return self._call("GET", "rebalance-status")

    # -- bucket replication --------------------------------------------------

    def set_remote_target(self, source_bucket: str, target: dict) -> None:
        """The bucket's replication target (madmin SetRemoteTarget):
        ``target`` holds ``arn``, ``endpoint``, ``target_bucket``,
        ``access_key``, ``secret_key`` and ``region``."""
        self._call("POST", "set-remote-target", body=json.dumps(
            {"sourceBucket": source_bucket, **target}).encode())

    def list_remote_targets(self) -> dict:
        return self._call("GET", "list-remote-targets")

    def remove_remote_target(self, bucket: str) -> None:
        """Detach the bucket's target (madmin RemoveRemoteTarget); its
        queued tasks send nothing, and their versions stay PENDING."""
        self._call("POST", "remove-remote-target", f"bucket={bucket}")

    def replication_stats(self) -> dict:
        return self._call("GET", "replication-stats")

    def bandwidth(self) -> dict:
        """Per bucket: the replication limit and the bytes moved."""
        return self._call("GET", "bandwidth")

    def set_bandwidth_limit(self, bucket: str, limit: int) -> None:
        """Bytes/s for the bucket's replication; 0 lifts the limit."""
        self._call("POST", "set-bandwidth-limit",
                   f"bucket={bucket}&limit={limit}")

    def kms_key_status(self) -> dict:
        return self._call("GET", "kms-key-status")

    def list_tiers(self) -> list[dict]:
        """The remote tiers, credentials redacted."""
        return self._call("GET", "tier")

    def add_tier(self, config: dict) -> None:
        """Add a remote tier: ``{"type": "dir", "name", "path"}`` or
        ``{"type": "s3", "name", "endpoint", "bucket", "access_key",
        "secret_key"}``."""
        self._call("PUT", "tier", body=json.dumps(config).encode())

    def service_stop(self) -> dict:
        return self._call("POST", "service", "action=stop")

    def service_restart(self) -> dict:
        return self._call("POST", "service", "action=restart")

    def metrics(self) -> str:
        """The Prometheus scrape (unsigned, as a scraper sends it)."""
        r = self._c.request("GET", "/minio-tpu/metrics", sign=False)
        return r.body.decode()

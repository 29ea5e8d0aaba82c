"""The bucket quota (``minio_tpu/bucket/quota.py``, cmd/bucket-quota.go,
madmin BucketQuota).

The JSON document ``{"quota": bytes, "quotatype": "hard" | "fifo"}``.  A
hard quota refuses a write that would take the bucket past the limit,
against the crawler's usage plus what was written since
(``background/crawler.py`` ``UsageCache``); a fifo quota is stored and
not enforced, as in the reference.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


class QuotaError(ValueError):
    pass


HARD = "hard"
FIFO = "fifo"


@dataclass
class Quota:
    quota: int = 0
    quota_type: str = HARD

    @classmethod
    def parse(cls, data: bytes) -> "Quota":
        try:
            doc = json.loads(data)
        except json.JSONDecodeError as e:
            raise QuotaError("malformed quota JSON") from e
        q = int(doc.get("quota", 0))
        qt = doc.get("quotatype", HARD)
        if qt not in (HARD, FIFO):
            raise QuotaError(f"invalid quotatype {qt!r}")
        if q < 0:
            raise QuotaError("quota must be non-negative")
        return cls(quota=q, quota_type=qt)

    def to_json(self) -> bytes:
        return json.dumps(
            {"quota": self.quota, "quotatype": self.quota_type}).encode()

    def allows(self, current_usage: int, incoming: int) -> bool:
        """Hard-quota admission check (cmd/bucket-quota.go
        enforceBucketQuota)."""
        if self.quota <= 0 or self.quota_type != HARD:
            return True
        return current_usage + incoming <= self.quota

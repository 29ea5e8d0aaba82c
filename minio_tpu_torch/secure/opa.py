"""The external policy webhook, OPA's shape (``minio_tpu/secure/opa.py``,
cmd/config/policy/opa/config.go).

When the ``policy_opa`` subsystem names a ``url``, ``IAMSys.is_allowed``
asks the webhook instead of the local policy documents: the root
credential bypasses it, and authentication stays local.  The request is
a POST of ``{"input": <auth_args>}``; the decision is the answer's
``result`` (or its ``result.allow``, or a bare boolean body).  Every
failure denies: a timeout, a refused connection, a non-2xx status, an
answer that does not decode.  Each attempt waits at most ``timeout``,
and failures are retried ``retry_attempts`` times in all under the
jittered backoff of ``utils/retry.py``.  Each decision counts into
``mt_policy_webhook_total{verdict="allow"|"deny"|"error"}``.
"""

from __future__ import annotations

import json
import urllib.request

from ..utils.kvconfig import parse_duration
from ..utils.retry import RetryPolicy


class OpaWebhook:
    """One authorizer endpoint; without state of its own, so a reload
    swaps the instance."""

    def __init__(self, url: str, auth_token: str = "",
                 timeout_s: float = 2.0, attempts: int = 2,
                 opener=urllib.request.urlopen):
        self.url = url
        self.auth_token = auth_token
        self.timeout_s = max(0.05, float(timeout_s))
        self.retry = RetryPolicy(attempts=attempts, base_s=0.05, cap_s=0.5)
        self._opener = opener

    @classmethod
    def from_config(cls, cfg) -> "OpaWebhook | None":
        """None only when no ``url`` is set.  With one, a bad value of
        another key takes its default: falling back to local policy on a
        typo would open what the webhook closes."""
        try:
            url = (cfg.get("policy_opa", "url") or "").strip()
        except KeyError:
            return None
        if not url:
            return None

        def knob(key, default):
            try:
                return cfg.get("policy_opa", key)
            except KeyError:
                return default

        try:
            attempts = max(1, int(knob("retry_attempts", "2")))
        except ValueError:
            attempts = 2
        return cls(url, auth_token=knob("auth_token", "") or "",
                   timeout_s=parse_duration(knob("timeout", "2s"), 2.0),
                   attempts=attempts)

    def _ask(self, body: bytes) -> bool:
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(self.url, data=body, headers=headers)
        with self._opener(req, timeout=self.timeout_s) as resp:
            doc = json.loads(resp.read() or b"false")
        if isinstance(doc, dict):
            result = doc.get("result", False)
            if isinstance(result, dict):
                result = result.get("allow", False)
            return bool(result)
        return bool(doc)

    def is_allowed(self, args: dict) -> bool:
        """One decision; every failure, once the retries are spent,
        denies."""
        from ..admin.metrics import GLOBAL as mtr
        body = json.dumps({"input": args}).encode()
        attempt = 0
        while True:
            try:
                verdict = self._ask(body)
            except Exception:  # noqa: BLE001 — every failure denies alike
                if self.retry.may_retry(attempt, idempotent=True):
                    self.retry.wait(attempt)
                    attempt += 1
                    continue
                mtr.inc("mt_policy_webhook_total", {"verdict": "error"})
                return False
            self.retry.on_success()
            mtr.inc("mt_policy_webhook_total",
                    {"verdict": "allow" if verdict else "deny"})
            return verdict


def auth_args(access_key: str, action: str, resource: str,
              context: dict | None, owner: bool) -> dict:
    """The PolicyArgs document the reference posts (opa/config.go
    IsAllowed): who, what, on which bucket and object, under which
    request conditions."""
    bucket = resource.split("/", 1)[0] if resource else ""
    return {
        "account": access_key,
        "action": action,
        "bucket": bucket,
        "object": resource[len(bucket) + 1:]
        if bucket and "/" in resource else "",
        "conditions": context or {},
        "owner": owner,
    }

"""STS: temporary credentials (``minio_tpu/iam/sts.py``,
cmd/sts-handlers.go AssumeRole).

``mint`` draws an access key (20 characters) and a secret (40) and
signs a session token, an HS256 JWT under the root secret that carries
the temporary key, its parent and its expiry.  A request made with
temporary credentials sends the token in ``x-amz-security-token`` (or
``X-Amz-Security-Token`` in the query); ``verify_token`` checks it.  The
session policy is kept by IAMSys, not in the token.  The keys come from
``secrets``, so from ``os.urandom``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import secrets as pysecrets
from dataclasses import dataclass

MIN_DURATION_S = 900                  # AWS bounds (sts-handlers.go)
MAX_DURATION_S = 7 * 24 * 3600
DEFAULT_DURATION_S = 3600


class STSError(Exception):
    def __init__(self, code: str, msg: str = ""):
        super().__init__(msg or code)
        self.code = code


@dataclass
class TempCredentials:
    access_key: str
    secret_key: str
    session_token: str
    expiration: int                    # unix seconds
    parent_user: str


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def sign_token(claims: dict, secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    mac = hmac.new(secret.encode(), f"{header}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url(mac)}"


def verify_token(token: str, secret: str) -> dict:
    try:
        header, body, sig = token.split(".")
    except ValueError as e:
        raise STSError("InvalidToken", "malformed session token") from e
    mac = hmac.new(secret.encode(), f"{header}.{body}".encode(),
                   hashlib.sha256).digest()
    if not hmac.compare_digest(_b64url(mac), sig):
        raise STSError("InvalidToken", "bad token signature")
    claims = json.loads(_b64url_dec(body))
    if claims.get("exp", 0) < time.time():
        raise STSError("ExpiredToken")
    return claims


def mint(parent_access_key: str, root_secret: str,
         duration_s: int = DEFAULT_DURATION_S,
         extra_claims: dict | None = None) -> TempCredentials:
    """The credential triple (cmd/auth-handler.go GetNewCredentials):
    access keys of 20 characters, secrets of 40.  ``extra_claims`` are an
    identity provider's own token claims (the LDAP path's ``ldapUser`` and
    ``ldapUsername``, cmd/sts-handlers.go:502)."""
    if not MIN_DURATION_S <= duration_s <= MAX_DURATION_S:
        raise STSError("InvalidParameterValue",
                       f"DurationSeconds must be in "
                       f"[{MIN_DURATION_S}, {MAX_DURATION_S}]")
    ak = "STS" + pysecrets.token_hex(9).upper()[:17]
    sk = pysecrets.token_urlsafe(30)[:40]
    exp = int(time.time()) + duration_s
    claims = {"accessKey": ak, "parent": parent_access_key, "exp": exp,
              **(extra_claims or {})}
    token = sign_token(claims, root_secret)
    return TempCredentials(ak, sk, token, exp, parent_access_key)

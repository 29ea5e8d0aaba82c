"""AWS Signature Version 2: verification and signing
(``minio_tpu/s3/sigv2.py``, cmd/signature-v2.go doesSignV2Match and
doesPresignV2SignatureMatch).

V2 signs, with HMAC-SHA1, the newline-joined string

    Method\nContent-MD5\nContent-Type\nDate\nCanonicalizedAmzHeaders
    CanonicalizedResource

whose resource is the path and, sorted, the subresources of a fixed
list (cmd/signature-v2.go resourceList).  A presigned URL carries
AWSAccessKeyId, Expires and Signature in its query, and Expires takes
the Date line's place.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse

from .sigv4 import SigV4Error as SigError

# cmd/signature-v2.go:66 resourceList — subresources included in the
# canonical resource, in sorted order
RESOURCE_LIST = [
    "accelerate", "acl", "cors", "delete", "encryption", "legal-hold",
    "lifecycle", "location", "logging", "notification", "partNumber",
    "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "retention", "select", "select-type", "tagging", "torrent", "uploadId",
    "uploads", "versionId", "versioning", "versions", "website",
]


def canonicalized_amz_headers(headers: dict[str, str]) -> str:
    amz: dict[str, list[str]] = {}
    for k, v in headers.items():
        lk = k.lower().strip()
        if lk.startswith("x-amz-"):
            amz.setdefault(lk, []).append(v.strip())
    return "".join(f"{k}:{','.join(amz[k])}\n" for k in sorted(amz))


def canonicalized_resource(path: str, query: dict[str, list[str]]) -> str:
    out = path or "/"
    sub = []
    for k in sorted(query):
        if k in RESOURCE_LIST:
            v = query[k][0]
            sub.append(f"{k}={v}" if v else k)
    if sub:
        out += "?" + "&".join(sub)
    return out


def string_to_sign(method: str, path: str, query: dict[str, list[str]],
                   headers: dict[str, str], date_line: str) -> str:
    h = {k.lower(): v for k, v in headers.items()}
    return "\n".join([
        method.upper(),
        h.get("content-md5", ""),
        h.get("content-type", ""),
        date_line,
    ]) + "\n" + canonicalized_amz_headers(headers) \
        + canonicalized_resource(path, query)


def _signature(secret: str, sts: str) -> str:
    return base64.b64encode(
        hmac.new(secret.encode(), sts.encode(), hashlib.sha1)
        .digest()).decode()


def sign_header(access_key: str, secret_key: str, method: str, path: str,
                query: dict[str, list[str]],
                headers: dict[str, str]) -> str:
    """Returns the Authorization header value ``AWS AK:Signature``."""
    h = {k.lower(): v for k, v in headers.items()}
    date_line = "" if "x-amz-date" in h else h.get("date", "")
    sts = string_to_sign(method, path, query, headers, date_line)
    return f"AWS {access_key}:{_signature(secret_key, sts)}"


def presign(access_key: str, secret_key: str, method: str, path: str,
            expires_epoch: int,
            query: dict[str, list[str]] | None = None) -> str:
    """Returns the query string for a presigned V2 URL."""
    q = dict(query or {})
    sts = string_to_sign(method, path, q, {}, str(expires_epoch))
    q2 = {
        "AWSAccessKeyId": [access_key],
        "Expires": [str(expires_epoch)],
        "Signature": [_signature(secret_key, sts)],
    }
    q.update(q2)
    return urllib.parse.urlencode({k: v[0] for k, v in q.items()})


def verify_request(lookup_secret, method: str, path: str,
                   query: dict[str, list[str]],
                   headers: dict[str, str]) -> str:
    """Header-auth V2 (doesSignV2Match); returns the access key."""
    h = {k.lower(): v for k, v in headers.items()}
    auth = h.get("authorization", "")
    if not auth.startswith("AWS ") or ":" not in auth:
        raise SigError("AccessDenied", "malformed V2 Authorization")
    access_key, _, got_sig = auth[4:].strip().partition(":")
    secret = lookup_secret(access_key)
    if secret is None:
        raise SigError("InvalidAccessKeyId", "no such key")
    date_line = "" if "x-amz-date" in h else h.get("date", "")
    if not date_line and "x-amz-date" not in h:
        raise SigError("AccessDenied", "missing Date header")
    sts = string_to_sign(method, path, query, headers, date_line)
    want = _signature(secret, sts)
    if not hmac.compare_digest(want, got_sig):
        raise SigError("SignatureDoesNotMatch", "V2 signature mismatch")
    return access_key


def verify_presigned(lookup_secret, method: str, path: str,
                     query: dict[str, list[str]],
                     headers: dict[str, str] | None = None,
                     now: float | None = None) -> str:
    """Presigned V2 (doesPresignV2SignatureMatch); returns the access
    key.  ``headers`` participate in the string-to-sign (SDKs sign
    Content-Type / x-amz-* into presigned V2 URLs)."""
    try:
        access_key = query["AWSAccessKeyId"][0]
        expires = int(query["Expires"][0])
        got_sig = query["Signature"][0]
    except (KeyError, IndexError, ValueError) as e:
        raise SigError("AccessDenied", "malformed presigned V2 query") \
            from e
    if (now if now is not None else time.time()) > expires:
        raise SigError("AccessDenied", "request has expired")
    secret = lookup_secret(access_key)
    if secret is None:
        raise SigError("InvalidAccessKeyId", "no such key")
    rest = {k: v for k, v in query.items()
            if k not in ("AWSAccessKeyId", "Expires", "Signature")}
    sts = string_to_sign(method, path, rest, headers or {}, str(expires))
    want = _signature(secret, sts)
    if not hmac.compare_digest(want, got_sig):
        raise SigError("SignatureDoesNotMatch", "V2 signature mismatch")
    return access_key

"""Browser POST uploads: the form, its policy and its signature
(``minio_tpu/s3/postpolicy.py``; cmd/postpolicyform.go,
cmd/object-handlers.go PostPolicyBucketHandler).

The body is multipart/form-data: a base64 policy document, its
signature (V4 over the policy with the SigV4 signing key, or V2 as
HMAC-SHA1), the object's key and fields, and its bytes in the ``file``
field.  The policy holds an expiration and conditions that the fields
and the file's size must meet.
"""

from __future__ import annotations

import base64
import datetime
import email.parser
import hashlib
import hmac
import json
from typing import Tuple

from . import sigv4
from .sigv4 import SigV4Error as SigError


def parse_form(body: bytes, content_type: str
               ) -> Tuple[dict[str, str], bytes, str]:
    """Parse multipart/form-data; returns (fields, file_bytes, filename).
    Field names are lower-cased (the reference canonicalizes likewise)."""
    msg = email.parser.BytesParser().parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise SigError("MalformedPOSTRequest", "not multipart/form-data")
    fields: dict[str, str] = {}
    file_data = b""
    filename = ""
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        if name == "file":
            file_data = payload
            filename = part.get_param(
                "filename", header="content-disposition") or ""
        else:
            fields[name.lower()] = payload.decode("utf-8", "replace")
    return fields, file_data, filename


def _parse_expiration(policy: dict) -> float:
    exp = policy.get("expiration")
    if not exp:
        raise SigError("AccessDenied", "policy missing expiration")
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.datetime.strptime(exp, fmt).replace(
                tzinfo=datetime.timezone.utc).timestamp()
        except ValueError:
            continue
    raise SigError("AccessDenied", "malformed policy expiration")


def check_policy(policy_b64: str, fields: dict[str, str],
                 file_size: int, now: float | None = None) -> None:
    """checkPostPolicy (cmd/postpolicyform.go:178): every condition in the
    policy must hold against the submitted form fields."""
    import time as _time
    try:
        policy = json.loads(base64.b64decode(policy_b64))
    except (ValueError, json.JSONDecodeError) as e:
        raise SigError("MalformedPOSTRequest", "bad policy document") from e
    if not isinstance(policy, dict):
        raise SigError("MalformedPOSTRequest", "policy must be an object")
    if (now if now is not None else _time.time()) > \
            _parse_expiration(policy):
        raise SigError("AccessDenied", "policy document has expired")
    conditions = policy.get("conditions", [])
    if not isinstance(conditions, list):
        raise SigError("MalformedPOSTRequest", "conditions must be a list")
    for cond in conditions:
        if isinstance(cond, dict):
            for k, v in cond.items():
                got = fields.get(k.lower(), "")
                if got != str(v):
                    raise SigError(
                        "AccessDenied",
                        f"policy condition failed: eq ${k}")
        elif isinstance(cond, list) and len(cond) == 3:
            op, target, value = cond
            op = str(op).lower()
            if op == "content-length-range":
                try:
                    lo, hi = int(target), int(value)
                except (TypeError, ValueError) as e:
                    raise SigError("MalformedPOSTRequest",
                                   "bad content-length-range bounds") \
                        from e
                if not (lo <= file_size <= hi):
                    raise SigError(
                        "EntityTooLarge" if file_size > hi
                        else "EntityTooSmall",
                        "content-length-range violated")
                continue
            key = str(target).lstrip("$").lower()
            got = fields.get(key, "")
            if op == "eq":
                ok = got == str(value)
            elif op == "starts-with":
                ok = got.startswith(str(value))
            else:
                raise SigError("AccessDenied",
                               f"unknown policy operator {op}")
            if not ok:
                raise SigError("AccessDenied",
                               f"policy condition failed: {op} ${key}")
        else:
            raise SigError("MalformedPOSTRequest", "bad policy condition")


def verify_signature(lookup_secret, fields: dict[str, str],
                     region: str) -> str:
    """Policy signature check; returns the authenticated access key.
    V4: signature over the base64 policy with the SigV4 signing key.
    V2: base64 HMAC-SHA1 of the policy (doesPolicySignatureV2Match)."""
    policy = fields.get("policy", "")
    if not policy:
        raise SigError("AccessDenied", "missing policy field")
    if fields.get("x-amz-algorithm", "") == sigv4.ALGORITHM:
        cred = fields.get("x-amz-credential", "")
        amz_date = fields.get("x-amz-date", "")
        got = fields.get("x-amz-signature", "")
        parts = cred.split("/")
        if len(parts) != 5:
            raise SigError("AccessDenied", "malformed credential")
        access_key, date, cred_region, service, term = parts
        if service != "s3" or term != "aws4_request" or \
                cred_region != region:
            raise SigError("AccessDenied", "bad credential scope")
        if not amz_date.startswith(date):
            raise SigError("AccessDenied", "credential date mismatch")
        secret = lookup_secret(access_key)
        if secret is None:
            raise SigError("InvalidAccessKeyId", "no such key")
        key = sigv4.signing_key(secret, date, region, "s3")
        want = hmac.new(key, policy.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got):
            raise SigError("SignatureDoesNotMatch",
                           "policy signature mismatch")
        return access_key
    if "awsaccesskeyid" in fields:
        access_key = fields["awsaccesskeyid"]
        got = fields.get("signature", "")
        secret = lookup_secret(access_key)
        if secret is None:
            raise SigError("InvalidAccessKeyId", "no such key")
        want = base64.b64encode(hmac.new(
            secret.encode(), policy.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(want, got):
            raise SigError("SignatureDoesNotMatch",
                           "policy signature mismatch")
        return access_key
    raise SigError("AccessDenied", "no policy signature present")


def sign_policy_v4(access_key: str, secret_key: str, policy_doc: dict,
                   region: str, now: datetime.datetime | None = None
                   ) -> dict[str, str]:
    """Client-side helper: produce the form fields for a V4 POST upload
    (the shape browsers get from presignedPostPolicy SDK calls)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    date = now.strftime("%Y%m%d")
    amz_date = now.strftime(sigv4.ISO8601)
    cred = f"{access_key}/{date}/{region}/s3/aws4_request"
    doc = dict(policy_doc)
    doc.setdefault("conditions", [])
    doc["conditions"] = list(doc["conditions"]) + [
        {"x-amz-algorithm": sigv4.ALGORITHM},
        {"x-amz-credential": cred},
        {"x-amz-date": amz_date},
    ]
    policy_b64 = base64.b64encode(
        json.dumps(doc).encode()).decode()
    key = sigv4.signing_key(secret_key, date, region, "s3")
    sig = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    return {
        "policy": policy_b64,
        "x-amz-algorithm": sigv4.ALGORITHM,
        "x-amz-credential": cred,
        "x-amz-date": amz_date,
        "x-amz-signature": sig,
    }

"""AWS Signature Version 4, signer and verifier (``minio_tpu/s3/sigv4.py``).

Server side: header-signed requests (cmd/signature-v4.go:331
doesSignatureMatch), presigned URLs (:205 doesPresignedSignatureMatch)
and aws-chunked bodies whose every chunk is signed
(cmd/streaming-signature-v4.go).  Client side: the signer the port's
``S3Client`` uses.  Both share one canonicalization.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
ISO8601 = "%Y%m%dT%H%M%SZ"

# default presign expiry limit (7 days, AWS parity)
MAX_PRESIGN_EXPIRES = 7 * 24 * 3600


class SigV4Error(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: dict[str, list[str]],
                    drop: set[str] = frozenset()) -> str:
    pairs = []
    for key in sorted(query):
        if key in drop:
            continue
        for v in sorted(query[key]):
            pairs.append(f"{_uri_encode(key)}={_uri_encode(v)}")
    return "&".join(pairs)


def canonical_request(method: str, path: str, query: dict[str, list[str]],
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str,
                      drop_query: set[str] = frozenset()) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method.upper(),
        _uri_encode(path, encode_slash=False) or "/",
        canonical_query(query, drop_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(f"AWS4{secret}".encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def string_to_sign(timestamp: str, scope: str, canonical: str) -> str:
    return "\n".join([
        ALGORITHM, timestamp, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])


@dataclass
class Credentials:
    access_key: str
    secret_key: str


# ---------------------------------------------------------------------------
# client-side signer
# ---------------------------------------------------------------------------

def sign_request(creds: Credentials, method: str, url: str,
                 headers: dict[str, str], payload: bytes = b"",
                 region: str = "us-east-1", service: str = "s3",
                 timestamp: datetime.datetime | None = None
                 ) -> dict[str, str]:
    """Sign; returns the full header set to send (signed-payload mode)."""
    u = urllib.parse.urlsplit(url)
    # the wire path may be %-encoded; canonicalize from the DECODED path
    # (matching the server, which unquotes before re-encoding)
    path = urllib.parse.unquote(u.path)
    query = urllib.parse.parse_qs(u.query, keep_blank_values=True)
    ts = timestamp or datetime.datetime.now(datetime.timezone.utc)
    amz_date = ts.strftime(ISO8601)
    date = amz_date[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    out = dict(headers)
    out["host"] = u.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    signed = sorted(h.lower() for h in out)
    scope = f"{date}/{region}/{service}/aws4_request"
    canon = canonical_request(method, path or "/", query,
                              {k.lower(): v for k, v in out.items()},
                              signed, payload_hash)
    sts = string_to_sign(amz_date, scope, canon)
    sig = hmac.new(signing_key(creds.secret_key, date, region, service),
                   sts.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"{ALGORITHM} Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out


def sign_request_streaming(creds: Credentials, method: str, url: str,
                           headers: dict[str, str], payload: bytes,
                           chunk_size: int = 64 * 1024,
                           region: str = "us-east-1",
                           timestamp: datetime.datetime | None = None
                           ) -> tuple[dict[str, str], bytes]:
    """Client-side aws-chunked upload: returns (headers, framed_body).
    Mirrors what aws SDKs send for STREAMING-AWS4-HMAC-SHA256-PAYLOAD."""
    u = urllib.parse.urlsplit(url)
    upath = urllib.parse.unquote(u.path)
    query = urllib.parse.parse_qs(u.query, keep_blank_values=True)
    ts = timestamp or datetime.datetime.now(datetime.timezone.utc)
    amz_date = ts.strftime(ISO8601)
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    out = dict(headers)
    out["host"] = u.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = STREAMING_PAYLOAD
    out["content-encoding"] = "aws-chunked"
    out["x-amz-decoded-content-length"] = str(len(payload))
    signed = sorted(h.lower() for h in out)
    canon = canonical_request(method, upath or "/", query,
                              {k.lower(): v for k, v in out.items()},
                              signed, STREAMING_PAYLOAD)
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(creds.secret_key, date, region, "s3")
    seed = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"{ALGORITHM} Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={seed}")
    body = bytearray()
    prev = seed
    chunks = [payload[i:i + chunk_size]
              for i in range(0, len(payload), chunk_size)] + [b""]
    for chunk in chunks:
        csts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
            EMPTY_SHA256, hashlib.sha256(chunk).hexdigest()])
        sig = hmac.new(key, csts.encode(), hashlib.sha256).hexdigest()
        body += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        body += chunk + b"\r\n"
        prev = sig
    return out, bytes(body)


def presign_url(creds: Credentials, method: str, url: str,
                expires: int = 3600, region: str = "us-east-1",
                timestamp: datetime.datetime | None = None) -> str:
    """Generate a presigned URL (query-string auth)."""
    u = urllib.parse.urlsplit(url)
    path = urllib.parse.unquote(u.path)
    query = urllib.parse.parse_qs(u.query, keep_blank_values=True)
    ts = timestamp or datetime.datetime.now(datetime.timezone.utc)
    amz_date = ts.strftime(ISO8601)
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    query.update({
        "X-Amz-Algorithm": [ALGORITHM],
        "X-Amz-Credential": [f"{creds.access_key}/{scope}"],
        "X-Amz-Date": [amz_date],
        "X-Amz-Expires": [str(expires)],
        "X-Amz-SignedHeaders": ["host"],
    })
    canon = canonical_request(method, path or "/", query,
                              {"host": u.netloc}, ["host"],
                              UNSIGNED_PAYLOAD)
    sts = string_to_sign(amz_date, scope, canon)
    sig = hmac.new(signing_key(creds.secret_key, date, region, "s3"),
                   sts.encode(), hashlib.sha256).hexdigest()
    query["X-Amz-Signature"] = [sig]
    qs = urllib.parse.urlencode({k: v[0] for k, v in query.items()})
    return urllib.parse.urlunsplit(
        (u.scheme, u.netloc, u.path, qs, ""))


# ---------------------------------------------------------------------------
# server-side verifier
# ---------------------------------------------------------------------------

def _parse_auth_header(auth: str) -> tuple[str, str, list[str], str]:
    """-> (access_key, scope, signed_headers, signature)."""
    if not auth.startswith(ALGORITHM):
        raise SigV4Error("AccessDenied", "unsupported algorithm")
    fields = {}
    for part in auth[len(ALGORITHM):].strip().split(","):
        if "=" not in part:
            raise SigV4Error("AuthorizationHeaderMalformed", part)
        k, v = part.strip().split("=", 1)
        fields[k] = v
    try:
        cred = fields["Credential"]
        signed = fields["SignedHeaders"].split(";")
        sig = fields["Signature"]
    except KeyError as e:
        raise SigV4Error("AuthorizationHeaderMalformed", str(e)) from e
    if "/" not in cred:
        raise SigV4Error("AuthorizationHeaderMalformed", cred)
    access_key, scope = cred.split("/", 1)
    return access_key, scope, signed, sig


def verify_request(lookup_secret, method: str, path: str,
                   query: dict[str, list[str]], headers: dict[str, str],
                   payload_hash: str,
                   region: str = "us-east-1",
                   now: datetime.datetime | None = None) -> str:
    """Verify a header-signed request; returns the access key.

    ``lookup_secret(access_key) -> secret | None``.
    Mirrors doesSignatureMatch (cmd/signature-v4.go:331).
    """
    headers = {k.lower(): v for k, v in headers.items()}
    auth = headers.get("authorization", "")
    if not auth:
        raise SigV4Error("AccessDenied", "missing Authorization")
    access_key, scope, signed, got_sig = _parse_auth_header(auth)
    parts = scope.split("/")
    if len(parts) != 4 or parts[3] != "aws4_request" or parts[2] != "s3":
        raise SigV4Error("AuthorizationHeaderMalformed", scope)
    date, req_region = parts[0], parts[1]
    if req_region != region:
        raise SigV4Error("AuthorizationHeaderMalformed",
                         f"wrong region {req_region}")
    secret = lookup_secret(access_key)
    if secret is None:
        raise SigV4Error("InvalidAccessKeyId", access_key)
    amz_date = headers.get("x-amz-date") or headers.get("date", "")
    if not amz_date:
        raise SigV4Error("AccessDenied", "missing date")
    # clock skew check (15 min, AWS parity)
    try:
        req_time = datetime.datetime.strptime(amz_date, ISO8601).replace(
            tzinfo=datetime.timezone.utc)
    except ValueError as e:
        raise SigV4Error("AccessDenied", "malformed date") from e
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if abs((now - req_time).total_seconds()) > 15 * 60:
        raise SigV4Error("RequestTimeTooSkewed", amz_date)
    if "host" not in signed:
        raise SigV4Error("AccessDenied", "host header not signed")
    canon = canonical_request(method, path, query, headers, signed,
                              payload_hash)
    sts = string_to_sign(amz_date, scope, canon)
    want = hmac.new(signing_key(secret, date, region, "s3"),
                    sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise SigV4Error("SignatureDoesNotMatch", "signature mismatch")
    return access_key


def verify_request_streaming(lookup_secret, method: str, path: str,
                             query: dict[str, list[str]],
                             headers: dict[str, str],
                             region: str = "us-east-1",
                             now: datetime.datetime | None = None
                             ) -> tuple[str, bytes, str, str, str]:
    """Verify the seed request of an aws-chunked upload; returns
    (access_key, signing_key, seed_signature, amz_date, scope) for the
    per-chunk chain (cmd/streaming-signature-v4.go:40)."""
    access_key = verify_request(lookup_secret, method, path, query, headers,
                                STREAMING_PAYLOAD, region, now)
    hl = {k.lower(): v for k, v in headers.items()}
    _, scope, _, seed_sig = _parse_auth_header(hl["authorization"])
    date = scope.split("/")[0]
    key = signing_key(lookup_secret(access_key), date, region, "s3")
    return access_key, key, seed_sig, hl.get("x-amz-date", ""), scope


def decode_chunked_payload(body: bytes, key: bytes, seed_signature: str,
                           amz_date: str, scope: str) -> bytes:
    """Decode and verify STREAMING-AWS4-HMAC-SHA256-PAYLOAD framing
    (cmd/streaming-signature-v4.go:156 newSignV4ChunkedReader).

    Each chunk: ``<hex-size>;chunk-signature=<sig>\\r\\n<data>\\r\\n``;
    chain: sig_n over (prev_sig, sha256(chunk_n)); final chunk size 0.
    """
    out = bytearray()
    prev = seed_signature
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise SigV4Error("IncompleteBody", "missing chunk header")
        header = body[pos:nl].decode("ascii", "replace")
        if ";chunk-signature=" not in header:
            raise SigV4Error("SignatureDoesNotMatch", "bad chunk header")
        size_hex, sig = header.split(";chunk-signature=", 1)
        try:
            size = int(size_hex, 16)
        except ValueError as e:
            raise SigV4Error("IncompleteBody", "bad chunk size") from e
        data = body[nl + 2: nl + 2 + size]
        if len(data) != size:
            raise SigV4Error("IncompleteBody", "short chunk")
        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
            EMPTY_SHA256, hashlib.sha256(data).hexdigest()])
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise SigV4Error("SignatureDoesNotMatch",
                             f"chunk signature mismatch at {pos}")
        prev = want
        pos = nl + 2 + size + 2  # skip trailing \r\n
        if size == 0:
            break
        out += data
    return bytes(out)


class ChunkedStreamReader:
    """Incremental STREAMING-AWS4-HMAC-SHA256-PAYLOAD decoder
    (cmd/streaming-signature-v4.go:156 newSignV4ChunkedReader): reads the
    framed body from ``raw`` (file-like with .readline/.read), verifies
    each chunk's signature chain, and exposes plain .read(n) so a 5 GiB
    aws-chunked PUT streams without buffering."""

    MAX_CHUNK_SIZE = 16 * 1024 * 1024   # maxChunkSize guard: one declared
    # chunk must never force a multi-GiB buffer before its signature check

    def __init__(self, raw, key: bytes, seed_signature: str,
                 amz_date: str, scope: str):
        self.raw = raw
        self.key = key
        self.prev = seed_signature
        self.amz_date = amz_date
        self.scope = scope
        self.buf = b""
        self.done = False

    def _next_chunk(self) -> bytes:
        line = self.raw.readline(8192)
        if not line.endswith(b"\r\n"):
            raise SigV4Error("IncompleteBody", "missing chunk header")
        header = line[:-2].decode("ascii", "replace")
        if ";chunk-signature=" not in header:
            raise SigV4Error("SignatureDoesNotMatch", "bad chunk header")
        size_hex, sig = header.split(";chunk-signature=", 1)
        try:
            size = int(size_hex, 16)
        except ValueError as e:
            raise SigV4Error("IncompleteBody", "bad chunk size") from e
        if size > self.MAX_CHUNK_SIZE:
            raise SigV4Error("InvalidRequest",
                             f"chunk size {size} exceeds maximum")
        chunks = []
        remaining = size
        while remaining > 0:
            c = self.raw.read(remaining)
            if not c:
                raise SigV4Error("IncompleteBody", "short chunk")
            chunks.append(c)
            remaining -= len(c)
        data = b"".join(chunks)
        if self.raw.read(2) != b"\r\n":
            raise SigV4Error("IncompleteBody", "missing chunk trailer")
        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", self.amz_date, self.scope,
            self.prev, EMPTY_SHA256, hashlib.sha256(data).hexdigest()])
        want = hmac.new(self.key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise SigV4Error("SignatureDoesNotMatch",
                             "chunk signature mismatch")
        self.prev = want
        if size == 0:
            self.done = True
        return data

    def read(self, n: int = -1) -> bytes:
        """Up to ``n`` bytes (all with n < 0), joined once: a large read
        of many chunks copies each byte once."""
        parts = [self.buf] if self.buf else []
        have = len(self.buf)
        while (n < 0 or have < n) and not self.done:
            chunk = self._next_chunk()
            parts.append(chunk)
            have += len(chunk)
        self.buf = b""
        if 0 <= n < have:                   # keep the tail of the last
            last = parts.pop()
            cut = len(last) - (have - n)
            parts.append(last[:cut])
            self.buf = last[cut:]
        return b"".join(parts)


def verify_presigned(lookup_secret, method: str, path: str,
                     query: dict[str, list[str]], headers: dict[str, str],
                     region: str = "us-east-1",
                     now: datetime.datetime | None = None) -> str:
    """Verify query-string (presigned) auth; returns the access key.
    Mirrors doesPresignedSignatureMatch (cmd/signature-v4.go:205)."""
    q1 = {k: v[0] for k, v in query.items()}
    try:
        if q1["X-Amz-Algorithm"] != ALGORITHM:
            raise SigV4Error("AccessDenied", "bad algorithm")
        cred = q1["X-Amz-Credential"]
        amz_date = q1["X-Amz-Date"]
        expires = int(q1["X-Amz-Expires"])
        signed = q1["X-Amz-SignedHeaders"].split(";")
        got_sig = q1["X-Amz-Signature"]
    except (KeyError, ValueError) as e:
        raise SigV4Error("AuthorizationQueryParametersError", str(e)) from e
    access_key, scope = cred.split("/", 1)
    date, req_region = scope.split("/")[0:2]
    if req_region != region:
        raise SigV4Error("AuthorizationQueryParametersError", req_region)
    if not 1 <= expires <= MAX_PRESIGN_EXPIRES:
        raise SigV4Error("AuthorizationQueryParametersError",
                         "invalid expires")
    secret = lookup_secret(access_key)
    if secret is None:
        raise SigV4Error("InvalidAccessKeyId", access_key)
    try:
        req_time = datetime.datetime.strptime(amz_date, ISO8601).replace(
            tzinfo=datetime.timezone.utc)
    except ValueError as e:
        raise SigV4Error("AuthorizationQueryParametersError",
                         "malformed X-Amz-Date") from e
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if now < req_time - datetime.timedelta(minutes=15):
        raise SigV4Error("RequestTimeTooSkewed", amz_date)
    if (now - req_time).total_seconds() > expires:
        raise SigV4Error("ExpiredToken", "request has expired")
    headers = {k.lower(): v for k, v in headers.items()}
    canon = canonical_request(method, path, query, headers, signed,
                              q1.get("X-Amz-Content-Sha256",
                                     UNSIGNED_PAYLOAD),
                              drop_query={"X-Amz-Signature"})
    sts = string_to_sign(amz_date, scope, canon)
    want = hmac.new(signing_key(secret, date, region, "s3"),
                    sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise SigV4Error("SignatureDoesNotMatch", "signature mismatch")
    return access_key

"""A small S3 client with SigV4 signing (``minio_tpu/s3/client.py``),
trimmed to what drives the port without boto3: make and list buckets,
PUT (header-signed or aws-chunked), GET, HEAD, DELETE and listing;
``send`` takes any request signed by ``sigv4``.
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from .sigv4 import Credentials, sign_request, sign_request_streaming

S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


class S3ClientError(Exception):
    def __init__(self, status: int, code: str, message: str = ""):
        super().__init__(f"{status} {code}: {message}")
        self.status = status
        self.code = code


@dataclass
class S3Response:
    status: int
    headers: dict[str, str]
    body: bytes

    def xml(self) -> ET.Element:
        return ET.fromstring(self.body)


@dataclass
class S3Client:
    endpoint: str                       # http://host:port
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    timeout: float = 600.0

    @property
    def _creds(self) -> Credentials:
        return Credentials(self.access_key, self.secret_key)

    def _url(self, path: str, query: str) -> str:
        path = urllib.parse.quote(path, safe="/~-._")   # keys with spaces
        return self.endpoint + path + (f"?{query}" if query else "")

    def send(self, method: str, url: str, body: bytes = b"",
             headers: dict | None = None,
             expect=(200, 204, 206)) -> S3Response:
        """Send a request as given (already signed, presigned or
        anonymous); raise S3ClientError for a status not in ``expect``."""
        u = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(u.hostname, u.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, u.path + (f"?{u.query}" if u.query else ""),
                         body=body, headers=headers or {})
            resp = conn.getresponse()
            out = S3Response(resp.status, dict(resp.getheaders()),
                             resp.read())
        finally:
            conn.close()
        if expect and out.status not in expect:
            code, msg = "Unknown", ""
            try:
                e = out.xml()
                code = e.findtext("Code") or code
                msg = e.findtext("Message") or ""
            except ET.ParseError:
                pass
            raise S3ClientError(out.status, code, msg)
        return out

    def request(self, method: str, path: str, query: str = "",
                body: bytes = b"", headers: dict | None = None,
                sign: bool = True, expect=(200, 204, 206)) -> S3Response:
        url = self._url(path, query)
        hdrs = dict(headers or {})
        if sign:
            hdrs = sign_request(self._creds, method, url, hdrs, body,
                                self.region)
        return self.send(method, url, body, hdrs, expect)

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        self.request("PUT", f"/{bucket}")

    def list_buckets(self) -> list[str]:
        r = self.request("GET", "/")
        return [b.findtext(f"{S3_NS}Name")
                for b in r.xml().iter(f"{S3_NS}Bucket")]

    # -- objects -----------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes) -> S3Response:
        """Header-signed PUT (the body's SHA-256 in the signature)."""
        return self.request("PUT", f"/{bucket}/{key}", body=data)

    def put_object_chunked(self, bucket: str, key: str, data: bytes,
                           chunk_size: int = 64 * 1024,
                           content_md5: bool = True) -> S3Response:
        """aws-chunked PUT (STREAMING-AWS4-HMAC-SHA256-PAYLOAD): every
        chunk signed in a chain; with ``content_md5`` the body's MD5 goes
        along for the server to check."""
        hdrs = {}
        if content_md5:
            hdrs["Content-MD5"] = base64.b64encode(
                hashlib.md5(data).digest()).decode()
        url = self._url(f"/{bucket}/{key}", "")
        hdrs, body = sign_request_streaming(self._creds, "PUT", url, hdrs,
                                            data, chunk_size, self.region)
        return self.send("PUT", url, body, hdrs)

    def get_object(self, bucket: str, key: str,
                   byte_range: tuple[int, int] | None = None) -> S3Response:
        hdrs = {}
        if byte_range:
            hdrs["Range"] = f"bytes={byte_range[0]}-{byte_range[1]}"
        return self.request("GET", f"/{bucket}/{key}", headers=hdrs)

    def head_object(self, bucket: str, key: str) -> S3Response:
        return self.request("HEAD", f"/{bucket}/{key}")

    def delete_object(self, bucket: str, key: str) -> S3Response:
        return self.request("DELETE", f"/{bucket}/{key}")

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "") -> dict:
        """The first ListObjectsV2 page: its objects, common prefixes,
        whether it is truncated and the token of the next."""
        q = ["list-type=2"]
        if prefix:
            q.append(f"prefix={urllib.parse.quote(prefix)}")
        if delimiter:
            q.append(f"delimiter={urllib.parse.quote(delimiter)}")
        root = self.request("GET", f"/{bucket}", "&".join(q)).xml()
        return {
            "objects": [{
                "key": c.findtext(f"{S3_NS}Key"),
                "size": int(c.findtext(f"{S3_NS}Size")),
                "etag": (c.findtext(f"{S3_NS}ETag") or "").strip('"'),
            } for c in root.iter(f"{S3_NS}Contents")],
            "prefixes": [p.findtext(f"{S3_NS}Prefix")
                         for p in root.iter(f"{S3_NS}CommonPrefixes")],
            "is_truncated": root.findtext(f"{S3_NS}IsTruncated") == "true",
            "next_token": root.findtext(f"{S3_NS}NextContinuationToken")
            or ""}

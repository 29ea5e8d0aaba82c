"""A small S3 client with SigV4 signing (``minio_tpu/s3/client.py``),
trimmed to what drives the port without boto3: make and list buckets,
PUT (header-signed or aws-chunked), GET, HEAD, DELETE and listing, by
version id too; bucket versioning and ListObjectVersions; multipart
uploads, with ``upload_parts`` sending the parts from worker threads as
minio-go does; bucket policies; STS AssumeRole (``assume_role`` returns
a client of the session, which sends its token on every request);
SigV2 header-signed requests and presigned URLs; POST-policy uploads;
CopyObject and UploadPartCopy; object and bucket tagging; object lock
(lock-enabled buckets, their default retention, a version's retention
and legal hold, and a delete that bypasses governance retention).
``send`` takes any request signed by ``sigv4`` or ``sigv2``.  An
``https://`` endpoint is reached with ``ssl_context`` when one is given,
else with a context that trusts ``ca_file``, else with the process's
``s3`` context from ``secure/transport.py`` (a TLS server or node of this
process configured its CA there; the system's roots otherwise).
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import http.client
import json
import ssl
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from xml.sax.saxutils import escape

from ..secure import transport
from . import postpolicy, sigv2
from .sigv4 import Credentials, sign_request, sign_request_streaming

STS_NS = "{https://sts.amazonaws.com/doc/2011-06-15/}"

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
    session_token: str = ""             # an STS session's
    ssl_context: ssl.SSLContext | None = None   # an https endpoint's
    ca_file: str | None = None          # or the CA that pins it

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
        if u.scheme == "https":
            if self.ssl_context is None and self.ca_file:
                # built once: a CA bundle parsed per request would tax
                # every call
                self.ssl_context = ssl.create_default_context(
                    cafile=self.ca_file)
            conn = transport.https_connection(u.hostname, u.port,
                                              self.timeout, plane="s3",
                                              context=self.ssl_context)
        else:
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=self.timeout)
        try:
            try:
                conn.request(method,
                             u.path + (f"?{u.query}" if u.query else ""),
                             body=body, headers=headers or {})
            except (BrokenPipeError, ConnectionResetError):
                pass    # the server answered before it read the whole
                #         body (a refusal): its answer is still readable
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
        hdrs = self._token(headers)
        if sign:
            hdrs = sign_request(self._creds, method, url, hdrs, body,
                                self.region)
        return self.send(method, url, body, hdrs, expect)

    def _token(self, headers: dict | None) -> dict:
        hdrs = dict(headers or {})
        if self.session_token:
            hdrs["x-amz-security-token"] = self.session_token
        return hdrs

    def request_v2(self, method: str, path: str, query: str = "",
                   body: bytes = b"", headers: dict | None = None,
                   expect=(200, 204, 206)) -> S3Response:
        """A SigV2 header-signed request (``Authorization: AWS
        key:signature`` over the Date header)."""
        url = self._url(path, query)
        hdrs = self._token(headers)
        hdrs["Date"] = email.utils.formatdate(usegmt=True)
        hdrs["Authorization"] = sigv2.sign_header(
            self.access_key, self.secret_key, method, path,
            urllib.parse.parse_qs(query, keep_blank_values=True), hdrs)
        return self.send(method, url, body, hdrs, expect)

    def presign_v2(self, method: str, bucket: str, key: str,
                   expires_s: int = 900) -> str:
        """A SigV2 presigned URL, valid for ``expires_s`` seconds."""
        path = f"/{bucket}/{key}"
        return self._url(path, "") + "?" + sigv2.presign(
            self.access_key, self.secret_key, method, path,
            int(time.time()) + expires_s)

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str, object_lock: bool = False) -> None:
        """A bucket; with ``object_lock`` a lock-enabled (and versioned)
        one."""
        self.request("PUT", f"/{bucket}", headers={
            "x-amz-bucket-object-lock-enabled": "true"}
            if object_lock else None)

    def list_buckets(self) -> list[str]:
        r = self.request("GET", "/")
        return [b.findtext(f"{S3_NS}Name")
                for b in r.xml().iter(f"{S3_NS}Bucket")]

    # -- objects -----------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes,
                   headers: dict | None = None) -> S3Response:
        """Header-signed PUT (the body's SHA-256 in the signature);
        ``headers`` such as ``x-amz-tagging`` or the object lock's go
        along."""
        return self.request("PUT", f"/{bucket}/{key}", body=data,
                            headers=headers)

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
        hdrs, body = sign_request_streaming(self._creds, "PUT", url,
                                            self._token(hdrs), data,
                                            chunk_size, self.region)
        return self.send("PUT", url, body, hdrs)

    def get_object(self, bucket: str, key: str,
                   byte_range: tuple[int, int] | None = None,
                   version_id: str | None = None,
                   expect=(200, 206),
                   headers: dict | None = None) -> S3Response:
        hdrs = dict(headers or {})
        if byte_range:
            hdrs["Range"] = f"bytes={byte_range[0]}-{byte_range[1]}"
        return self.request("GET", f"/{bucket}/{key}", _vid(version_id),
                            headers=hdrs, expect=expect)

    def head_object(self, bucket: str, key: str,
                    version_id: str | None = None,
                    expect=(200,)) -> S3Response:
        return self.request("HEAD", f"/{bucket}/{key}", _vid(version_id),
                            expect=expect)

    def delete_object(self, bucket: str, key: str,
                      version_id: str | None = None,
                      bypass_governance: bool = False) -> S3Response:
        return self.request("DELETE", f"/{bucket}/{key}", _vid(version_id),
                            headers=_bypass(bypass_governance))

    # -- copy ----------------------------------------------------------------

    def copy_object(self, bucket: str, key: str, src_bucket: str,
                    src_key: str, version_id: str | None = None,
                    headers: dict | None = None) -> S3Response:
        """CopyObject of ``src_bucket/src_key`` (of its ``version_id``);
        ``headers`` carry the directives (``x-amz-metadata-directive``,
        ``x-amz-tagging-directive``), the conditions
        (``x-amz-copy-source-if-match``, ...) and the new metadata."""
        return self.request("PUT", f"/{bucket}/{key}", headers={
            "x-amz-copy-source": _copy_source(src_bucket, src_key,
                                              version_id),
            **(headers or {})})

    def upload_part_copy(self, bucket: str, key: str, upload_id: str,
                         part_number: int, src_bucket: str, src_key: str,
                         byte_range: tuple[int, int] | None = None,
                         version_id: str | None = None) -> str:
        """UploadPartCopy of the source's bytes [first, last] (all
        without ``byte_range``); returns the part's ETag."""
        hdrs = {"x-amz-copy-source": _copy_source(src_bucket, src_key,
                                                  version_id)}
        if byte_range:
            hdrs["x-amz-copy-source-range"] = \
                f"bytes={byte_range[0]}-{byte_range[1]}"
        r = self.request("PUT", f"/{bucket}/{key}",
                         f"partNumber={part_number}&uploadId={upload_id}",
                         headers=hdrs)
        return r.xml().findtext(f"{S3_NS}ETag").strip('"')

    # -- tagging, retention, legal hold, object lock -------------------------

    def put_object_tagging(self, bucket: str, key: str, tags: dict,
                           version_id: str | None = None) -> None:
        self.request("PUT", f"/{bucket}/{key}", _sub("tagging", version_id),
                     _tagging_xml(tags))

    def get_object_tagging(self, bucket: str, key: str,
                           version_id: str | None = None) -> dict:
        return _tags_of(self.request("GET", f"/{bucket}/{key}",
                                     _sub("tagging", version_id)))

    def delete_object_tagging(self, bucket: str, key: str,
                              version_id: str | None = None) -> None:
        self.request("DELETE", f"/{bucket}/{key}",
                     _sub("tagging", version_id))

    def put_bucket_tagging(self, bucket: str, tags: dict) -> None:
        self.request("PUT", f"/{bucket}", "tagging", _tagging_xml(tags))

    def get_bucket_tagging(self, bucket: str) -> dict:
        return _tags_of(self.request("GET", f"/{bucket}", "tagging"))

    def delete_bucket_tagging(self, bucket: str) -> None:
        self.request("DELETE", f"/{bucket}", "tagging")

    def put_object_lock_config(self, bucket: str, mode: str = "",
                               days: int = 0, years: int = 0) -> None:
        """The bucket's default retention (``mode`` with ``days`` or
        ``years``); none with an empty ``mode``."""
        rule = ""
        if mode:
            period = f"<Days>{days}</Days>" if days \
                else f"<Years>{years}</Years>"
            rule = (f"<Rule><DefaultRetention><Mode>{mode}</Mode>{period}"
                    "</DefaultRetention></Rule>")
        self.request("PUT", f"/{bucket}", "object-lock", (
            f'<ObjectLockConfiguration xmlns="{S3_NS[1:-1]}">'
            f"<ObjectLockEnabled>Enabled</ObjectLockEnabled>{rule}"
            "</ObjectLockConfiguration>").encode())

    def get_object_lock_config(self, bucket: str) -> ET.Element:
        return self.request("GET", f"/{bucket}", "object-lock").xml()

    def put_object_retention(self, bucket: str, key: str, mode: str,
                             until: datetime.datetime,
                             version_id: str | None = None,
                             bypass_governance: bool = False) -> None:
        date = until.astimezone(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        self.request("PUT", f"/{bucket}/{key}",
                     _sub("retention", version_id), (
                         f'<Retention xmlns="{S3_NS[1:-1]}"><Mode>{mode}'
                         f"</Mode><RetainUntilDate>{date}</RetainUntilDate>"
                         "</Retention>").encode(),
                     headers=_bypass(bypass_governance))

    def get_object_retention(self, bucket: str, key: str,
                             version_id: str | None = None) -> tuple:
        """(mode, retain-until date as sent)."""
        root = self.request("GET", f"/{bucket}/{key}",
                            _sub("retention", version_id)).xml()
        return (root.findtext(f"{S3_NS}Mode"),
                root.findtext(f"{S3_NS}RetainUntilDate"))

    def put_object_legal_hold(self, bucket: str, key: str, on: bool,
                              version_id: str | None = None) -> None:
        self.request("PUT", f"/{bucket}/{key}",
                     _sub("legal-hold", version_id), (
                         f'<LegalHold xmlns="{S3_NS[1:-1]}"><Status>'
                         f'{"ON" if on else "OFF"}</Status></LegalHold>'
                     ).encode())

    def get_object_legal_hold(self, bucket: str, key: str,
                              version_id: str | None = None) -> str:
        return self.request("GET", f"/{bucket}/{key}",
                            _sub("legal-hold", version_id)
                            ).xml().findtext(f"{S3_NS}Status")

    # -- versioning --------------------------------------------------------

    def set_bucket_versioning(self, bucket: str, enabled: bool) -> None:
        status = "Enabled" if enabled else "Suspended"
        self.request("PUT", f"/{bucket}", "versioning", (
            f'<VersioningConfiguration xmlns="{S3_NS[1:-1]}"><Status>'
            f"{status}</Status></VersioningConfiguration>").encode())

    def get_bucket_versioning(self, bucket: str) -> str:
        """"Enabled", "Suspended", or "" for a bucket never versioned."""
        root = self.request("GET", f"/{bucket}", "versioning").xml()
        return root.findtext(f"{S3_NS}Status") or ""

    def list_object_versions(self, bucket: str, prefix: str = "") -> list:
        """Every version and delete marker, in the order listed."""
        q = "versions" + (f"&prefix={urllib.parse.quote(prefix)}"
                          if prefix else "")
        root = self.request("GET", f"/{bucket}", q).xml()
        out = []
        for v in root:
            tag = v.tag[len(S3_NS):]
            if tag not in ("Version", "DeleteMarker"):
                continue
            out.append({"key": v.findtext(f"{S3_NS}Key"),
                        "version_id": v.findtext(f"{S3_NS}VersionId"),
                        "is_latest": v.findtext(f"{S3_NS}IsLatest") == "true",
                        "delete_marker": tag == "DeleteMarker",
                        "size": int(v.findtext(f"{S3_NS}Size") or 0)})
        return out

    # -- bucket policy and lifecycle, STS, POST policy ----------------------

    def set_bucket_policy(self, bucket: str, policy: dict) -> None:
        self.request("PUT", f"/{bucket}", "policy",
                     json.dumps(policy).encode())

    def get_bucket_policy(self, bucket: str) -> dict:
        return json.loads(self.request("GET", f"/{bucket}", "policy").body)

    def delete_bucket_policy(self, bucket: str) -> None:
        self.request("DELETE", f"/{bucket}", "policy")

    def set_bucket_lifecycle(self, bucket: str, xml: bytes) -> None:
        self.request("PUT", f"/{bucket}", "lifecycle", xml)

    def assume_role(self, duration_s: int = 3600,
                    policy: dict | None = None) -> "S3Client":
        """STS AssumeRole: a client of the session's credentials (within
        ``policy`` when given)."""
        form = {"Action": "AssumeRole", "Version": "2011-06-15",
                "DurationSeconds": str(duration_s)}
        if policy is not None:
            form["Policy"] = json.dumps(policy)
        return self._sts(form, sign=True)

    def assume_role_with_ldap_identity(self, username: str,
                                       password: str) -> "S3Client":
        """STS AssumeRoleWithLDAPIdentity, unsigned: a client of the
        session the directory's user gets."""
        return self._sts({"Action": "AssumeRoleWithLDAPIdentity",
                          "Version": "2011-06-15", "LDAPUsername": username,
                          "LDAPPassword": password}, sign=False)

    def assume_role_with_web_identity(self, token: str) -> "S3Client":
        """STS AssumeRoleWithWebIdentity, unsigned: a client of the
        session an OpenID token gets."""
        return self._sts({"Action": "AssumeRoleWithWebIdentity",
                          "Version": "2011-06-15",
                          "WebIdentityToken": token}, sign=False)

    def _sts(self, form: dict, sign: bool) -> "S3Client":
        """POST an STS form; a client of the credentials it answers."""
        root = self.request("POST", "/", body=urllib.parse.urlencode(
            form).encode(), sign=sign, headers={
                "Content-Type": "application/x-www-form-urlencoded"}).xml()
        ce = root.find(f"{STS_NS}{form['Action']}Result/{STS_NS}Credentials")
        return S3Client(self.endpoint,
                        ce.findtext(f"{STS_NS}AccessKeyId"),
                        ce.findtext(f"{STS_NS}SecretAccessKey"),
                        self.region, self.timeout,
                        ce.findtext(f"{STS_NS}SessionToken"),
                        self.ssl_context, self.ca_file)

    def post_object(self, bucket: str, key: str, data: bytes,
                    conditions: list | None = None, expires_s: int = 900,
                    fields: dict | None = None,
                    expect=(200, 201, 204, 303)) -> S3Response:
        """A browser POST-policy upload, signed V4: the policy holds the
        bucket, the key, ``conditions`` and an expiry ``expires_s`` away;
        ``fields`` go into the form beside them."""
        now = datetime.datetime.now(datetime.timezone.utc)
        doc = {"expiration": (now + datetime.timedelta(
            seconds=expires_s)).strftime("%Y-%m-%dT%H:%M:%S.000Z"),
            "conditions": [{"bucket": bucket}, {"key": key},
                           *(conditions or [])]}
        form = {"key": key, **(fields or {}),
                **postpolicy.sign_policy_v4(self.access_key,
                                            self.secret_key, doc,
                                            self.region, now)}
        boundary = uuid.uuid4().hex
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="{k}"\r\n\r\n{v}\r\n'.encode()
                 for k, v in form.items()]
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="file"; filename="{key.rsplit("/", 1)[-1]}"'
                     f'\r\nContent-Type: application/octet-stream'
                     f'\r\n\r\n'.encode() + data + b"\r\n")
        body = b"".join(parts) + f"--{boundary}--\r\n".encode()
        return self.send("POST", self._url(f"/{bucket}", ""), body, {
            "Content-Type": f"multipart/form-data; boundary={boundary}"},
            expect)

    # -- multipart ---------------------------------------------------------

    def create_multipart_upload(self, bucket: str, key: str,
                                headers: dict | None = None) -> str:
        r = self.request("POST", f"/{bucket}/{key}", "uploads",
                         headers=headers)
        return r.xml().findtext(f"{S3_NS}UploadId")

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes, chunked: bool = True,
                    chunk_size: int = 64 * 1024,
                    headers: dict | None = None) -> str:
        """One part, aws-chunked with Content-MD5 (or header-signed),
        with ``headers`` (an SSE-C key, say); returns its ETag."""
        query = f"partNumber={part_number}&uploadId={upload_id}"
        if not chunked:
            r = self.request("PUT", f"/{bucket}/{key}", query, data,
                             headers=headers)
        else:
            url = self._url(f"/{bucket}/{key}", query)
            hdrs, body = sign_request_streaming(
                self._creds, "PUT", url, self._token({
                    **(headers or {}),
                    "Content-MD5": base64.b64encode(
                        hashlib.md5(data).digest()).decode()}),
                data, chunk_size, self.region)
            r = self.send("PUT", url, body, hdrs)
        return r.headers["ETag"].strip('"')

    def list_parts(self, bucket: str, key: str, upload_id: str) -> list:
        root = self.request("GET", f"/{bucket}/{key}",
                            f"uploadId={upload_id}").xml()
        return [{"part_number": int(p.findtext(f"{S3_NS}PartNumber")),
                 "etag": p.findtext(f"{S3_NS}ETag").strip('"'),
                 "size": int(p.findtext(f"{S3_NS}Size"))}
                for p in root.iter(f"{S3_NS}Part")]

    def complete_multipart_upload(self, bucket: str, key: str,
                                  upload_id: str,
                                  parts: list[tuple[int, str]]
                                  ) -> S3Response:
        doc = "<CompleteMultipartUpload>" + "".join(
            f'<Part><PartNumber>{n}</PartNumber><ETag>"{e}"</ETag></Part>'
            for n, e in parts) + "</CompleteMultipartUpload>"
        return self.request("POST", f"/{bucket}/{key}",
                            f"uploadId={upload_id}", doc.encode())

    def abort_multipart_upload(self, bucket: str, key: str,
                               upload_id: str) -> None:
        self.request("DELETE", f"/{bucket}/{key}", f"uploadId={upload_id}")

    def list_multipart_uploads(self, bucket: str) -> list:
        root = self.request("GET", f"/{bucket}", "uploads").xml()
        return [(u.findtext(f"{S3_NS}Key"), u.findtext(f"{S3_NS}UploadId"))
                for u in root.iter(f"{S3_NS}Upload")]

    def upload_parts(self, bucket: str, key: str, data: bytes,
                     part_size: int = 16 * 1024 * 1024,
                     workers: int = 4) -> tuple[str, list, list]:
        """A new upload of ``data`` in parts of ``part_size`` bytes, sent
        aws-chunked from ``workers`` threads (minio-go's defaults: 16 MiB,
        4); returns (upload id, [(part number, ETag)], [seconds per
        part]).  ``complete_multipart_upload`` finishes it."""
        upload_id = self.create_multipart_upload(bucket, key)
        offsets = list(range(0, max(1, len(data)), part_size))

        def one(i: int) -> tuple[str, float]:
            t0 = time.perf_counter()
            etag = self.upload_part(bucket, key, upload_id, i + 1,
                                    data[offsets[i]:offsets[i] + part_size])
            return etag, time.perf_counter() - t0

        with ThreadPoolExecutor(workers) as pool:
            done = list(pool.map(one, range(len(offsets))))
        return (upload_id, [(i + 1, e) for i, (e, _) in enumerate(done)],
                [t for _, t in done])

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "", max_keys: int = 0,
                     continuation_token: str = "") -> dict:
        """One ListObjectsV2 page (the first, or the one after
        ``continuation_token``; ``max_keys`` 0 is the server's default):
        its objects, common prefixes, whether it is truncated and the
        token of the next."""
        q = ["list-type=2"]
        if prefix:
            q.append(f"prefix={urllib.parse.quote(prefix)}")
        if delimiter:
            q.append(f"delimiter={urllib.parse.quote(delimiter)}")
        if max_keys:
            q.append(f"max-keys={max_keys}")
        if continuation_token:
            q.append("continuation-token="
                     + urllib.parse.quote(continuation_token, safe=""))
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


def _vid(version_id: str | None) -> str:
    return "" if version_id is None else \
        f"versionId={urllib.parse.quote(version_id or 'null')}"


def _sub(subresource: str, version_id: str | None) -> str:
    vid = _vid(version_id)
    return f"{subresource}&{vid}" if vid else subresource


def _bypass(on: bool) -> dict | None:
    return {"x-amz-bypass-governance-retention": "true"} if on else None


def _copy_source(bucket: str, key: str, version_id: str | None) -> str:
    src = "/" + urllib.parse.quote(f"{bucket}/{key}")
    return src if version_id is None else \
        f"{src}?versionId={version_id or 'null'}"


def _tagging_xml(tags: dict) -> bytes:
    return (f'<Tagging xmlns="{S3_NS[1:-1]}"><TagSet>' + "".join(
        f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}</Value></Tag>"
        for k, v in tags.items()) + "</TagSet></Tagging>").encode()


def _tags_of(resp: S3Response) -> dict:
    return {t.findtext(f"{S3_NS}Key"): t.findtext(f"{S3_NS}Value") or ""
            for t in resp.xml().iter(f"{S3_NS}Tag")}


def multipart_etag(part_etags: list[str]) -> str:
    """The ETag a complete answers: md5 of the parts' MD5s, then -N."""
    md5s = b"".join(bytes.fromhex(e) for e in part_etags)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(part_etags)}"

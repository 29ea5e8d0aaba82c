"""S3 API HTTP server over the port's erasure sets (``minio_tpu/s3/server.py``,
cmd/api-router.go:82 with cmd/object-handlers.go and
cmd/bucket-handlers.go).

Path-style S3 on a threading HTTP server, one thread per connection.
A handler authenticates (SigV4: header-signed, presigned or aws-chunked),
authorizes, maps the route to one call of the object layer and renders
S3 XML; the erasure coding and bitrot hashing of the body run on the
layer's device.  One root credential and no subsystems: the root key may
do everything, an unknown key gets InvalidAccessKeyId and an anonymous
request AccessDenied.  Multipart uploads and versioned buckets are
served (a bucket's versioning state in ``bucket_meta``).  What the port
does not serve (bucket configs, tagging, object lock, copy, select,
SigV2, STS, admin, the web UI, SSE) answers the S3 ``NotImplemented``
error document.  The health probes are served: ``/minio/health/live``
and ``ready`` while the process serves, ``/minio/health/cluster`` from the
layer's write quorum.  Background loops attached to the server (the heal
sweep) start and stop with it.
"""

from __future__ import annotations

import datetime
import email.utils
import hashlib
import re
import socket
import threading
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..objectlayer import interface as ol
from ..objectlayer.bucket_meta import BucketMetadataSys
from ..parallel.dsync import LockTimeout
from . import errors as s3err
from . import sigv4

MAX_PUT_SIZE = 5 * 1024 * 1024 * 1024   # single PUT (docs/minio-limits.md)
# bodies above this stream straight into the object layer (O(batch)
# memory); smaller ones are read whole first
STREAM_PUT_THRESHOLD = 8 * 1024 * 1024
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"
RESERVED_BUCKETS = ("minio-tpu", "minio")
SSE_HEADERS = ("x-amz-server-side-encryption",
               "x-amz-server-side-encryption-customer-algorithm",
               "x-amz-copy-source-server-side-encryption-customer-algorithm")

_BUCKET_RE = re.compile(r"^[a-z0-9][a-z0-9.\-]{1,61}[a-z0-9]$")


class S3Error(Exception):
    def __init__(self, code: str):
        super().__init__(code)
        self.api = s3err.get(code)


class _BodyReader:
    """The socket body capped at its Content-Length, its SHA-256 checked
    once the last byte is read (pkg/hash's Reader): a PUT streams while
    its commit still waits on the body's integrity.  IncompleteBody when
    the peer hangs up early."""

    def __init__(self, raw, total: int, sha256_hex: str | None = None):
        self.raw = raw
        self.remaining = total
        self._sha = hashlib.sha256() if sha256_hex else None
        self._want_sha = sha256_hex

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.remaining
        n = min(n, self.remaining)
        if n <= 0:
            return b""
        chunks = []
        while n > 0:
            c = self.raw.read(n)
            if not c:
                raise S3Error("IncompleteBody")
            chunks.append(c)
            n -= len(c)
            self.remaining -= len(c)
        data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        if self._sha is not None:
            self._sha.update(data)
            if self.remaining == 0 and \
                    self._sha.hexdigest() != self._want_sha:
                raise S3Error("BadDigest")
        return data

    def readline(self, limit: int = 8192) -> bytes:
        """One aws-chunked frame header, at most ``limit`` bytes (the
        chunk reader refuses one without its CRLF)."""
        line = self.raw.readline(min(limit, self.remaining))
        self.remaining -= len(line)
        return line


def _http_date(ns: int) -> str:
    return email.utils.formatdate(ns / 1e9, usegmt=True)


def _iso_date(ns: int) -> str:
    return datetime.datetime.fromtimestamp(
        ns / 1e9, datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _parse_range(spec: str) -> tuple[int, int]:
    """HTTP Range -> (offset, length) without knowing the size
    (cmd/httprange.go): a negative offset is a suffix, length -1 runs to
    the end.  The object layer clamps and validates against the size, so
    a ranged GET costs one quorum metadata read."""
    m = re.match(r"^bytes=(\d*)-(\d*)$", spec.strip())
    if not m:
        raise S3Error("InvalidRange")
    first, last = m.group(1), m.group(2)
    if first == "" and last == "":
        raise S3Error("InvalidRange")
    if first == "":                     # suffix range: the last N bytes
        n = int(last)
        if n == 0:
            raise S3Error("InvalidRange")
        return -n, -1
    start = int(first)
    if last == "":
        return start, -1
    end = int(last)
    if end < start:
        raise S3Error("InvalidRange")
    return start, end - start + 1


class S3Server:
    """An object layer and one root credential behind an HTTP server."""

    def __init__(self, layer, access_key: str = "minioadmin",
                 secret_key: str = "minioadmin", region: str = "us-east-1",
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_size: int = 1024 ** 3):
        self.layer = layer
        self.bucket_meta = BucketMetadataSys(layer)
        self.access_key = access_key
        self._secret_key = secret_key
        self.region = region
        self.max_body_size = max_body_size
        self._stopping = False
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        # the background heal sweep (initBackgroundHealing,
        # cmd/server-main.go): its life follows the server's
        self.healer = None

    def lookup_secret(self, access_key: str) -> str | None:
        return self._secret_key if access_key == self.access_key else None

    def start(self) -> None:
        """Serve on a thread, and start the heal sweep."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="mt-s3-server")
        self._thread.start()
        if self.healer is not None:
            self.healer.start()

    def stop(self) -> None:
        """Stop the heal sweep and listening, cut the open connections,
        and close the layer (its drive monitor stops, its writer threads
        join; cmd/server-main.go's shutdown)."""
        self._stopping = True
        if self.healer is not None:
            self.healer.stop()
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join()
        self.httpd.server_close()
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass                    # already gone
        self.layer.close()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def _make_handler(srv: S3Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "MinioTPU"

        def setup(self):
            super().setup()
            with srv._conns_mu:
                srv._conns.add(self.connection)

        def finish(self):
            try:
                super().finish()
            finally:
                with srv._conns_mu:
                    srv._conns.discard(self.connection)

        def log_message(self, fmt, *args):
            pass

        def _split(self):
            u = urllib.parse.urlsplit(self.path)
            path = urllib.parse.unquote(u.path)
            query = urllib.parse.parse_qs(u.query, keep_blank_values=True)
            parts = path.lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            return path, bucket, key, query

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            if n > srv.max_body_size:
                # refused before it is read: no client may force a huge
                # allocation, signed or not
                raise S3Error("EntityTooLarge")
            return self.rfile.read(n) if n else b""

        def _auth(self, path, query, payload: bytes) -> bytes:
            """Authenticate; returns the effective payload (an aws-chunked
            body verified chunk by chunk and unframed).  Sets
            ``self.access_key``, empty for an anonymous request."""
            hdrs = dict(self.headers.items())
            try:
                if "Authorization" not in hdrs and \
                        "X-Amz-Signature" not in query and \
                        not ("Signature" in query and
                             "AWSAccessKeyId" in query):
                    self.access_key = ""
                    sha = self.headers.get("x-amz-content-sha256")
                    if sha and sha != sigv4.UNSIGNED_PAYLOAD and \
                            hashlib.sha256(payload).hexdigest() != sha:
                        raise S3Error("BadDigest")
                    return payload
                if hdrs.get("Authorization", "").startswith("AWS ") or \
                        "AWSAccessKeyId" in query:
                    raise S3Error("NotImplemented")        # SigV2
                if "X-Amz-Signature" in query:
                    self.access_key = sigv4.verify_presigned(
                        srv.lookup_secret, self.command, path, query, hdrs,
                        region=srv.region)
                    return payload
                sha = self.headers.get("x-amz-content-sha256",
                                       sigv4.UNSIGNED_PAYLOAD)
                if sha == sigv4.STREAMING_PAYLOAD:
                    self.access_key, key, seed, amz_date, scope = \
                        sigv4.verify_request_streaming(
                            srv.lookup_secret, self.command, path, query,
                            hdrs, region=srv.region)
                    return sigv4.decode_chunked_payload(
                        payload, key, seed, amz_date, scope)
                if sha != sigv4.UNSIGNED_PAYLOAD and \
                        hashlib.sha256(payload).hexdigest() != sha:
                    raise S3Error("BadDigest")
                self.access_key = sigv4.verify_request(
                    srv.lookup_secret, self.command, path, query, hdrs, sha,
                    region=srv.region)
                return payload
            except sigv4.SigV4Error as e:
                raise S3Error(e.code) from e

        def _allow(self) -> None:
            """Authorize: with one root credential, every authenticated
            request may act and no anonymous one may (no bucket
            policies)."""
            if not self.access_key:
                raise S3Error("AccessDenied")

        def _send_prologue(self, status: int, entity_len: int,
                           content_type: str, headers: dict | None):
            self.send_response(status)
            self.send_header("x-amz-request-id", self._req_id)
            self.send_header("Server", "MinioTPU")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(entity_len))
            self.end_headers()

        def _send(self, status: int, body: bytes = b"",
                  content_type: str = "application/xml",
                  headers: dict | None = None,
                  content_length: int | None = None):
            """``content_length``: the entity's length for a HEAD, whose
            body is not sent."""
            self._send_prologue(
                status, len(body) if content_length is None
                else content_length, content_type, headers)
            if body and self.command != "HEAD":
                self.wfile.write(body)

        def _send_stream(self, status: int, gen, total: int,
                         content_type: str, headers: dict | None = None):
            """Send a body of known length chunk by chunk
            (cmd/object-api-utils.go:586 NewGetObjectReader).  The first
            chunk is pulled before the status line, so a read that fails
            at once still answers its XML error; after the status line a
            failure drops the connection and the short body tells the
            client."""
            it = iter(gen)
            first = b""
            if self.command != "HEAD" and total:
                first = next(it, b"")
            self._send_prologue(status, total, content_type, headers)
            try:
                if first:
                    self.wfile.write(first)
                for chunk in it:
                    if chunk:
                        self.wfile.write(chunk)
            except (ConnectionError, TimeoutError):
                self.close_connection = True
                raise
            except Exception:   # noqa: BLE001 — the status line is out;
                # a second response would corrupt the stream
                self.close_connection = True
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

        def _fail(self, e: Exception, resource: str = ""):
            if isinstance(e, S3Error):
                api = e.api
            elif isinstance(e, sigv4.SigV4Error):
                api = s3err.get(e.code)
            elif isinstance(e, ol.ObjectLayerError):
                api = s3err.from_object_error(e)
            elif isinstance(e, LockTimeout):
                api = s3err.get("SlowDown")     # contention, not a fault
            elif isinstance(e, TimeoutError):
                # the socket stalled mid-body: the unread rest would
                # desync keep-alive
                api = s3err.get("RequestTimeout")
                self.close_connection = True
            else:
                api = s3err.get("InternalError")
            self._send(api.http_status,
                       s3err.to_xml(api, resource, self._req_id))

        def _dispatch(self):
            self._req_id = uuid.uuid4().hex[:16]
            self.access_key = ""
            try:
                self._dispatch_inner()
            except (ConnectionError, TimeoutError):
                # the client died mid-body or mid-response
                self.close_connection = True
            if srv._stopping:
                self.close_connection = True

        def _dispatch_inner(self):
            path, bucket, key, query = self._split()
            try:
                if path.startswith(("/minio-tpu/health/",
                                    "/minio/health/")):
                    # unauthenticated probes (cmd/healthcheck-router.go)
                    self._body()
                    return self._health_api(path, query)
                if path.startswith("/minio-tpu/") or \
                        any(h in self.headers for h in SSE_HEADERS):
                    # admin, metrics, web UI; server-side encryption
                    raise S3Error("NotImplemented")
                if self._try_stream_put(path, bucket, key, query):
                    return
                payload = self._auth(path, query, self._body())
                if bucket in RESERVED_BUCKETS:
                    # isMinioReservedBucket (cmd/generic-handlers.go)
                    raise S3Error("AccessDenied")
                if not bucket:
                    if self.command == "POST":
                        raise S3Error("NotImplemented")     # STS
                    return self._list_buckets()
                if not _BUCKET_RE.match(bucket):
                    raise S3Error("InvalidBucketName")
                if key:
                    return self._object_api(bucket, key, query, payload)
                return self._bucket_api(bucket, query, payload)
            except ConnectionError:
                raise                   # nobody left to answer
            except Exception as e:  # noqa: BLE001 — every error is XML
                self._fail(e, path)

        # any method, PATCH and OPTIONS too, answers S3 XML, never the
        # stdlib's plain 501
        do_GET = do_PUT = do_HEAD = do_DELETE = do_POST = do_PATCH = \
            do_OPTIONS = lambda self: self._dispatch()

        def _health_api(self, path, query):
            if self.command not in ("GET", "HEAD"):
                raise S3Error("MethodNotAllowed")
            leaf = path.split("/health/", 1)[1]
            status, headers = 200, {}
            if leaf == "cluster":
                # ready for traffic; with maintenance, may this node be
                # taken down (cmd/healthcheck-handler.go:28-66)
                maint = query.get("maintenance", [""])[0] == "true"
                h = srv.layer.health(maintenance=maint)
                if h["write_quorum"]:
                    headers["X-Minio-Write-Quorum"] = str(h["write_quorum"])
                if not h["healthy"]:
                    if h["healing_drives"]:
                        headers["X-Minio-Healing-Drives"] = \
                            str(h["healing_drives"])
                    status = 412 if maint else 503
            elif leaf in ("live", "ready"):
                # 200 while the process serves (cmd/healthcheck-handler.go:69)
                if srv._stopping:
                    headers["X-Minio-Server-Status"] = "offline"
            else:
                raise S3Error("NoSuchKey")
            self._send(status, b"", headers=headers)

    from . import handlers_bucket, handlers_object
    Handler.srv = srv
    for mod in (handlers_bucket, handlers_object):
        for name in mod.HANDLERS:
            setattr(Handler, name, getattr(mod, name))
    return Handler

"""S3 API HTTP server over the port's erasure sets (``minio_tpu/s3/server.py``,
cmd/api-router.go:82 with cmd/object-handlers.go and
cmd/bucket-handlers.go).

Path-style S3 on a threading HTTP server, one thread per connection.
A handler authenticates (SigV4: header-signed, presigned or aws-chunked;
SigV2: header-signed or presigned; the POST-policy form's own
signature), authorises the request's S3 action through the bucket
policy and IAM (``iam/sys.py``: the root credential, users, service
accounts and STS sessions, whose session token is checked on every
request), maps the route to one call of the object layer and renders S3
XML; the erasure coding and bitrot hashing of the body run on the
layer's device.  A request is authorised before its body is read or
encoded.  Multipart uploads, versioned buckets, CopyObject and
UploadPartCopy, object and bucket tagging, object lock (retention, legal
hold, a bucket's default retention), bucket policies (``?policy``),
lifecycle and quota, POST-policy uploads and STS AssumeRole are served,
and so are storage classes (``x-amz-storage-class``: the object's
parity), SSE-C, SSE-S3 and SSE-KMS (``crypto/sse.py``, with a bucket's
default encryption) and transparent compression (``compress/``); a
listing and a HEAD give a transformed object's plain size
(``_actual_size``).  ``kms`` is the key service of SSE-S3 and SSE-KMS
(``crypto/kms.py``: KES, Vault or the local master key); ``tls``, when
given or set in the ``tls`` subsystem, serves the front over TLS
(``secure/certs.py``; its CA then serves the process's https clients,
``secure/transport.py``), and a request with SSE-C headers over plain
HTTP is refused (InsecureSSECustomerRequest) before it is authenticated.
``federation``, from the ``federation`` subsystem (``utils/fed_dns.py``),
registers each bucket this server makes in a DNS store shared with other
servers (a JSON file, or etcd's skydns keys) and frees it on delete; a
name another server holds answers BucketAlreadyExists, and a request for
a bucket homed on another server answers 307 to it.
Transitions to a remote tier and their restore (``transition``, the
tiers registered in ``tiers/tiers.json``) and S3 Select are served, and
so are the replication and notification configs, the canned private
ACL, CORS's and the dummy subresources' fixed answers.  ``replication``
(``background/replication.py``, built by ``start_replication`` once a
remote target is set or loaded) replicates every write and delete the
reference replicates (``replicate``) to the bucket's remote target.
``events`` is the notification system
(``events/``): every object call that the reference notifies fires its
event (``notify``) to the ListenNotification streams (GET ``?events``)
and, through the bucket's notification config, to the registered
targets, whose delivery engines (``egress``, ``obs/egress.py``) are
built from the ``notify_webhook`` and ``notify_<broker kind>``
subsystems (``reload_egress_config``).  The federated STS calls,
AssumeRoleWithLDAPIdentity and AssumeRoleWithWebIdentity, are served
unsigned through the providers built from the ``identity_ldap`` and
``identity_openid`` subsystems (``ldap``, ``openid``); ``etcd``, from the
``etcd`` subsystem, holds IAM's state in place of the drives; the OPA
webhook of ``policy_opa`` decides for IAM (``reload_policy_config``,
live).  What the port does not serve (the web UI, the admin routes of
``admin/handlers.py`` it lacks) answers the S3 ``NotImplemented`` error
document.  The health probes are served:
``/minio/health/live`` and ``ready`` while the process serves,
``/minio/health/cluster`` from the layer's write quorum.

The request plane (cmd/handler-api.go, cmd/http/server.go), from the
``api`` kvconfig subsystem and live on its change
(``reload_api_config``): S3 requests take a slot of ``requests_max``,
waiting at most ``requests_deadline`` in a line of ``requests_queue``;
a request beyond the line, or one whose wait runs out, answers 503
``SlowDown`` with ``Retry-After``, while the admin, metrics and health
paths stay reachable.  Each connection has a socket timeout for its
request line, headers and keep-alive idle, and each body an absolute
read budget (``_DeadlineRFile``), also when the read-ahead thread of a
streamed PUT reads it; past it the request answers 408
``RequestTimeout``.  A charge the memory governor refuses
(``utils/memgov.py``) answers 503 ``SlowDown`` with ``Retry-After``.
``stop()`` closes the listener, ends the ListenNotification streams,
lets in-flight requests finish for ``shutdown_drain_s``, then severs
what is left and closes the notification system and the targets.

The control plane: ``/minio-tpu/metrics`` (Prometheus, GET only, no
auth) and the admin API under ``/minio-tpu/admin/v1/`` (identities
allowed ``admin:*``), both in ``admin/handlers.py``; ``config`` is the
live kvconfig, sealed at rest in ``.mt.sys/config/config.json``, whose
``api``, ``pipeline``, ``commit``, ``heal`` and ``scanner`` changes the
``reload_*`` hooks push into the request plane, the layer, the commit
plane, the heal sweep and the crawler.  Every response counts into
``mt_s3_requests_total`` and ``mt_s3_tx_bytes_total``, every request
body into ``mt_s3_rx_bytes_total``; S3 API requests (not the
``/minio-tpu/`` and ``/minio/`` paths) also count per API name into
``mt_s3_requests_api_total``, ``mt_s3_requests_errors_total``,
``mt_s3_ttfb_seconds`` and the last-minute ``api_stats`` windows.

The background plane (``attach_background``): the heal sweep
(``healer``), the crawler (``crawler``) and, over a pools layer, the
rebalancer (``rebalancer``) start and stop with the server; ``stop()``
also joins the replication workers.  ``usage`` is the hard quota's view
of bucket usage, refreshed
by every crawler cycle; ``tracker`` (``attach_tracker``) is the
data-update tracker, marked by ``notify`` where an S3 call changed an
object (the reference's event points, but the reads: a GET or HEAD
keeps the cached listing) and read by the crawler and the listing
metacache.
"""

from __future__ import annotations

import datetime
import email.utils
import hashlib
import logging
import os
import re
import socket
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..admin import handlers as admin_handlers
from ..admin import metrics as _metrics
from ..background.crawler import UsageCache
from ..background.replication import ReplicationSys
from ..crypto import sse as csse
from ..crypto.kms import kms_from_env
from ..events import NotificationSys, WebhookTarget
from ..events.brokers import NOTIFY_SUBSYSTEMS, target_from_config
from ..iam import ldap as _ldap
from ..iam import openid as _oidc
from ..iam import sts as _sts
from ..iam.sys import IAMSys, NoSuchPolicy
from ..objectlayer import interface as ol
from ..objectlayer.bucket_meta import BucketMetadataSys
from ..objectlayer.metacache import leaf_layers_of, managers_of
from ..objectlayer.tiering import TransitionSys
from ..obs.egress import EgressRegistry, config_queue_limit
from ..obs.lastminute import OpWindows
from ..parallel.dsync import LockLost, LockTimeout
from ..secure import transport
from ..secure.certs import CertManager, enable_server_tls
from ..secure.opa import OpaWebhook
from ..storage import commit as _commit
from ..utils import memgov
from ..utils.etcd import from_config as etcd_from_config
from ..utils.fed_dns import FederationSys
from ..utils.kvconfig import Config, parse_duration
from . import errors as s3err
from . import sigv2, sigv4

MAX_PUT_SIZE = 5 * 1024 * 1024 * 1024   # single PUT (docs/minio-limits.md)
# bodies above this stream straight into the object layer (O(batch)
# memory); smaller ones are read whole first
STREAM_PUT_THRESHOLD = 8 * 1024 * 1024
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"
STS_NS = "https://sts.amazonaws.com/doc/2011-06-15/"
RESERVED_BUCKETS = ("minio-tpu", "minio")

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


class _DeadlineRFile:
    """A connection's read deadlines (cmd/http/server.go:185).  Between
    requests, and while the request line and headers are read, the
    socket timeout is ``header_timeout``.  While a body is read the
    wrapper is armed with an absolute deadline: each read re-arms the
    socket timeout to what is left of it (at most ``header_timeout``) and
    issues one recv at a time, so a client trickling bytes cannot stretch
    its budget.  Past the deadline a read raises TimeoutError, on
    whichever thread reads (the read-ahead of a streamed PUT too)."""

    def __init__(self, raw, sock, header_timeout: float | None):
        self._raw = raw
        self._sock = sock
        self._header_timeout = header_timeout
        self._deadline: float | None = None

    def arm(self, budget_s: float) -> None:
        self._deadline = time.monotonic() + budget_s

    def disarm(self) -> None:
        self._deadline = None
        try:
            self._sock.settimeout(self._header_timeout)
        except OSError:
            pass                        # the connection is already gone

    def _tick(self) -> None:
        if self._deadline is None:
            return
        remaining = self._deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError("request body deadline exceeded")
        try:
            self._sock.settimeout(remaining if self._header_timeout is None
                                  else min(remaining, self._header_timeout))
        except OSError:
            pass

    def read(self, n: int = -1) -> bytes:
        if self._deadline is None:
            return self._raw.read(n)
        # a buffered read(n) would loop on recv inside, beyond the
        # deadline's reach; read1 is one recv, checked before each
        out = bytearray()
        want = n if n is not None and n >= 0 else None
        while want is None or len(out) < want:
            self._tick()
            chunk = self._raw.read1(65536 if want is None
                                    else want - len(out))
            if not chunk:
                break
            out += chunk
        return bytes(out)

    def readline(self, limit: int = -1) -> bytes:
        self._tick()
        return self._raw.readline(limit)

    def readinto(self, b) -> int:
        self._tick()
        return self._raw.readinto(b)

    def close(self) -> None:
        self._raw.close()

    @property
    def closed(self):
        return self._raw.closed

    def __getattr__(self, name):
        return getattr(self._raw, name)


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


def _actual_size(oi) -> int:
    """The size a client sees (GetActualSize, cmd/object-api-utils.go):
    a compressed object's plain size, an encrypted one's DARE plaintext
    size, else the stored size."""
    raw = oi.user_defined.get(csse.META_ACTUAL_SIZE)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    if csse.is_encrypted(oi.user_defined):
        try:
            return csse.decrypted_size(oi.user_defined, oi.size, oi.parts)
        except Exception:  # noqa: BLE001 — corrupt metadata: stored size
            pass
    return oi.size


def _canned_acl_xml() -> bytes:
    """The one ACL the server reports: the owner's FULL_CONTROL
    (cmd/bucket-handlers.go GetBucketACLHandler)."""
    root = ET.Element("AccessControlPolicy", xmlns=S3_NS)
    ET.SubElement(ET.SubElement(root, "Owner"), "ID").text = "minio-tpu"
    grant = ET.SubElement(ET.SubElement(root, "AccessControlList"), "Grant")
    grantee = ET.SubElement(
        grant, "Grantee",
        {"xmlns:xsi": "http://www.w3.org/2001/XMLSchema-instance",
         "xsi:type": "CanonicalUser"})
    ET.SubElement(grantee, "ID").text = "minio-tpu"
    ET.SubElement(grant, "Permission").text = "FULL_CONTROL"
    return _xml(root)


def _try(fn):
    """Run a document's parser; its ValueError answers the S3 error its
    ``code`` names, MalformedXML without one."""
    try:
        return fn()
    except ValueError as e:
        raise S3Error(getattr(e, "code", "MalformedXML")) from e


class S3Server:
    """An object layer, its identities and its live config behind an HTTP
    server."""

    def __init__(self, layer, access_key: str = "minioadmin",
                 secret_key: str = "minioadmin", region: str = "us-east-1",
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_size: int = 1024 ** 3,
                 config: Config | None = None,
                 tls: CertManager | None = None):
        """``access_key``/``secret_key``: the root credential, which also
        seals config.json and iam.json.  ``config``: the live kvconfig
        (by default the layer's, read from and sealed onto its drives);
        its values reach the request plane, the layer, the commit plane
        and the heal sweep through the ``reload_*`` hooks.  ``tls``: the
        front's certificates (by default from the ``tls`` subsystem;
        None there serves plain HTTP).  IAM is not read from the drives
        until ``iam.load()``; the key service is built here
        (``kms_from_env``)."""
        self.layer = layer
        self.iam = IAMSys(layer, access_key, secret_key)
        self.config = config if config is not None else \
            Config(layer, secret=secret_key)
        self.bucket_meta = BucketMetadataSys(layer)
        self.tls = tls if tls is not None else \
            CertManager.from_config(self.config)
        if self.tls is not None:
            # the process's https clients (S3, admin, internode) take
            # this server's CA
            transport.configure(self.tls)
        self.kms = kms_from_env(layer)
        # IAM's store is etcd when the ``etcd`` subsystem names endpoints
        # (cmd/iam-etcd-store.go); the identity providers of the
        # federated STS calls; all three built here, once
        self.etcd = etcd_from_config(self.config)
        if self.etcd is not None:
            self.iam.attach_etcd(self.etcd,
                                 self.config.get("etcd", "path_prefix"))
        self.openid = _oidc.OpenIDProvider.from_config(self.config)
        ldap_cfg = _ldap.LDAPConfig.from_config(self.config)
        self.ldap = _ldap.LDAPIdentity(ldap_cfg) if ldap_cfg.enabled \
            else None
        # the remote tiers (cmd/bucket-lifecycle.go transitionObject),
        # registered at ``tiers/tiers.json`` in the system volume
        self.transition = TransitionSys(layer)
        self.transition.load()
        self.events = NotificationSys(self.bucket_meta, region=region)
        # bucket replication to remote targets: None until a target is
        # set or loaded (``start_replication``), and until then a
        # replication config's ARNs are not checked
        self.replication: ReplicationSys | None = None
        self._replication_mu = threading.Lock()
        self.region = region
        self.max_body_size = max_body_size
        self._stopping = False
        self._serving = False
        # every open connection, and those inside a request (the drain
        # of stop() waits for these only)
        self._conns: set = set()
        self._active_conns: set = set()
        self._conns_mu = threading.Lock()
        # the request pool (cmd/handler-api.go:29 maxClients)
        self._req_waiters = 0
        self._req_waiters_mu = threading.Lock()
        self._req_max = 0
        self._req_sem: threading.BoundedSemaphore | None = None
        self.reload_api_config()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        if self.tls is not None:
            enable_server_tls(self.httpd, self.tls, "s3")
        self.port = self.httpd.server_address[1]
        # bucket DNS federation (``federation`` subsystem, read once): its
        # records name the bound port
        try:
            self.federation = FederationSys.from_config(
                self.config, host or "127.0.0.1", self.port)
        except Exception:
            self.httpd.server_close()
            raise
        self._thread: threading.Thread | None = None
        # the name the admin views and the scrape give this server
        # (``run_node`` gives a cluster member its node id)
        self.node_name = f"{host}:{self.port}"
        # the last-minute per-API windows (cmd/last-minute.go)
        self.api_stats = OpWindows(self.node_name)
        # set once the server has stopped (admin service?action=stop)
        self.shutdown = threading.Event()
        # the background plane (initBackgroundHealing, initDataCrawler,
        # cmd/server-main.go): lives follow the server's
        self._background: list = []
        self.healer = None
        self.crawler = None
        self.rebalancer = None
        self.tracker = None
        # a cluster member's fan-out to its peers (``attach_peers``)
        self.peers = None
        self._deep_every_before_bitrot: int | None = None
        # the hard quota's usage view: the last persisted crawler
        # snapshot plus the writes since
        self.usage = UsageCache(layer)
        # the event targets' delivery engines: what the scrape, the admin
        # ``targets`` routes and ``stop()`` walk
        self.egress = EgressRegistry()
        # notify_* subsystem -> (the values its target was built from,
        # the target or None)
        self._notify: dict[str, tuple] = {}
        # one reload at a time: two SetConfigKV calls must not both
        # rebuild the same target
        self._egress_reload_mu = threading.Lock()
        self.reload_egress_config()
        self.reload_policy_config()

    def reload_api_config(self) -> None:
        """Take the request plane's knobs from the ``api`` subsystem:
        the request pool, its waiting line and deadline, the header and
        body deadlines, the drain of ``stop()`` and the memory governor's
        watermark."""
        cfg = self.config
        try:
            req_max = int(cfg.get("api", "requests_max") or 0)
        except ValueError:
            req_max = 0
        if req_max <= 0:
            req_max = 16 * (os.cpu_count() or 8)
        self.requests_deadline_s = parse_duration(
            cfg.get("api", "requests_deadline") or "10s")
        if req_max != self._req_max:
            # swap, never resize: a request releases the semaphore it
            # acquired (the dispatch holds on to it)
            self._req_max = req_max
            self._req_sem = threading.BoundedSemaphore(req_max)
        try:
            req_queue = int(cfg.get("api", "requests_queue") or 0)
        except ValueError:
            req_queue = 0
        self.requests_queue_max = req_queue if req_queue > 0 \
            else 2 * req_max
        self.read_header_timeout_s = parse_duration(
            cfg.get("api", "read_header_timeout") or "30s")
        self.body_deadline_s = parse_duration(
            cfg.get("api", "body_deadline") or "2m")
        try:
            self.body_min_rate_bps = int(cfg.get("api", "body_min_rate")
                                         or 0)
        except ValueError:
            self.body_min_rate_bps = 1 << 20
        self.shutdown_drain_s = parse_duration(
            cfg.get("api", "shutdown_drain_s") or "5s")
        memgov.GOVERNOR.load(cfg)
        try:
            self.select_block_bytes = max(
                64 * 1024, int(cfg.get("api", "select_block_bytes")
                               or 1 << 20))
        except ValueError:
            self.select_block_bytes = 1 << 20

    def body_budget_s(self, content_length: int) -> float:
        """The read budget of one body: ``body_deadline`` plus its
        declared size over ``body_min_rate``."""
        budget = self.body_deadline_s
        if content_length > 0 and self.body_min_rate_bps > 0:
            budget += content_length / self.body_min_rate_bps
        return budget

    # -- live config (reference s3/server.py:514, :553, :664) -------------

    def reload_pipeline_config(self) -> None:
        """Push the ``pipeline`` knobs into every erasure set."""
        for s in leaf_layers_of(self.layer):
            s.reload_pipeline_config(self.config)

    def reload_commit_config(self) -> None:
        """Push the ``commit`` knobs into the process's commit plane."""
        _commit.CONFIG.load(self.config)

    def reload_background_config(self) -> None:
        """Push the ``heal``, ``scanner`` and ``rebalance`` knobs into the
        attached background loops: ``heal.max_sleep`` is the sweep's and
        the rebalancer's pace and ``heal.bitrotscan=on`` makes every sweep
        deep (``off`` gives back the sweep's own cadence);
        ``scanner.delay`` and ``scanner.max_wait`` pace the crawler; the
        rebalancer takes ``enable``, ``max_workers`` and ``bandwidth``."""
        cfg = self.config
        try:
            bitrot = cfg.get("heal", "bitrotscan") == "on"
            pace = parse_duration(cfg.get("heal", "max_sleep") or "1s", 1.0)
            delay = float(cfg.get("scanner", "delay") or 0)
            max_wait = parse_duration(cfg.get("scanner", "max_wait")
                                      or "15s", 15.0)
        except (KeyError, ValueError):
            return
        for svc in self._background:
            if svc is self.rebalancer:
                svc.reload(cfg, pace)
                continue
            if hasattr(svc, "pace_s"):
                svc.pace_s = pace
                if bitrot and self._deep_every_before_bitrot is None:
                    self._deep_every_before_bitrot = svc.deep_every
                    svc.deep_every = 1
                elif not bitrot and \
                        self._deep_every_before_bitrot is not None:
                    svc.deep_every = self._deep_every_before_bitrot
                    self._deep_every_before_bitrot = None
            if hasattr(svc, "delay_mult"):
                svc.delay_mult = delay
                svc.max_wait_s = max_wait

    def attach_tracker(self, tracker) -> None:
        """The data-update tracker: marked on mutations, and consulted by
        every listing metacache of the layer, so a change drops a cached
        listing before its TTL (cmd/metacache-bucket.go)."""
        self.tracker = tracker
        for mc in managers_of(self.layer):
            mc.tracker = tracker

    def attach_peers(self, notifier) -> None:
        """A cluster member's peer fan-out (``parallel/peer.py``): IAM and
        bucket metadata changes reload on every node at once, and every
        write marks the peers' trackers (cmd/peer-rest-common.go:27-61).
        ``stop()`` closes it."""
        self.peers = notifier
        self.bucket_meta.on_change = notifier.bucket_meta_changed
        self.iam.on_change = notifier.iam_changed

    def reload_rpc_config(self) -> None:
        """Push the ``rpc`` streaming knobs into the process's internode
        streaming config (``parallel/rpc.py STREAM``): at a node's start
        and after a SetConfigKV of them."""
        from ..parallel.rpc import STREAM
        STREAM.load(self.config)

    def attach_background(self, *services, rebalancer=None) -> None:
        """Background loops (the crawler, the heal sweep, and a pools
        layer's ``rebalancer``) started by ``start()`` and stopped
        (their threads joined) by ``stop()``; a crawler refreshes
        ``usage`` at the end of every cycle.  The loops take the
        ``heal``, ``scanner`` and ``rebalance`` knobs at once."""
        if rebalancer is not None:
            self.rebalancer = rebalancer
            services += (rebalancer,)
        self._background.extend(services)
        for svc in services:
            if hasattr(svc, "usage_cache"):
                svc.usage_cache = self.usage
        self.reload_background_config()

    def reload_policy_config(self) -> None:
        """(Re)build the OPA webhook from the ``policy_opa`` subsystem and
        put it under ``IAMSys.is_allowed``: at construction and after a
        SetConfigKV of it.  An empty ``url`` gives local policy back; a
        value that fails to build leaves the webhook as it was."""
        try:
            self.iam.authorizer = OpaWebhook.from_config(self.config)
        except Exception:  # noqa: BLE001 — a bad value keeps the server up
            pass

    def reload_egress_config(self) -> None:
        """(Re)build the event target of each ``notify_*`` subsystem whose
        values changed since it was last built: at construction every
        one, after a SetConfigKV the one it changed (the reference
        rebuilds them all, ROADMAP Queue 3 record 55).  The target it
        replaces is closed (what it still queues goes to its store).  A
        bad config is logged and leaves no target.  The logger, audit
        and alert webhooks are not ported (ROADMAP Queue 1 item 11)."""
        with self._egress_reload_mu:
            for sub in NOTIFY_SUBSYSTEMS:
                values = self.config.get_subsys(sub)
                built_from, old = self._notify.get(sub, (None, None))
                if values == built_from:
                    continue
                if old is not None:
                    self.events.remove_target(old.arn)
                    self.egress.remove(old)
                    old.close()
                t = None
                try:
                    t = self._notify_target(sub)
                except Exception as e:  # noqa: BLE001 — a bad subsystem config
                    logging.getLogger("minio_tpu_torch").error(
                        "egress: building %s target failed: %s", sub, e)
                self._notify[sub] = (values, t)
                if t is not None:
                    self.egress.register(t)
                    self.events.register_target(t)

    def _notify_target(self, sub: str):
        """The target ``sub`` configures, None when it is not enabled."""
        cfg = self.config
        if sub != "notify_webhook":
            return target_from_config(sub[len("notify_"):], cfg)
        if cfg.get(sub, "enable") != "on":
            return None
        lim = config_queue_limit(cfg, sub, "queue_limit")
        return WebhookTarget(
            "arn:minio:sqs::1:webhook", cfg.get(sub, "endpoint"),
            auth_token=cfg.get(sub, "auth_token"),
            store_dir=cfg.get(sub, "queue_dir") or None,
            queue_limit=lim, store_limit=lim)

    def notify(self, event_name: str, bucket: str, oi,
               req_params: dict | None = None) -> None:
        """Fire a bucket event (the reference's ``notify``).  A call
        that changed the object (every event but ``s3:ObjectAccessed:*``)
        also marks the tracker, and the peers' trackers in a cluster, so
        a read keeps the cached listing."""
        if oi is not None and \
                not event_name.startswith("s3:ObjectAccessed:"):
            if self.tracker is not None:
                self.tracker.mark(bucket, getattr(oi, "name", ""))
            if self.peers is not None:
                # the peers' cached listings of the bucket go stale now
                self.peers.object_changed(bucket, getattr(oi, "name", ""))
        self.events.send(event_name, bucket, oi, req_params or {})

    def replicate(self, bucket: str, oi, delete: bool = False) -> None:
        """Queue the replication of a write (or with ``delete`` of a
        delete's result) when the bucket's config asks for it."""
        if self.replication is not None:
            self.replication.queue(bucket, oi, delete=delete)

    def start_replication(self) -> ReplicationSys:
        """The replication plane, built over this server's layer (its
        targets read from the drives) and started on first use."""
        with self._replication_mu:
            if self.replication is None:
                from .handlers_object import read_version
                repl = ReplicationSys(
                    self.layer, self.bucket_meta,
                    lambda b, k, v: read_version(self, b, k, v))
                repl.start()
                self.replication = repl
            return self.replication

    def lookup_secret(self, access_key: str) -> str | None:
        return self.iam.lookup_secret(access_key)

    def serve_forever(self) -> None:
        """Serve on this thread until ``stop()``."""
        self._serving = True
        self.httpd.serve_forever()

    def start(self) -> None:
        """Serve on a thread, and start the background loops."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="mt-s3-server")
        self._thread.start()
        self.start_background()

    def start_background(self) -> None:
        for svc in self._background:
            svc.start()

    def stop(self) -> None:
        """Stop the background loops and listening, let in-flight requests
        finish for ``shutdown_drain_s`` (idle keep-alive connections are
        cut at once), cut the rest, stop the event and replication
        workers, and close the layer (its drive
        monitor stops, its writer threads join; cmd/server-main.go's
        shutdown).  A second call returns at once; ``shutdown`` is set
        when the server has stopped."""
        with self._conns_mu:
            if self._stopping:
                return
            self._stopping = True
        for svc in self._background:
            svc.stop()
        if self._serving:
            self.httpd.shutdown()       # ends serve_forever, on any thread
        if self._thread is not None:
            self._thread.join()
        # the listener closes first: new connections are refused while
        # the requests in flight drain
        self.httpd.server_close()
        # a listener's stream ends now, not at its timeout
        self.events.pubsub.close()
        if self.shutdown_drain_s > 0:
            with self._conns_mu:
                idle = [c for c in self._conns
                        if c not in self._active_conns]
            _sever(idle)
            deadline = time.monotonic() + self.shutdown_drain_s
            while time.monotonic() < deadline:
                with self._conns_mu:
                    if not self._active_conns:
                        break
                time.sleep(0.02)
        with self._conns_mu:
            conns = list(self._conns)
        _sever(conns)
        # no event worker or sender thread outlives the server; queued
        # records go to the targets' stores
        self.events.close()
        # nor a replication worker (a task in flight finishes; tasks
        # still queued stay PENDING on the drives)
        if self.replication is not None:
            self.replication.stop()
        if self.peers is not None:
            self.peers.close()
        self.layer.close()
        self.shutdown.set()

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls is not None else "http"
        return f"{scheme}://127.0.0.1:{self.port}"


def _chain(head: bytes, chunks):
    """``head``, then every non-empty chunk of ``chunks``."""
    if head:
        yield head
    for chunk in chunks:
        if chunk:
            yield chunk


def _sever(conns) -> None:
    for c in conns:
        try:
            c.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass                        # already gone


def _api_name(method: str, bucket: str, key: str, q1: dict) -> str:
    """The S3 API name of a request, as the reference names it for its
    metrics (its route names, cmd/api-router.go)."""
    if bucket == "minio-tpu" or not bucket:
        if method == "POST" and not bucket:
            return "STS"
        return "AdminAPI" if bucket else "ListBuckets"
    sub = {"uploads": "MultipartUpload", "uploadId": "MultipartUpload",
           "tagging": "Tagging", "retention": "Retention",
           "legal-hold": "LegalHold", "select": "SelectObjectContent",
           "versioning": "Versioning", "policy": "BucketPolicy",
           "lifecycle": "BucketLifecycle", "encryption": "BucketEncryption",
           "replication": "BucketReplication", "notification":
           "BucketNotification", "object-lock": "ObjectLockConfig",
           "versions": "ListObjectVersions", "delete": "DeleteObjects"}
    feature = next((v for k, v in sub.items() if k in q1), "")
    if key:
        base = {"GET": "GetObject", "HEAD": "HeadObject",
                "PUT": "PutObject", "DELETE": "DeleteObject",
                "POST": "PostObject"}.get(method, method)
        if feature and feature != "MultipartUpload":
            return {"GET": "Get", "PUT": "Put",
                    "DELETE": "Delete"}.get(method, "") + feature \
                if feature in ("Tagging", "Retention", "LegalHold") \
                else feature
        if feature == "MultipartUpload":
            return {"POST": "CompleteMultipartUpload"
                    if "uploadId" in q1 else "CreateMultipartUpload",
                    "PUT": "UploadPart", "GET": "ListParts",
                    "DELETE": "AbortMultipartUpload"}.get(method, base)
        return base
    base = {"GET": "ListObjectsV2" if q1.get("list-type") == "2"
            else "ListObjectsV1",
            "HEAD": "HeadBucket", "PUT": "MakeBucket",
            "DELETE": "DeleteBucket", "POST": "PostPolicyBucket"}
    if feature:
        return ({"GET": "Get", "PUT": "Put", "DELETE": "Delete"}
                .get(method, "") + feature) \
            if feature.startswith("Bucket") or feature == "Versioning" \
            else feature
    return base.get(method, method)


def _make_handler(srv: S3Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "MinioTPU"

        def setup(self):
            # the socket timeout covers the request line, the headers
            # and keep-alive idle (0: none; a zero socket timeout would
            # make the socket non-blocking); the rfile wrapper adds each
            # body's absolute budget, armed in _dispatch
            self.timeout = srv.read_header_timeout_s or None
            if srv.tls is not None:
                # the handshake the accept loop deferred, in this thread
                # and under the header deadline
                srv.tls.handshake(self.request, "s3", self.timeout)
            super().setup()
            self.rfile = _DeadlineRFile(self.rfile, self.connection,
                                        self.timeout)
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
            ``self.access_key``, empty for an anonymous request, and
            checks an STS session's token."""
            self._query_token = query.get("X-Amz-Security-Token", [""])[0]
            out = self._auth_inner(path, query, payload)
            self._check_session_token()
            return out

        def _auth_inner(self, path, query, payload: bytes) -> bytes:
            lookup = srv.iam.lookup_secret
            hdrs = dict(self.headers.items())
            try:
                if "Authorization" not in hdrs and \
                        "X-Amz-Signature" not in query and \
                        not ("Signature" in query and
                             "AWSAccessKeyId" in query):
                    # anonymous: only a bucket policy may grant it
                    self.access_key = ""
                    sha = self.headers.get("x-amz-content-sha256")
                    if sha and sha != sigv4.UNSIGNED_PAYLOAD and \
                            hashlib.sha256(payload).hexdigest() != sha:
                        raise S3Error("BadDigest")
                    return payload
                if hdrs.get("Authorization", "").startswith("AWS "):
                    self.access_key = sigv2.verify_request(
                        lookup, self.command, path, query, hdrs)
                    return payload
                if "Signature" in query and "AWSAccessKeyId" in query:
                    self.access_key = sigv2.verify_presigned(
                        lookup, self.command, path, query, hdrs)
                    return payload
                if "X-Amz-Signature" in query:
                    self.access_key = sigv4.verify_presigned(
                        lookup, self.command, path, query, hdrs,
                        region=srv.region)
                    return payload
                sha = self.headers.get("x-amz-content-sha256",
                                       sigv4.UNSIGNED_PAYLOAD)
                if sha == sigv4.STREAMING_PAYLOAD:
                    self.access_key, key, seed, amz_date, scope = \
                        sigv4.verify_request_streaming(
                            lookup, self.command, path, query, hdrs,
                            region=srv.region)
                    return sigv4.decode_chunked_payload(
                        payload, key, seed, amz_date, scope)
                if sha != sigv4.UNSIGNED_PAYLOAD and \
                        hashlib.sha256(payload).hexdigest() != sha:
                    raise S3Error("BadDigest")
                self.access_key = sigv4.verify_request(
                    lookup, self.command, path, query, hdrs, sha,
                    region=srv.region)
                return payload
            except sigv4.SigV4Error as e:
                raise S3Error(e.code) from e

        def _check_session_token(self):
            """An STS session presents its token on every request, signed
            by the root secret and naming the session's key
            (checkClaimsFromToken, cmd/auth-handler.go)."""
            if not self.access_key:
                return
            try:
                u = srv.iam.get_user(self.access_key)
            except Exception:  # noqa: BLE001 — root or unknown: no token
                return
            if not (u.parent_user and u.expiration):
                return
            tok = self.headers.get("x-amz-security-token", "") or \
                self._query_token
            if not tok:
                raise S3Error("AccessDenied")
            try:
                claims = _sts.verify_token(tok, srv.iam.root.secret_key)
            except _sts.STSError as e:
                raise S3Error("ExpiredToken" if e.code == "ExpiredToken"
                              else "AccessDenied") from e
            if claims.get("accessKey") != self.access_key:
                raise S3Error("AccessDenied")

        def _allow(self, action: str, resource: str = "") -> None:
            """Authorise the request's key for an S3 action on
            ``bucket[/key]`` (checkRequestAuthType): the bucket policy
            first, where an explicit Deny refuses and an Allow grants,
            anonymous callers too (an STS session still within its
            session policy); then IAM."""
            bucket = resource.split("/", 1)[0]
            # a bucket document speaks for s3: actions only, never admin:*
            if bucket and action.startswith("s3:"):
                try:
                    pol = srv.bucket_meta.get_bucket_policy(bucket)
                    verdict = pol.is_allowed(self.access_key, action,
                                             resource) \
                        if pol is not None else None
                except Exception as e:  # noqa: BLE001 — fail closed: an
                    # unreadable policy must not drop its Denies
                    raise S3Error("AccessDenied") from e
                if verdict is False:
                    raise S3Error("AccessDenied")
                if verdict is True:
                    if srv.iam.session_policy_allows(self.access_key,
                                                     action, resource):
                        return
                    raise S3Error("AccessDenied")
            if not self.access_key or \
                    not srv.iam.is_allowed(self.access_key, action,
                                           resource):
                raise S3Error("AccessDenied")

        def _send_prologue(self, status: int, sent_bytes: int,
                           entity_len: int | None, content_type: str,
                           headers: dict | None):
            """The status line and headers; counts the response
            (``sent_bytes``: its body's length, counted as the reference
            counts it, a HEAD's unsent body too) and takes the time to
            its first byte.  ``entity_len`` None: a chunked body."""
            m = _metrics.GLOBAL
            m.inc("mt_s3_requests_total",
                  {"method": self.command, "status": str(status)})
            m.inc("mt_s3_tx_bytes_total", value=sent_bytes)
            self._resp_status = status
            self._resp_bytes += sent_bytes
            if not self._ttfb_ns:
                self._ttfb_ns = time.monotonic_ns() - self._t0_ns
            self.send_response(status)
            self.send_header("x-amz-request-id", self._req_id)
            self.send_header("Server", "MinioTPU")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", content_type)
            if entity_len is None:
                self.send_header("Transfer-Encoding", "chunked")
            else:
                self.send_header("Content-Length", str(entity_len))
            self.end_headers()

        def _send(self, status: int, body: bytes = b"",
                  content_type: str = "application/xml",
                  headers: dict | None = None,
                  content_length: int | None = None):
            """``content_length``: the entity's length for a HEAD, whose
            body is not sent."""
            self._send_prologue(
                status, len(body), len(body) if content_length is None
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
            self._send_prologue(status, total, total, content_type,
                                headers)
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

        def _send_chunked(self, status: int, chunks, content_type: str,
                          headers: dict | None = None, head: bytes = b""):
            """Send a body of unknown length with chunked transfer
            encoding (a Select's event stream, whose length is known only
            when the scan ends): ``head`` first, then each chunk as it
            comes.  A failure after the status line drops the connection:
            the missing last chunk tells the client the body is short."""
            self._send_prologue(status, 0, None, content_type, headers)
            sent = 0
            try:
                for chunk in _chain(head, chunks):
                    self.wfile.write(b"%x\r\n" % len(chunk) + chunk
                                     + b"\r\n")
                    sent += len(chunk)
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (ConnectionError, TimeoutError):
                self.close_connection = True
                raise
            except Exception:   # noqa: BLE001 — the status line is out
                self.close_connection = True
            finally:
                _metrics.GLOBAL.inc("mt_s3_tx_bytes_total", value=sent)
                self._resp_bytes += sent
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()

        def _fail(self, e: Exception, resource: str = ""):
            if isinstance(e, memgov.MemoryPressure):
                # the governor shed: 503 with Retry-After, as a full
                # request pool answers
                api = s3err.get("SlowDown")
                return self._send(
                    api.http_status,
                    s3err.to_xml(api, resource, self._req_id),
                    headers={"Retry-After":
                             str(max(1, int(e.retry_after_s)))})
            if isinstance(e, S3Error):
                api = e.api
            elif isinstance(e, (sigv4.SigV4Error, csse.SSEError)):
                api = s3err.get(e.code)
            elif isinstance(e, ol.ObjectLayerError):
                api = s3err.from_object_error(e)
            elif isinstance(e, (LockTimeout, LockLost)):
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
            self._query_token = ""
            self._t0_ns = time.monotonic_ns()
            self._ttfb_ns = 0
            self._resp_status = 0
            self._resp_bytes = 0
            self._rx_bytes = 0
            # the request pool admits S3 traffic only: the admin, metrics
            # and health paths stay reachable when it is full.  The
            # semaphore is captured: a live requests_max swaps it, and
            # acquire and release must pair on one object
            throttled = not urllib.parse.urlsplit(self.path).path \
                .startswith(("/minio-tpu/", "/minio/"))
            sem = srv._req_sem if throttled else None
            if sem is not None and not self._admit(sem):
                try:
                    api = s3err.get("SlowDown")
                    self._send(api.http_status,
                               s3err.to_xml(api, self.path, self._req_id),
                               headers={"Retry-After": str(max(
                                   1, int(srv.requests_deadline_s)))})
                finally:
                    self.close_connection = True
                    self._record_request()
                return
            # the body's absolute read budget, scaled by its declared size
            try:
                cl = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                cl = 0
            self.rfile.arm(srv.body_budget_s(cl))
            try:
                self._dispatch_inner()
            except (ConnectionError, TimeoutError):
                # the client died mid-body or mid-response
                self.close_connection = True
            finally:
                self.rfile.disarm()
                if sem is not None:
                    sem.release()
                self._record_request()
            if srv._stopping:
                self.close_connection = True

        def _admit(self, sem) -> bool:
            """Wait up to ``requests_deadline`` for a slot, but only while
            the waiting line is shorter than ``requests_queue``: a full
            line sheds at once (cmd/handler-api.go:29-40)."""
            with srv._req_waiters_mu:
                if srv._req_waiters >= srv.requests_queue_max:
                    return False
                srv._req_waiters += 1
            try:
                return sem.acquire(timeout=srv.requests_deadline_s)
            finally:
                with srv._req_waiters_mu:
                    srv._req_waiters -= 1

        def _handle(self):
            """The drain of ``stop()`` waits for connections inside this
            window, and only for them."""
            with srv._conns_mu:
                srv._active_conns.add(self.connection)
            try:
                self._dispatch()
            finally:
                with srv._conns_mu:
                    srv._active_conns.discard(self.connection)

        def _record_request(self):
            """The per-API families and windows, for S3 APIs only: the
            health probes, the admin API and the scrape (the
            ``/minio-tpu/`` and ``/minio/`` paths) do not count
            (reference s3/server.py:1497-1530)."""
            path, bucket, key, query = self._split()
            if path.startswith(("/minio-tpu/", "/minio/")):
                return
            dur_ns = time.monotonic_ns() - self._t0_ns
            api = _api_name(self.command, bucket, key,
                            {k: v[0] for k, v in query.items()})
            m = _metrics.GLOBAL
            m.inc("mt_s3_requests_api_total", {"api": api})
            if self._resp_status >= 400:
                m.inc("mt_s3_requests_errors_total",
                      {"api": api, "status": str(self._resp_status)})
            m.observe("mt_s3_ttfb_seconds", {"api": api},
                      (self._ttfb_ns or dur_ns) / 1e9)
            srv.api_stats.record(api, dur_ns,
                                 self._rx_bytes + self._resp_bytes)

        def _dispatch_inner(self):
            path, bucket, key, query = self._split()
            try:
                # SSE-C needs TLS, as on AWS: a client key sent in the
                # clear is already leaked, so it is refused before
                # anything reads it (ErrInsecureSSECustomerRequest)
                if srv.tls is None and (
                        csse.SSEC_ALGO in self.headers
                        or csse.SSEC_COPY_ALGO in self.headers):
                    raise S3Error("InsecureSSECustomerRequest")
                if path.startswith(("/minio-tpu/health/",
                                    "/minio/health/")):
                    # unauthenticated probes (cmd/healthcheck-router.go)
                    self._body()
                    return self._health_api(path, query)
                if path == admin_handlers.METRICS_PATH:
                    # the public scrape, GET only
                    self._body()
                    if self.command != "GET":
                        raise S3Error("MethodNotAllowed")
                    return admin_handlers.handle(self, srv, path, query,
                                                 b"")
                if self._try_stream_put(path, bucket, key, query):
                    return
                payload = self._body()
                self._rx_bytes = len(payload)
                _metrics.GLOBAL.inc("mt_s3_rx_bytes_total",
                                    value=len(payload))
                payload = self._auth(path, query, payload)
                if path.startswith("/minio-tpu/"):
                    if admin_handlers.handle(self, srv, path, query,
                                             payload):
                        return
                    # the web UI, ROADMAP Queue 1 item 16.9
                    raise S3Error("NotImplemented")
                if bucket in RESERVED_BUCKETS:
                    # isMinioReservedBucket (cmd/generic-handlers.go)
                    raise S3Error("AccessDenied")
                if not bucket:
                    if self.command == "POST":
                        return self._sts_api(payload)
                    return self._list_buckets()
                if not _BUCKET_RE.match(bucket):
                    raise S3Error("InvalidBucketName")
                try:
                    if key:
                        return self._object_api(bucket, key, query,
                                                payload)
                    return self._bucket_api(bucket, query, payload)
                except ol.BucketNotFound:
                    # a federated bucket homed on another server: 307 to
                    # its owner, in this front's scheme
                    # (cmd/handler-utils.go's redirect)
                    rec = srv.federation.lookup_other(bucket) \
                        if srv.federation is not None else None
                    if rec is None:
                        raise
                    u = urllib.parse.urlsplit(self.path)
                    scheme = "https" if srv.tls is not None else "http"
                    loc = (f"{scheme}://{rec.host}:{rec.port}{u.path}"
                           + (f"?{u.query}" if u.query else ""))
                    return self._send(307, b"", headers={"Location": loc})
            except ConnectionError:
                raise                   # nobody left to answer
            except Exception as e:  # noqa: BLE001 — every error is XML
                self._fail(e, path)

        # any method, PATCH and OPTIONS too, answers S3 XML, never the
        # stdlib's plain 501
        do_GET = do_PUT = do_HEAD = do_DELETE = do_POST = do_PATCH = \
            do_OPTIONS = lambda self: self._handle()

        # -- STS (cmd/sts-handlers.go) -----------------------------------

        def _sts_fail(self, code: str, msg: str = ""):
            root = ET.Element("ErrorResponse", xmlns=STS_NS)
            err = ET.SubElement(root, "Error")
            ET.SubElement(err, "Type").text = "Sender"
            ET.SubElement(err, "Code").text = code
            ET.SubElement(err, "Message").text = msg or code
            status = 403 if code in ("AccessDenied", "ExpiredToken") \
                else 400
            self._send(status, _xml(root))

        def _sts_api(self, payload: bytes):
            """AssumeRole (cmd/sts-handlers.go:205): a signed request
            gets temporary credentials of its own key, within the form's
            ``Policy``.  AssumeRoleWithWebIdentity (and
            AssumeRoleWithClientGrants) and AssumeRoleWithLDAPIdentity
            need no signature: the token or the password is the
            credential.  Without a provider configured they answer
            NotImplemented."""
            form = {k: v[0] for k, v in urllib.parse.parse_qs(
                payload.decode("utf-8", "replace"),
                keep_blank_values=True).items()}
            action = form.get("Action", "")
            if action in ("AssumeRoleWithWebIdentity",
                          "AssumeRoleWithClientGrants"):
                return self._sts_web_identity(form, action)
            if action == "AssumeRoleWithLDAPIdentity":
                return self._sts_ldap_identity(form)
            if action != "AssumeRole":
                return self._sts_fail("InvalidAction", action)
            if not self.access_key:
                return self._sts_fail("AccessDenied",
                                      "request must be signed")
            try:
                duration = int(form.get("DurationSeconds",
                                        str(_sts.DEFAULT_DURATION_S)))
            except ValueError:
                return self._sts_fail("InvalidParameterValue",
                                      "DurationSeconds")
            try:
                creds = srv.iam.assume_role(self.access_key, duration,
                                            form.get("Policy") or None)
            except _sts.STSError as e:
                return self._sts_fail(e.code, str(e))
            root = ET.Element("AssumeRoleResponse", xmlns=STS_NS)
            result = ET.SubElement(root, "AssumeRoleResult")
            self._sts_answer(root, result, creds)

        def _sts_ldap_identity(self, form: dict):
            """AssumeRoleWithLDAPIdentity (cmd/sts-handlers.go:436): the
            directory checks the username and password, and the session
            carries the policies mapped to the user's DN and groups."""
            if srv.ldap is None or not srv.ldap.config.enabled:
                return self._sts_fail(
                    "NotImplemented",
                    "no LDAP provider configured (identity_ldap)")
            username = form.get("LDAPUsername", "")
            password = form.get("LDAPPassword", "")
            if not username or not password:
                return self._sts_fail(
                    "MissingParameter",
                    "LDAPUsername and LDAPPassword cannot be empty")
            policy = form.get("Policy") or None
            if policy and len(policy) > 2048:
                return self._sts_fail(
                    "InvalidParameterValue",
                    "session policy exceeds 2048 characters")
            try:
                duration = int(form.get(
                    "DurationSeconds", str(srv.ldap.config.sts_expiry_s)))
            except ValueError:
                return self._sts_fail("InvalidParameterValue",
                                      "DurationSeconds")
            try:
                user_dn, groups = srv.ldap.bind(username, password)
            except _ldap.LDAPError as e:
                return self._sts_fail("InvalidParameterValue",
                                      f"LDAP server error: {e}")
            try:
                creds = srv.iam.assume_role_ldap_identity(
                    user_dn, username, groups, duration,
                    session_policy=policy)
            except _sts.STSError as e:
                return self._sts_fail(e.code, str(e))
            except Exception as e:  # noqa: BLE001 — as the reference answers
                return self._sts_fail("InvalidParameterValue", str(e))
            root = ET.Element("AssumeRoleWithLDAPIdentityResponse",
                              xmlns=STS_NS)
            result = ET.SubElement(root, "AssumeRoleWithLDAPIdentityResult")
            self._sts_answer(root, result, creds)

        def _sts_web_identity(self, form: dict, action: str):
            """AssumeRoleWithWebIdentity (cmd/sts-handlers.go): the
            provider's JWT checks out, and the session carries the
            policies of its claim."""
            if srv.openid is None:
                return self._sts_fail(
                    "NotImplemented",
                    "no OpenID provider configured (identity_openid)")
            token = form.get("WebIdentityToken") or form.get("Token", "")
            if not token:
                return self._sts_fail("InvalidParameterValue",
                                      "WebIdentityToken required")
            try:
                duration = int(form.get("DurationSeconds",
                                        str(_sts.DEFAULT_DURATION_S)))
            except ValueError:
                return self._sts_fail("InvalidParameterValue",
                                      "DurationSeconds")
            try:
                claims = srv.openid.authenticate(token)
            except _oidc.OpenIDError as e:
                return self._sts_fail("AccessDenied", str(e))
            policies = srv.openid.policies_of(claims)
            if not policies:
                return self._sts_fail(
                    "AccessDenied",
                    f"token carries no {srv.openid.claim_name!r} claim")
            try:
                creds = srv.iam.assume_role_web_identity(
                    claims["sub"], policies, duration)
            except NoSuchPolicy as e:
                return self._sts_fail("AccessDenied",
                                      f"unknown policy: {e}")
            except _sts.STSError as e:
                return self._sts_fail(e.code, str(e))
            root = ET.Element(f"{action}Response", xmlns=STS_NS)
            result = ET.SubElement(root, f"{action}Result")
            self._sts_answer(root, result, creds,
                             subject=claims["sub"])

        def _sts_answer(self, root, result, creds, subject=None):
            """The credentials under ``result`` (and the web identity's
            subject), the request id, 200."""
            ce = ET.SubElement(result, "Credentials")
            ET.SubElement(ce, "AccessKeyId").text = creds.access_key
            ET.SubElement(ce, "SecretAccessKey").text = creds.secret_key
            ET.SubElement(ce, "SessionToken").text = creds.session_token
            ET.SubElement(ce, "Expiration").text = \
                datetime.datetime.fromtimestamp(
                    creds.expiration, datetime.timezone.utc).strftime(
                        "%Y-%m-%dT%H:%M:%SZ")
            if subject is not None:
                ET.SubElement(result, "SubjectFromWebIdentityToken").text = \
                    subject
            meta = ET.SubElement(root, "ResponseMetadata")
            ET.SubElement(meta, "RequestId").text = uuid.uuid4().hex[:16]
            self._send(200, _xml(root))

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

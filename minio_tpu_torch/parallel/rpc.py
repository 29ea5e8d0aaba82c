"""The internode RPC plane (``minio_tpu/parallel/rpc.py``,
cmd/rest/client.go:174, cmd/storage-rest-server.go).

One endpoint per call, ``POST /rpc/<service>/<method>``, with a msgpack
body of keyword arguments and a msgpack reply ``{"ok", "result"}`` or
``{"ok": False, "error_type", "message"}``; an HMAC bearer token is
minted per request over the path and a timestamp (cmd/jwt.go:161).  Bulk
shard bytes ride ``POST /raw/<name>`` instead: the parameters in the
``X-RPC-Params`` header (msgpack, hex), the bytes as the body, raw bytes
back (errors as status 400 and the error document).  A body longer than
``rpc.stream_chunk_bytes`` rides one POST as length-prefixed frames the
peer applies as they land (``X-RPC-Stream: frames[+trailer]``):

    frame   := u32be length | payload        (length >= 1)
    end     := u32be 0
    trailer := u32be length | payload        (+trailer only: one msgpack
                                              document after the end)
    abort   := u32be 0xFFFFFFFF              (the sender gave up: the
                                              receiver drops what landed)

A streamed raw reply keeps its Content-Length and is written chunk by
chunk (``X-RPC-Stream: resp``).  The wire is the reference's, byte for
byte, with the port's own msgpack codec (``storage/msgpack_codec.py``),
so a port node and a ``minio_tpu`` node talk to each other.

The client keeps a pool of keep-alive connections per peer, replays a
call whose pooled connection turned out stale, trips a per-peer circuit
breaker on transport failures, retries idempotent calls under the shared
``utils/retry.py`` policy, and sizes each service's deadline from its
observed latencies (``DynamicTimeout``).

Given a ``CertManager`` (``RPCServer(tls=)``), the server serves the
internode identity and requires a client certificate from its CA; each
accepted socket is wrapped on the accept loop and its handshake completed
on the handler thread under the idle deadline.  A client of an
``https://`` endpoint takes its context (the CA and the internode
identity) from ``secure/transport.py``; a failed or cut handshake is a
transport failure like any other.  Left for later: the request-id and
span headers of the tracing plane (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import socket
import ssl
import struct
import threading
import time
import urllib.parse
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..admin import metrics as _metrics
from ..storage import msgpack_codec as msgpack

TOKEN_WINDOW_S = 15 * 60

_F_END = struct.pack(">I", 0)
_F_ABORT = struct.pack(">I", 0xFFFFFFFF)
_F_ABORT_N = 0xFFFFFFFF
# one frame may never make the receiver hold more than this (honest
# senders frame at rpc.stream_chunk_bytes)
MAX_FRAME_BYTES = 64 << 20


class StreamConfig:
    """The ``rpc`` streaming knobs (``stream_enable``,
    ``stream_chunk_bytes``), process-wide; read lazily from the
    environment and defaults, and pushed by ``S3Server.reload_rpc_config``
    after a SetConfigKV."""

    def __init__(self):
        self.enable = True
        self.chunk_bytes = 1 << 20
        self._loaded = False

    def load(self, cfg=None) -> None:
        try:
            if cfg is None:
                from ..utils.kvconfig import Config
                cfg = Config()
            self.enable = str(cfg.get("rpc", "stream_enable")
                              ).strip().lower() not in ("off", "0",
                                                        "false", "")
            self.chunk_bytes = max(
                4096, int(cfg.get("rpc", "stream_chunk_bytes")))
        except (KeyError, ValueError):
            pass
        self._loaded = True

    def chunk(self) -> int:
        """The streaming threshold and slice size; 0 when off."""
        if not self._loaded:
            self.load()
        return self.chunk_bytes if self.enable else 0


STREAM = StreamConfig()


class Iovecs:
    """A request body of several buffers sent without joining them:
    ``len()`` is the total (stamped into Content-Length), iteration
    yields the buffers; re-iterable, so a replay resends them."""

    __slots__ = ("bufs", "total")

    def __init__(self, bufs):
        self.bufs = [b if isinstance(b, (bytes, bytearray))
                     else memoryview(b).cast("B") for b in bufs]
        self.total = sum(len(b) for b in self.bufs)

    def __len__(self) -> int:
        return self.total

    def __iter__(self):
        return iter(self.bufs)


class StreamBody:
    """A framed request body: ``chunks_fn`` returns a fresh iterator of
    buffers per attempt; ``trailer_fn``, when set, is called after the
    last frame went out and returns the trailer's msgpack bytes (if it
    raises, the abort marker goes out instead and the error reaches the
    caller).  ``sent`` and ``frames`` count the last attempt's wire
    bytes and frames."""

    __slots__ = ("chunks_fn", "trailer_fn", "sent", "frames")

    def __init__(self, chunks_fn, trailer_fn=None):
        self.chunks_fn = chunks_fn
        self.trailer_fn = trailer_fn
        self.sent = 0
        self.frames = 0


class StreamAborted(Exception):
    """The sender aborted a framed stream."""


class _GateAbort(Exception):
    """A trailer_fn raised after the abort marker went out; carries its
    exception past the transport-error triage."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause_exc = cause


def _read_exact(rfile, n: int) -> bytes:
    buf = rfile.read(n)
    if len(buf) != n:
        raise ConnectionError(
            f"truncated stream frame ({len(buf)}/{n} bytes)")
    return buf


class FrameReader:
    """The server's view of a framed body: iterate the data frames, then
    (in +trailer mode) ``read_trailer()``.  It consumes the wire exactly,
    so the connection stays in step for keep-alive; an abort marker
    raises StreamAborted from the read that meets it."""

    def __init__(self, rfile, trailer: bool = False):
        self._rfile = rfile
        self._trailer_done = not trailer
        self._ended = False
        self.aborted = False
        self.frames = 0
        self.bytes = 0

    def _next_len(self) -> int:
        n = struct.unpack(">I", _read_exact(self._rfile, 4))[0]
        if n == _F_ABORT_N:
            self.aborted = True
            self._ended = True
            raise StreamAborted("stream aborted by sender")
        if n > MAX_FRAME_BYTES:
            raise ConnectionError(f"oversized stream frame ({n} bytes)")
        return n

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._ended:
            raise StopIteration
        n = self._next_len()
        if n == 0:
            self._ended = True
            raise StopIteration
        self.frames += 1
        self.bytes += n
        return _read_exact(self._rfile, n)

    def read_trailer(self) -> bytes:
        """The trailer document (data frames left unread are drained
        first)."""
        for _ in self:
            pass
        self._trailer_done = True
        return _read_exact(self._rfile, self._next_len())

    def drain(self) -> None:
        """Consume what the sender still has in flight, so the error
        reply can go out on a connection in step."""
        try:
            for _ in self:
                pass
            if not self._trailer_done and not self.aborted:
                self._trailer_done = True
                _read_exact(self._rfile, self._next_len())
        except StreamAborted:
            pass

    def in_sync(self) -> bool:
        return self._ended and (self._trailer_done or self.aborted)


def sever_connections(conns) -> None:
    """Cut server-side sockets at once (SHUT_RDWR: a handler parked on a
    keep-alive read returns)."""
    for c in conns:
        try:
            c.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            c.close()
        except OSError:
            pass


class RPCError(Exception):
    def __init__(self, error_type: str, message: str):
        super().__init__(f"{error_type}: {message}")
        self.error_type = error_type
        self.message = message


class CircuitBreaker:
    """The per-peer breaker (cmd/rest/client.go HealthCheckFn role):
    ``fail_max`` consecutive transport failures open it; while open every
    call fails fast; after ``cooldown_s`` one caller goes through as the
    half-open probe, whose success closes it and whose failure opens it
    for another cooldown.  Application errors are not recorded.  Every
    breaker is listed in a weak registry (``breaker_states``) and every
    opening counts in ``BREAKER_OPEN_COUNT`` and
    ``mt_node_rpc_breaker_opens_total``."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, fail_max: int = 3, cooldown_s: float = 3.0,
                 clock=time.monotonic, label: str = ""):
        self.fail_max = max(1, int(fail_max))
        self.cooldown_s = cooldown_s
        self.label = label
        self._clock = clock
        self._mu = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opens = 0
        _BREAKERS.add(self)

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def ready(self) -> bool:
        """Whether a call could go through now (it does not take the
        half-open probe)."""
        with self._mu:
            if self._state != self.OPEN:
                return True
            return self._clock() - self._opened_at >= self.cooldown_s

    def allow(self) -> bool:
        """Admit one call; in half-open only the probe."""
        with self._mu:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and \
                    self._clock() - self._opened_at >= self.cooldown_s:
                self._state = self.HALF_OPEN
                self._probing = False
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._mu:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        opened = False
        with self._mu:
            if self._state == self.HALF_OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False
                self.opens += 1
                opened = True
            else:
                self._failures += 1
                if self._state == self.CLOSED and \
                        self._failures >= self.fail_max:
                    self._state = self.OPEN
                    self._opened_at = self._clock()
                    self.opens += 1
                    opened = True
        if opened:
            global BREAKER_OPEN_COUNT
            BREAKER_OPEN_COUNT += 1
            _metrics.GLOBAL.inc("mt_node_rpc_breaker_opens_total")


_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()
BREAKER_OPEN_COUNT = 0


def breaker_states() -> list[dict]:
    """Every live breaker's state, by endpoint."""
    out = []
    for b in list(_BREAKERS):
        out.append({"endpoint": b.label, "state": b.state,
                    "opens": b.opens})
    out.sort(key=lambda r: r["endpoint"])
    return out


def mint_token(secret: str, path: str, now: float | None = None) -> str:
    ts = str(int(now if now is not None else time.time()))
    mac = hmac.new(secret.encode(), f"{ts}:{path}".encode(),
                   hashlib.sha256).hexdigest()
    return f"{ts}.{mac}"


def check_token(secret: str, path: str, token: str,
                now: float | None = None) -> bool:
    try:
        ts, mac = token.split(".", 1)
        age = abs((now if now is not None else time.time()) - int(ts))
    except ValueError:
        return False
    if age > TOKEN_WINDOW_S:
        return False
    want = hmac.new(secret.encode(), f"{ts}:{path}".encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, mac)


def _nodelay(sock) -> None:
    """Nagle's algorithm off: a request's headers and body (and a reply's)
    go out in separate writes, and the peer's delayed ACK would hold the
    second ~40 ms (ROADMAP Queue 3 record 62)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


class _Connection(http.client.HTTPConnection):
    def connect(self):
        super().connect()
        _nodelay(self.sock)


class _HTTPServer(ThreadingHTTPServer):
    """A threading server that keeps its handler threads, so ``stop``
    can join them."""

    daemon_threads = True

    def __init__(self, *a, **kw):
        self.handlers: set[threading.Thread] = set()
        self.handlers_mu = threading.Lock()
        super().__init__(*a, **kw)

    def process_request(self, request, client_address):
        def run():
            try:
                self.process_request_thread(request, client_address)
            finally:
                with self.handlers_mu:
                    self.handlers.discard(threading.current_thread())
        t = threading.Thread(target=run, daemon=True, name="mt-rpc-handler")
        with self.handlers_mu:
            self.handlers.add(t)
        t.start()

    def handle_error(self, request, client_address):
        # severed peers and failed handshakes (counted where they fail)
        # are routine on this plane; keep the stock traceback for
        # anything else
        import sys
        if isinstance(sys.exc_info()[1],
                      (ConnectionError, TimeoutError, ssl.SSLError)):
            return
        super().handle_error(request, client_address)


class RPCServer:
    """The registry and listener of a node's services."""

    # a peer that stops talking cannot park a handler thread for good
    # (cmd/http/server.go:185)
    IDLE_TIMEOUT_S = 60.0

    def __init__(self, secret: str, host: str = "127.0.0.1", port: int = 0,
                 tls=None):
        """``tls``: a ``secure.certs.CertManager``; the listener then
        serves mutual TLS on the ``internode`` plane."""
        self.secret = secret
        self.tls = tls
        self._services: dict[str, dict] = {}
        self._raw: dict = {}
        self._raw_stream: dict = {}
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        self.httpd = _HTTPServer((host, port), self._make_handler())
        if tls is not None:
            from ..secure.certs import enable_server_tls
            enable_server_tls(self.httpd, tls, "internode")
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        # set by stop(): helper loops tied to this server end with it
        self.stopped = threading.Event()
        # bootstrap liveness (cmd/bootstrap-peer-server.go)
        self.register("sys", {"ping": lambda: "pong"})

    def register(self, service: str, methods: dict) -> None:
        self._services.setdefault(service, {}).update(methods)

    def register_raw(self, name: str, fn) -> None:
        """``POST /raw/<name>``: ``fn(params, data) -> bytes``, or
        ``(total, iterator)`` for a reply written chunk by chunk."""
        self._raw[name] = fn

    def register_raw_stream(self, name: str, fn) -> None:
        """The framed twin of a raw endpoint: ``fn(params, frames)``
        with a ``FrameReader``."""
        self._raw_stream[name] = fn

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="mt-rpc-server")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop listening, cut every connection and join the listener
        and handler threads."""
        self.stopped.set()
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout)
        with self._conns_mu:
            conns = list(self._conns)
        sever_connections(conns)
        self.httpd.server_close()
        deadline = time.monotonic() + timeout
        while True:
            with self.httpd.handlers_mu:
                handlers = list(self.httpd.handlers)
            if not handlers:
                return
            handlers[0].join(max(0.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                return

    def _make_handler(srv_self):
        services = srv_self._services
        raw = srv_self._raw
        raw_stream = srv_self._raw_stream
        secret = srv_self.secret

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = srv_self.IDLE_TIMEOUT_S

            def setup(self):
                # listed before the handshake, so stop() cuts one that
                # stalls
                with srv_self._conns_mu:
                    srv_self._conns.add(self.request)
                if srv_self.tls is not None:
                    # the handshake the accept loop deferred, here and
                    # under the idle deadline; a failure ends only this
                    # connection
                    try:
                        srv_self.tls.handshake(self.request, "internode",
                                               timeout=self.timeout)
                    except BaseException:
                        with srv_self._conns_mu:
                            srv_self._conns.discard(self.request)
                        raise
                super().setup()
                _nodelay(self.connection)

            def finish(self):
                try:
                    super().finish()
                finally:
                    with srv_self._conns_mu:
                        srv_self._conns.discard(self.connection)

            def log_message(self, fmt, *args):
                pass

            def _reply(self, status: int, doc: dict):
                body = msgpack.packb(doc)
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Content-Type", "application/msgpack")
                self.end_headers()
                self.wfile.write(body)

            def _reply_raw(self, data):
                if isinstance(data, tuple):
                    return self._reply_raw_streamed(*data)
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                self.wfile.write(data)
                return len(data)

            def _reply_raw_streamed(self, total: int, it):
                """A raw reply of known length written as the iterator
                yields.  A source that fails part way cannot honour the
                length: the connection closes, and the client sees a
                short body (a transport error)."""
                self.send_response(200)
                self.send_header("Content-Length", str(total))
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-RPC-Stream", "resp")
                self.end_headers()
                sent = 0
                try:
                    for chunk in it:
                        self.wfile.write(chunk)
                        sent += len(chunk)
                except Exception:  # noqa: BLE001 — the status is out
                    pass
                finally:
                    if sent != total:
                        self.close_connection = True
                return sent

            def _error_doc(self, e: Exception) -> dict:
                return {"ok": False, "error_type": type(e).__name__,
                        "message": str(e)}

            def do_POST(self):
                path = urllib.parse.urlsplit(self.path).path
                auth = self.headers.get("Authorization", "")
                if not (auth.startswith("Bearer ") and
                        check_token(secret, path, auth[7:])):
                    # the body is unread: the connection cannot be reused
                    self.close_connection = True
                    return self._reply(403, {"ok": False,
                                             "error_type": "AuthError",
                                             "message": "bad token"})
                parts = path.strip("/").split("/")
                if len(parts) >= 2 and parts[0] == "raw":
                    return self._do_raw(parts[1])
                if len(parts) != 3 or parts[0] != "rpc":
                    self.close_connection = True
                    return self._reply(404, {"ok": False,
                                             "error_type": "NotFound",
                                             "message": path})
                fn = services.get(parts[1], {}).get(parts[2])
                if fn is None:
                    self.close_connection = True
                    return self._reply(404, {"ok": False,
                                             "error_type": "NoSuchMethod",
                                             "message": path})
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    kwargs = msgpack.unpackb(self.rfile.read(n)) if n else {}
                    result = fn(**kwargs)
                    self._reply(200, {"ok": True, "result": result})
                except Exception as e:  # noqa: BLE001 — typed on the wire
                    self._reply(200, self._error_doc(e))

            def _params(self) -> dict:
                return msgpack.unpackb(bytes.fromhex(
                    self.headers.get("X-RPC-Params", "")))

            def _do_raw(self, name: str):
                """Params in X-RPC-Params, the body raw; the body is read
                before any work, so an error reply leaves the connection
                in step."""
                mode = self.headers.get("X-RPC-Stream", "")
                if mode:
                    return self._do_raw_stream(name, mode)
                n = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(n) if n else b""
                fn = raw.get(name)
                if fn is None:
                    return self._reply(404, {"ok": False,
                                             "error_type": "NoSuchMethod",
                                             "message": name})
                try:
                    out = fn(self._params(), data)
                    self._reply_raw(out if out is not None else b"")
                except Exception as e:  # noqa: BLE001
                    self._reply(400, self._error_doc(e))

            def _do_raw_stream(self, name: str, mode: str):
                """A framed request: the handler applies each frame as it
                lands.  After a handler error the rest is drained so the
                typed reply leaves the connection in step; a stream that
                died (reset, truncated frame) gets no reply."""
                fn = raw_stream.get(name)
                frames = FrameReader(self.rfile, trailer="trailer" in mode)
                if fn is None:
                    frames.drain()
                    return self._reply(404, {"ok": False,
                                             "error_type": "NoSuchMethod",
                                             "message": name})
                try:
                    out = fn(self._params(), frames)
                    if not frames.in_sync():
                        frames.drain()
                    self._reply_raw(out if out is not None else b"")
                except (ConnectionError, socket.timeout):
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001 — a typed error
                    try:
                        frames.drain()
                    except (ConnectionError, OSError):
                        self.close_connection = True
                        return
                    try:
                        self._reply(400, self._error_doc(e))
                    except OSError:
                        self.close_connection = True

        return Handler


class DynamicTimeout:
    """A deadline sized from observed latencies (cmd/dynamic-timeouts.go:35):
    every ``window`` successes it moves halfway toward 4x the slowest of
    them, a timeout grows it 1.5x; both within [minimum, maximum]."""

    def __init__(self, initial: float = 30.0, minimum: float = 1.0,
                 maximum: float = 120.0, window: int = 16):
        self.minimum = minimum
        self.maximum = maximum
        self.window = window
        self._timeout = initial
        self._samples: list[float] = []
        self._mu = threading.Lock()

    def timeout(self) -> float:
        with self._mu:
            return self._timeout

    def log_success(self, duration: float) -> None:
        with self._mu:
            self._samples.append(duration)
            if len(self._samples) < self.window:
                return
            target = max(self.minimum, 4.0 * max(self._samples))
            self._timeout = min(self.maximum,
                                0.5 * self._timeout + 0.5 * target)
            self._samples.clear()

    def log_failure(self) -> None:
        with self._mu:
            self._timeout = min(self.maximum, self._timeout * 1.5)
            self._samples.clear()


class _StaleConn(Exception):
    """A pooled keep-alive connection died under a call.  ``sent``: the
    request had left (replayable only when idempotent)."""

    def __init__(self, sent: bool):
        super().__init__("stale pooled connection")
        self.sent = sent


def _policy_from_config():
    """(breaker kwargs, retry policy) from the ``rpc`` kvconfig
    (``MT_RPC_BREAKER_FAILURES`` and so on)."""
    from ..utils.kvconfig import Config, parse_duration
    from ..utils.retry import RetryBudget, RetryPolicy
    cfg = Config()

    def _int(key, default):
        try:
            return int(cfg.get("rpc", key))
        except (KeyError, ValueError):
            return default

    breaker_kwargs = {
        "fail_max": _int("breaker_failures", 3),
        "cooldown_s": parse_duration(cfg.get("rpc", "breaker_cooldown"),
                                     3.0),
    }
    budget_cap = _int("retry_budget", 10)
    retry = RetryPolicy(
        attempts=_int("retry_attempts", 3),
        base_s=parse_duration(cfg.get("rpc", "retry_base"), 0.05),
        cap_s=parse_duration(cfg.get("rpc", "retry_cap"), 2.0),
        budget=RetryBudget(budget_cap) if budget_cap > 0 else None)
    return breaker_kwargs, retry


class RPCClient:
    """The client of one peer (cmd/storage-rest-client.go:651): pooled
    keep-alive connections, a circuit breaker, retries of idempotent
    calls, and a deadline per service."""

    # bulk storage transfers take seconds, lock and ping calls
    # milliseconds: each service keeps its own deadline, with a floor
    _SERVICE_MIN = {"storage": 10.0}
    _DEFAULT_MIN = 1.0

    POOL_MAX = 8    # idle keep-alive connections per peer

    def __init__(self, endpoint: str, secret: str, timeout: float = 30.0,
                 breaker: CircuitBreaker | None = None, retry=None):
        u = urllib.parse.urlsplit(endpoint)
        self.host, self.port = u.hostname, u.port
        self.scheme = u.scheme or "http"
        self.endpoint = endpoint
        self.secret = secret
        self.timeout = timeout
        self._dyn: dict[str, DynamicTimeout] = {}
        if breaker is None or retry is None:
            bk, rp = _policy_from_config()
            breaker = breaker or CircuitBreaker(label=endpoint, **bk)
            retry = retry or rp
        if not breaker.label:
            breaker.label = endpoint
        self.breaker = breaker
        self.retry = retry
        self._pool: list[http.client.HTTPConnection] = []
        self._pool_mu = threading.Lock()

    def close(self) -> None:
        """Close the pooled connections."""
        with self._pool_mu:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def _get_conn(self, timeout: float
                  ) -> tuple[http.client.HTTPConnection, bool]:
        """(connection, pooled): a pooled one may be stale."""
        with self._pool_mu:
            conn = self._pool.pop() if self._pool else None
        if conn is not None:
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        if self.scheme == "https":
            from ..secure import transport
            return transport.https_connection(self.host, self.port, timeout,
                                              plane="internode"), False
        return _Connection(self.host, self.port, timeout=timeout), False

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._pool_mu:
            if len(self._pool) < self.POOL_MAX:
                self._pool.append(conn)
                return
        conn.close()

    def _dyn_for(self, service: str) -> DynamicTimeout:
        dt = self._dyn.get(service)
        if dt is None:
            dt = DynamicTimeout(
                initial=self.timeout,
                minimum=self._SERVICE_MIN.get(service, self._DEFAULT_MIN))
            self._dyn[service] = dt
        return dt

    def is_online(self) -> bool:
        """False only while the breaker is open and cooling down."""
        return self.breaker.ready()

    def _send_stream(self, conn, path: str, headers: dict,
                     body: StreamBody) -> None:
        """Headers, each chunk as a frame, the end marker, and the
        trailer when the body has one; if the trailer function raises,
        the abort marker goes out and _GateAbort carries its error."""
        conn.putrequest("POST", path, skip_accept_encoding=True)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.putheader("X-RPC-Stream",
                       "frames+trailer" if body.trailer_fn else "frames")
        conn.endheaders()
        body.sent = 0
        body.frames = 0
        for chunk in body.chunks_fn():
            mv = memoryview(chunk).cast("B")
            if not len(mv):
                continue
            conn.send(struct.pack(">I", len(mv)))
            conn.send(mv)
            body.sent += len(mv) + 4
            body.frames += 1
        if body.trailer_fn is None:
            conn.send(_F_END)
            body.sent += 4
            return
        try:
            trailer = body.trailer_fn()
        except BaseException as e:
            conn.send(_F_END + _F_ABORT)
            body.sent += 8
            raise _GateAbort(e) from e
        conn.send(_F_END + struct.pack(">I", len(trailer)) + trailer)
        body.sent += 8 + len(trailer)

    def _attempt(self, path: str, body, headers: dict, dyn,
                 timeout: float | None = None) -> tuple[int, bytes, bool]:
        """One request and its reply on one connection: (status, payload,
        streamed reply).  _StaleConn where a pooled connection died in a
        phase where a replay is sound; RPCError("ConnectionError") for
        any other transport failure."""
        conn, pooled = self._get_conn(
            dyn.timeout() if timeout is None else timeout)
        aborting = None
        try:
            if isinstance(body, StreamBody):
                try:
                    self._send_stream(conn, path, headers, body)
                except _GateAbort as e:
                    # the request ended on the wire: read the peer's
                    # reply, then raise the gate's error
                    aborting = e.cause_exc
                except (OSError, http.client.HTTPException):
                    raise
                except BaseException:
                    # the chunk source died: the peer drops the
                    # truncated stream when the socket closes
                    conn.close()
                    raise
            else:
                conn.request("POST", path, body=body, headers=headers)
        except socket.timeout as e:
            conn.close()
            if timeout is None:
                dyn.log_failure()
            raise RPCError("ConnectionError", str(e)) from e
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            if pooled and not (isinstance(body, StreamBody) and body.sent):
                raise _StaleConn(sent=False) from e
            raise RPCError("ConnectionError", str(e)) from e
        try:
            resp = conn.getresponse()
            status = resp.status
            streamed_resp = resp.getheader("X-RPC-Stream") == "resp"
            payload = resp.read()
        except socket.timeout as e:
            conn.close()
            if timeout is None:
                dyn.log_failure()
            raise RPCError("ConnectionError", str(e)) from e
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            if aborting is not None:
                raise aborting from e
            if pooled and isinstance(e, (http.client.RemoteDisconnected,
                                         ConnectionResetError,
                                         BrokenPipeError)) \
                    and not (isinstance(body, StreamBody) and body.sent):
                raise _StaleConn(sent=True) from e
            raise RPCError("ConnectionError", str(e)) from e
        self._put_conn(conn)
        if aborting is not None:
            raise aborting
        return status, payload, streamed_resp

    def _roundtrip(self, path: str, body, service: str,
                   extra_headers: dict | None = None,
                   raw_response: bool = False, idempotent: bool = False,
                   timeout: float | None = None):
        """A call under the breaker and the retry policy: an open breaker
        fails fast (PeerOffline); a stale pooled connection is replayed
        on a fresh one (always when the request never left, else only
        when idempotent); a transport failure feeds the breaker and
        retries idempotent calls.  ``timeout`` bounds one attempt and
        feeds neither the breaker nor the deadline."""
        if not self.breaker.allow():
            raise RPCError("PeerOffline", self.endpoint)
        dyn = self._dyn_for(service)
        headers = {
            "Authorization": f"Bearer {mint_token(self.secret, path)}",
            "Content-Type": "application/msgpack",
            **(extra_headers or {})}
        mtr = _metrics.GLOBAL
        start = time.monotonic()
        state = {"attempt": 0, "stale": 0}

        def transport_failure(e: Exception) -> bool:
            """True: retry now.  The breaker is asked before the budget,
            so a refused retry spends no token and sleeps no backoff."""
            mtr.inc("mt_node_rpc_errors_total", {"service": service})
            if timeout is not None:
                return False
            self.breaker.record_failure()
            if not self.breaker.ready():
                return False
            if not self.retry.may_retry(state["attempt"], idempotent):
                return False
            if not self.breaker.allow():
                return False
            self.retry.wait(state["attempt"])
            state["attempt"] += 1
            return True

        while True:
            try:
                status, payload, streamed_resp = self._attempt(
                    path, body, headers, dyn, timeout)
            except _StaleConn as e:
                if state["stale"] < self.POOL_MAX and \
                        (not e.sent or idempotent):
                    state["stale"] += 1
                    continue
                if transport_failure(e):
                    continue
                raise RPCError("ConnectionError",
                               str(e.__cause__ or e)) from e
            except RPCError as e:
                if transport_failure(e):
                    continue
                raise
            if raw_response and status == 200:
                doc = None
                break
            # an undecodable reply is a transport failure, not a crash
            try:
                doc = msgpack.unpackb(payload)
                if not isinstance(doc, dict):
                    raise ValueError("non-document RPC reply")
                break
            except Exception as e:  # noqa: BLE001 — garbage bytes
                if transport_failure(e):
                    continue
                raise RPCError(
                    "BadResponse",
                    f"HTTP {status}: undecodable RPC reply") from e
        # the peer answered: it is alive, even with an application error
        self.breaker.record_success()
        self.retry.on_success()
        if timeout is None:
            dyn.log_success(time.monotonic() - start)
        mtr.inc("mt_node_rpc_calls_total", {"service": service})
        if isinstance(body, StreamBody):
            mtr.inc("mt_node_rpc_tx_bytes_total", value=float(body.sent))
            mtr.inc("mt_node_rpc_stream_bytes_total", {"dir": "tx"},
                    value=float(body.sent))
            mtr.inc("mt_node_rpc_stream_frames_total", {"dir": "tx"},
                    value=float(body.frames))
        else:
            mtr.inc("mt_node_rpc_tx_bytes_total", value=float(len(body)))
        mtr.inc("mt_node_rpc_rx_bytes_total", value=float(len(payload)))
        if streamed_resp:
            mtr.inc("mt_node_rpc_stream_bytes_total", {"dir": "rx"},
                    value=float(len(payload)))
        if doc is None:
            return payload
        if not doc.get("ok"):
            raise RPCError(doc.get("error_type", "Unknown"),
                           doc.get("message", ""))
        return doc.get("result")

    def call(self, service: str, method: str, _idempotent: bool = False,
             _timeout: float | None = None, **kwargs):
        """``service.method(**kwargs)`` on the peer; ``_timeout`` bounds
        this call's one attempt (cluster-wide fan-outs)."""
        return self._roundtrip(f"/rpc/{service}/{method}",
                               msgpack.packb(kwargs), service,
                               idempotent=_idempotent, timeout=_timeout)

    def raw_call(self, name: str, params: dict, body=b"",
                 idempotent: bool = False) -> bytes:
        """``POST /raw/<name>``: ``params`` in a header, ``body`` (bytes,
        ``Iovecs`` or a framed ``StreamBody``) as the body, raw bytes
        back."""
        headers = {"X-RPC-Params": msgpack.packb(params).hex()}
        if isinstance(body, Iovecs):
            # http.client cannot size a body of several buffers
            headers["Content-Length"] = str(len(body))
        return self._roundtrip(f"/raw/{name}", body, "storage",
                               extra_headers=headers, raw_response=True,
                               idempotent=idempotent)

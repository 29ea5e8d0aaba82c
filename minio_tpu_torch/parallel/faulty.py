"""Network faults on purpose (``minio_tpu/parallel/faulty.py``): a TCP
proxy that injects programmed faults between a client and an HTTP
server, the RPC plane's or the S3 front's (over TLS as well: it relays
bytes).

Faults are programmed by the number of the accepted connection (from 1),
never drawn at random; a connection without a program takes the
``default`` (pass-through unless set):

* ``Fault.passthrough()``: relay both ways;
* ``Fault.delay(s)``: hold the connection ``s`` seconds, then relay;
* ``Fault.reset(after_bytes=n)``: relay, and reset the client's side
  (RST) after ``n`` bytes from the server;
* ``Fault.blackhole()``: accept, swallow what the client sends, never
  answer (a peer up at TCP and dead above it);
* ``Fault.http_503()``: answer one request with a canned 503 without
  dialling the server, then close.

``stop()`` closes the listener and every relayed socket and joins every
thread the proxy started.  A relayed connection to the server has no
timeout of its own: the client's deadline bounds it.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Fault:
    kind: str                   # pass | delay | reset | blackhole | 503
    delay_s: float = 0.0
    after_bytes: int = 0

    @classmethod
    def passthrough(cls) -> "Fault":
        return cls("pass")

    @classmethod
    def delay(cls, seconds: float) -> "Fault":
        return cls("delay", delay_s=seconds)

    @classmethod
    def reset(cls, after_bytes: int = 0) -> "Fault":
        return cls("reset", after_bytes=after_bytes)

    @classmethod
    def blackhole(cls) -> "Fault":
        return cls("blackhole")

    @classmethod
    def http_503(cls) -> "Fault":
        return cls("503")


_CANNED_503 = (b"HTTP/1.1 503 Service Unavailable\r\n"
               b"Content-Length: 0\r\nConnection: close\r\n\r\n")


def _cut(s: socket.socket) -> None:
    """Shut down, then close: close alone does not wake a thread blocked
    in recv on the socket."""
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass


class FaultyProxy:
    """A TCP proxy in front of one upstream, faulting connections by
    their number."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: dict[int, Fault] | None = None,
                 default: Fault | None = None, host: str = "127.0.0.1"):
        self.upstream = (upstream_host, upstream_port)
        self._plan = dict(plan or {})
        self._default = default or Fault.passthrough()
        self._mu = threading.Lock()
        self._conn_nr = 0
        self._stop = threading.Event()
        self._live: set[socket.socket] = set()
        self._threads: set[threading.Thread] = set()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(64)
        # closing a socket does not wake a blocked accept on Linux: the
        # accept loop polls the stop flag
        self._lsock.settimeout(0.25)
        self.host = host
        self.port = self._lsock.getsockname()[1]

    # -- programming -------------------------------------------------------

    def program(self, conn_nr: int, fault: Fault) -> None:
        """The fault of accepted connection number ``conn_nr`` (from 1)."""
        with self._mu:
            self._plan[conn_nr] = fault

    def set_default(self, fault: Fault | None) -> None:
        """The fault of every connection without a program from now on
        (None: pass-through)."""
        with self._mu:
            self._default = fault or Fault.passthrough()

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def connections_seen(self) -> int:
        with self._mu:
            return self._conn_nr

    def sever(self) -> None:
        """Cut every relayed connection now, the listener left open, so a
        new default applies to all traffic from here on."""
        with self._mu:
            live = list(self._live)
        for s in live:
            _cut(s)

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, target, *args, name: str) -> None:
        def run():
            try:
                target(*args)
            finally:
                with self._mu:
                    self._threads.discard(threading.current_thread())
        t = threading.Thread(target=run, daemon=True, name=name)
        with self._mu:
            self._threads.add(t)
        t.start()

    def start(self) -> "FaultyProxy":
        self._spawn(self._accept_loop, name="mt-faulty-accept")
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Close the listener and every relayed socket, and join every
        thread the proxy started."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while True:
            self.sever()
            with self._mu:
                threads = list(self._threads)
            if not threads or time.monotonic() > deadline:
                break
            threads[0].join(0.05)
        try:
            self._lsock.close()
        except OSError:
            pass

    def _track(self, s: socket.socket) -> bool:
        """List a socket for ``sever``; False (and the socket cut) once
        the proxy is stopping."""
        with self._mu:
            if not self._stop.is_set():
                self._live.add(s)
                return True
        _cut(s)
        return False

    def _untrack(self, s: socket.socket) -> None:
        with self._mu:
            self._live.discard(s)
        try:
            s.close()
        except OSError:
            pass

    # -- serving -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._lsock.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            client.settimeout(None)
            with self._mu:
                self._conn_nr += 1
                fault = self._plan.get(self._conn_nr, self._default)
            if self._track(client):
                self._spawn(self._serve, client, fault,
                            name="mt-faulty-serve")

    def _serve(self, client: socket.socket, fault: Fault) -> None:
        try:
            if fault.kind == "blackhole":
                while not self._stop.is_set():
                    try:
                        if not client.recv(65536):
                            return
                    except OSError:
                        return
                return
            if fault.kind == "503":
                # one request's bytes, then the canned answer
                try:
                    client.settimeout(5.0)
                    client.recv(65536)
                    client.sendall(_CANNED_503)
                except OSError:
                    pass
                return
            if fault.kind == "delay":
                self._stop.wait(fault.delay_s)
            if self._stop.is_set():
                return
            try:
                up = socket.create_connection(self.upstream, timeout=10.0)
            except OSError:
                return
            up.settimeout(None)
            if not self._track(up):
                return
            try:
                self._spawn(self._pipe, client, up, None,
                            name="mt-faulty-pipe")
                # the reset counts the server's bytes: a reset mid-body
                # needs the answer under way
                limit = fault.after_bytes if fault.kind == "reset" else None
                self._pipe(up, client, limit)
                if fault.kind == "reset":
                    # RST, not FIN: SO_LINGER(1, 0) makes close() reset
                    try:
                        client.setsockopt(socket.SOL_SOCKET,
                                          socket.SO_LINGER,
                                          struct.pack("ii", 1, 0))
                    except OSError:
                        pass
                # wake the other pipe (SHUT_RD sends nothing on the wire)
                for s in (client, up):
                    try:
                        s.shutdown(socket.SHUT_RD)
                    except OSError:
                        pass
            finally:
                self._untrack(up)
        finally:
            self._untrack(client)

    def _pipe(self, src: socket.socket, dst: socket.socket,
              byte_limit: int | None) -> None:
        """Relay src to dst until EOF or an error; with ``byte_limit``,
        stop after that many bytes (the reset point)."""
        forwarded = 0
        while not self._stop.is_set():
            try:
                data = src.recv(65536)
            except OSError:
                return
            if not data:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            if byte_limit is not None:
                data = data[:max(byte_limit - forwarded, 0)]
                if not data:
                    return
            try:
                dst.sendall(data)
            except OSError:
                return
            forwarded += len(data)
            if byte_limit is not None and forwarded >= byte_limit:
                return

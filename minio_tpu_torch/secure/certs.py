"""TLS on the S3 front with certificates that reload live
(``minio_tpu/secure/certs.py``; pkg/certs/certs.go,
cmd/common-main.go:360).

``CertManager`` holds the front's certificate and key (and per-hostname
pairs served by SNI), and the server context built from them.  Before it
answers, it re-reads the files' modification times (at most once per
``check_interval_s``) and drops its contexts when one moved, so new
certificate files take effect at the next connection, without a restart
or a new listener.  ``enable_server_tls`` wraps every socket the
server accepts without handshaking, on the accept loop, and each handler
thread completes the handshake under its own deadline (``handshake``).
``from_config`` builds the manager from the ``tls`` kvconfig subsystem.
Internode TLS and the ``mt_tls_*`` metrics are not the port's.
"""

from __future__ import annotations

import os
import ssl
import threading
import time


class TLSConfigError(Exception):
    """Certificate or key files that cannot be used."""


class CertManager:
    """The front's certificate and key, with SNI pairs and a CA file
    (``client_context`` trusts it), reloaded when their files change."""

    HANDSHAKE_TIMEOUT_S = 10.0

    def __init__(self, default: tuple[str, str],
                 ca_file: str | None = None,
                 sni: dict[str, tuple[str, str]] | None = None,
                 check_interval_s: float = 1.0, clock=time.monotonic):
        self._default = (str(default[0]), str(default[1]))
        self.ca_file = str(ca_file) if ca_file else None
        self._sni = {str(h): (str(c), str(k))
                     for h, (c, k) in (sni or {}).items()}
        self.check_interval_s = check_interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._server_ctx: ssl.SSLContext | None = None
        self._sni_ctx: dict[str, ssl.SSLContext] = {}
        self._mtimes = self._stat_files()
        self._last_check = self._clock()
        self.reloads = 0
        # a server "with TLS" whose files are missing must not come up
        for cert, key in [self._default, *self._sni.values()]:
            if not (os.path.exists(cert) and os.path.exists(key)):
                raise TLSConfigError(
                    f"missing cert/key material: {cert} / {key}")

    def _watched(self) -> list[str]:
        files = [f for pair in [self._default, *self._sni.values()]
                 for f in pair]
        return files + ([self.ca_file] if self.ca_file else [])

    def _stat_files(self) -> dict[str, float]:
        out = {}
        for f in self._watched():
            try:
                out[f] = os.stat(f).st_mtime
            except OSError:
                out[f] = -1.0
        return out

    def maybe_reload(self, force: bool = False) -> bool:
        """Drop the contexts when a watched file's mtime moved (checked at
        most once per ``check_interval_s``); True when they were."""
        now = self._clock()
        with self._mu:
            if not force and now - self._last_check < self.check_interval_s:
                return False
            self._last_check = now
        mtimes = self._stat_files()
        with self._mu:
            if not force and mtimes == self._mtimes:
                return False
            self._mtimes = mtimes
            self._server_ctx = None
            self._sni_ctx.clear()
            self.reloads += 1
        return True

    @staticmethod
    def _context(pair: tuple[str, str]) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        try:
            ctx.load_cert_chain(certfile=pair[0], keyfile=pair[1])
        except (OSError, ssl.SSLError) as e:
            raise TLSConfigError(
                f"cannot load cert chain {pair[0]}: {e}") from e
        return ctx

    def _sni_select(self, sslobj, server_name, ctx) -> None:
        """A connection that names a host with a pair of its own
        handshakes with that pair."""
        pair = self._sni.get(server_name or "")
        if pair is None:
            return None
        with self._mu:
            sctx = self._sni_ctx.get(server_name)
        if sctx is None:
            sctx = self._context(pair)
            with self._mu:
                self._sni_ctx[server_name] = sctx
        sslobj.context = sctx
        return None

    def server_context(self) -> ssl.SSLContext:
        self.maybe_reload()
        with self._mu:
            ctx = self._server_ctx
        if ctx is None:
            ctx = self._context(self._default)
            if self._sni:
                ctx.sni_callback = self._sni_select
            with self._mu:
                self._server_ctx = ctx
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """A client context that trusts ``ca_file`` (hostnames checked)."""
        return ssl.create_default_context(cafile=self.ca_file)

    def wrap_accept(self, sock):
        """Wrap an accepted socket, the handshake left to ``handshake``:
        the accept loop never waits on a slow client."""
        return self.server_context().wrap_socket(
            sock, server_side=True, do_handshake_on_connect=False,
            suppress_ragged_eofs=True)

    def handshake(self, ssl_sock, timeout: float | None = None) -> None:
        """Complete a wrapped socket's handshake within ``timeout``."""
        ssl_sock.settimeout(timeout or self.HANDSHAKE_TIMEOUT_S)
        ssl_sock.do_handshake()

    @classmethod
    def from_config(cls, cfg) -> "CertManager | None":
        """From the ``tls`` subsystem (``enable``, ``certs_dir``); None
        when it is off."""
        if cfg.get("tls", "enable") != "on":
            return None
        certs_dir = cfg.get("tls", "certs_dir")
        if not certs_dir:
            raise TLSConfigError("tls.enable=on but tls.certs_dir empty")
        return cls.from_dir(certs_dir)

    @classmethod
    def from_dir(cls, certs_dir: str) -> "CertManager":
        """``<dir>/public.crt`` and ``private.key``, the first CA of
        ``<dir>/CAs/``, and ``<dir>/sni/<host>/`` pairs (docs/security.md;
        the reference's ``internode/`` pair is not read)."""
        ca_dir = os.path.join(certs_dir, "CAs")
        cas = sorted(f for f in os.listdir(ca_dir)
                     if f.endswith((".crt", ".pem"))) \
            if os.path.isdir(ca_dir) else []
        sni = {}
        sni_dir = os.path.join(certs_dir, "sni")
        if os.path.isdir(sni_dir):
            for host in sorted(os.listdir(sni_dir)):
                pair = (os.path.join(sni_dir, host, "public.crt"),
                        os.path.join(sni_dir, host, "private.key"))
                if os.path.exists(pair[0]):
                    sni[host] = pair
        return cls((os.path.join(certs_dir, "public.crt"),
                    os.path.join(certs_dir, "private.key")),
                   ca_file=os.path.join(ca_dir, cas[0]) if cas else None,
                   sni=sni or None)


def enable_server_tls(httpd, manager: CertManager) -> None:
    """Wrap each socket a ThreadingHTTPServer accepts with the manager's
    context of that moment.  A context that cannot be built (certificate
    files caught mid-rotation) costs that connection, never the
    listener: it surfaces as the OSError the accept loop drops."""
    base_get = httpd.get_request

    def get_request():
        sock, addr = base_get()
        try:
            return manager.wrap_accept(sock), addr
        except TLSConfigError as e:
            try:
                sock.close()
            except OSError:
                pass
            raise OSError(f"TLS accept: {e}") from e

    httpd.get_request = get_request

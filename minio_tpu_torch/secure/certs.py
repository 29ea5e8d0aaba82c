"""Certificates that reload live, for both planes
(``minio_tpu/secure/certs.py``; pkg/certs/certs.go,
cmd/common-main.go:360).

``CertManager`` holds the S3 front's pair (and per-hostname pairs served
by SNI), the internode identity and the CA that pins peers.  Before it
answers, it re-reads the files' modification times (at most once per
``check_interval_s``) and drops its contexts when one moved, so new
certificate files take effect at the next connection, without a restart
or a new listener.  The internode listener requires a client certificate
that chains to the CA (mutual TLS), and the internode client presents
the internode identity.  ``enable_server_tls`` wraps every socket a
server accepts without handshaking, on the accept loop, and each handler
thread completes the handshake under its own deadline (``handshake``),
counted in ``mt_tls_handshake_total`` and
``mt_tls_handshake_failed_total`` per plane.  ``render_metrics`` gives
``mt_tls_cert_expiry_seconds`` of every live manager, and nothing in a
process that never built one.  ``from_config`` builds the manager from
the ``tls`` kvconfig subsystem.
"""

from __future__ import annotations

import os
import ssl
import threading
import time
import weakref

from ..admin import metrics as _metrics

# every live manager, for the scrape's expiry gauges; weak, so a stopped
# server's manager goes with it
_MANAGERS: "weakref.WeakSet[CertManager]" = weakref.WeakSet()


class TLSConfigError(Exception):
    """Certificate or key files that cannot be used."""


def _not_after_epoch(cert_file: str) -> float | None:
    """A PEM certificate's notAfter in epoch seconds, through the decoder
    ``ssl`` uses for getpeercert; None when it cannot be read (no gauge)."""
    try:
        info = ssl._ssl._test_decode_cert(cert_file)
        return float(ssl.cert_time_to_seconds(info["notAfter"]))
    except Exception:  # noqa: BLE001 — a missing or garbled file: no gauge
        return None


class CertManager:
    """The front's pair, the internode identity (served to peers and
    presented to them as the client certificate), the CA file that pins
    peer verification, and SNI pairs; reloaded when their files change."""

    HANDSHAKE_TIMEOUT_S = 10.0

    def __init__(self, default: tuple[str, str],
                 internode: tuple[str, str] | None = None,
                 ca_file: str | None = None,
                 sni: dict[str, tuple[str, str]] | None = None,
                 check_interval_s: float = 1.0, clock=time.monotonic):
        self._default = (str(default[0]), str(default[1]))
        self._internode = (str(internode[0]), str(internode[1])) \
            if internode else None
        self.ca_file = str(ca_file) if ca_file else None
        self._sni = {str(h): (str(c), str(k))
                     for h, (c, k) in (sni or {}).items()}
        self.check_interval_s = check_interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._server_ctx: dict[str, ssl.SSLContext] = {}
        self._client_ctx: dict[str, ssl.SSLContext] = {}
        self._sni_ctx: dict[str, ssl.SSLContext] = {}
        self._mtimes = self._stat_files()
        self._last_check = self._clock()
        self.reloads = 0
        self._expiries = self._read_expiries()
        # a server "with TLS" whose files are missing must not come up
        for cert, key in self._pairs().values():
            if not (os.path.exists(cert) and os.path.exists(key)):
                raise TLSConfigError(
                    f"missing cert/key material: {cert} / {key}")
        _MANAGERS.add(self)

    # -- file watching -----------------------------------------------------

    def _pairs(self) -> dict[str, tuple[str, str]]:
        out = {"s3": self._default}
        if self._internode:
            out["internode"] = self._internode
        for host, pair in self._sni.items():
            out[f"sni:{host}"] = pair
        return out

    def _watched(self) -> list[str]:
        files = [f for pair in self._pairs().values() for f in pair]
        return files + ([self.ca_file] if self.ca_file else [])

    def _stat_files(self) -> dict[str, float]:
        out = {}
        for f in self._watched():
            try:
                out[f] = os.stat(f).st_mtime
            except OSError:
                out[f] = -1.0
        return out

    def _read_expiries(self) -> dict[str, float]:
        out = {}
        for label, (cert, _) in self._pairs().items():
            exp = _not_after_epoch(cert)
            if exp is not None:
                out[label] = exp
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
            self._server_ctx.clear()
            self._client_ctx.clear()
            self._sni_ctx.clear()
            self.reloads += 1
        self._expiries = self._read_expiries()
        _metrics.GLOBAL.inc("mt_tls_cert_reloads_total")
        return True

    # -- contexts ------------------------------------------------------------

    @staticmethod
    def _load_chain(ctx: ssl.SSLContext, pair: tuple[str, str]) -> None:
        try:
            ctx.load_cert_chain(certfile=pair[0], keyfile=pair[1])
        except (OSError, ssl.SSLError) as e:
            raise TLSConfigError(
                f"cannot load cert chain {pair[0]}: {e}") from e

    def _build_server(self, plane: str) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        if plane == "internode":
            self._load_chain(ctx, self._internode or self._default)
            if self.ca_file:
                # mutual TLS: only holders of a CA-signed identity reach
                # the RPC's token check
                ctx.load_verify_locations(cafile=self.ca_file)
                ctx.verify_mode = ssl.CERT_REQUIRED
        else:
            self._load_chain(ctx, self._default)
            if self._sni:
                ctx.sni_callback = self._sni_select
        return ctx

    def _build_client(self, plane: str) -> ssl.SSLContext:
        # the default context verifies certificates and hostnames; the CA
        # file only replaces its trust roots
        ctx = ssl.create_default_context(cafile=self.ca_file)
        if plane == "internode":
            # the identity the peer's mTLS listener asks for
            self._load_chain(ctx, self._internode or self._default)
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
            sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            sctx.minimum_version = ssl.TLSVersion.TLSv1_2
            self._load_chain(sctx, pair)
            with self._mu:
                self._sni_ctx[server_name] = sctx
        sslobj.context = sctx
        return None

    def _context(self, cache: dict, build, plane: str) -> ssl.SSLContext:
        self.maybe_reload()
        with self._mu:
            ctx = cache.get(plane)
        if ctx is None:
            ctx = build(plane)
            with self._mu:
                cache[plane] = ctx
        return ctx

    def server_context(self, plane: str = "s3") -> ssl.SSLContext:
        return self._context(self._server_ctx, self._build_server, plane)

    def client_context(self, plane: str = "internode") -> ssl.SSLContext:
        return self._context(self._client_ctx, self._build_client, plane)

    # -- listeners -------------------------------------------------------------

    def wrap_accept(self, sock, plane: str):
        """Wrap an accepted socket, the handshake left to ``handshake``:
        the accept loop never waits on a slow client."""
        return self.server_context(plane).wrap_socket(
            sock, server_side=True, do_handshake_on_connect=False,
            suppress_ragged_eofs=True)

    def handshake(self, ssl_sock, plane: str,
                  timeout: float | None = None) -> None:
        """Complete a wrapped socket's handshake within ``timeout``.
        ``mt_tls_handshake_total`` counts failures too."""
        labels = {"plane": plane}
        try:
            ssl_sock.settimeout(timeout or self.HANDSHAKE_TIMEOUT_S)
            ssl_sock.do_handshake()
        except BaseException:
            _metrics.GLOBAL.inc("mt_tls_handshake_total", labels)
            _metrics.GLOBAL.inc("mt_tls_handshake_failed_total", labels)
            raise
        _metrics.GLOBAL.inc("mt_tls_handshake_total", labels)

    def cert_expiries(self) -> dict[str, float]:
        """label -> notAfter (epoch seconds) of each loaded certificate."""
        return dict(self._expiries)

    # -- from the config -------------------------------------------------------

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
        """``<dir>/public.crt`` and ``private.key``,
        ``<dir>/internode/``'s pair, the first CA of ``<dir>/CAs/``, and
        ``<dir>/sni/<host>/`` pairs (docs/security.md)."""
        inter_dir = os.path.join(certs_dir, "internode")
        internode = (os.path.join(inter_dir, "public.crt"),
                     os.path.join(inter_dir, "private.key")) \
            if os.path.isdir(inter_dir) else None
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
                   internode=internode,
                   ca_file=os.path.join(ca_dir, cas[0]) if cas else None,
                   sni=sni or None)


def enable_server_tls(httpd, manager: CertManager, plane: str) -> None:
    """Wrap each socket a ThreadingHTTPServer accepts with the manager's
    context of that moment for ``plane``.  A context that cannot be built
    (certificate files caught mid-rotation) costs that connection, never
    the listener: it surfaces as the OSError the accept loop drops."""
    base_get = httpd.get_request

    def get_request():
        sock, addr = base_get()
        try:
            return manager.wrap_accept(sock, plane), addr
        except TLSConfigError as e:
            try:
                sock.close()
            except OSError:
                pass
            raise OSError(f"TLS accept ({plane}): {e}") from e

    httpd.get_request = get_request


def render_metrics() -> list[str]:
    """``mt_tls_cert_expiry_seconds{cert}`` from every live manager
    (the first manager's reading of a label wins); nothing when no
    manager was built."""
    expiries: dict[str, float] = {}
    for m in list(_MANAGERS):
        for label, exp in m.cert_expiries().items():
            expiries.setdefault(label, exp)
    if not expiries:
        return []
    now = time.time()
    lines = ["# TYPE mt_tls_cert_expiry_seconds gauge"]
    for label in sorted(expiries):
        lines.append(f'mt_tls_cert_expiry_seconds{{cert="{label}"}}'
                     f" {expiries[label] - now:.0f}")
    return lines

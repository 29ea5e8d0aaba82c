"""Shared set-up of the external-identity tests (``test_torch_retry.py``,
``test_torch_etcd.py``, ``test_torch_ldap.py``, ``test_torch_openid.py``,
``test_torch_opa.py``).

``no_state_left`` is each module's guard: whatever the module changed of
the process is put back or found unchanged when it ends: both packages'
metric registries (restored), both kvconfig registries' subsystems,
the socket default timeout and urllib's global opener (unchanged; a
module imported for the first time may register new subsystems), and no
thread the module started outlives it but the reference's lock refresher, a lazy
process-wide singleton every later server reuses (``minio_tpu/soak/
slo.py`` leaves it out of its own leak count).  Environment variables
and module attributes change only through ``monkeypatch``.

The rest are the identities' fixtures: the LDAP directory of
``tests/ldap_stub.py`` and its ``identity_ldap`` settings, OpenID tokens
(HS256, and RS256 signed with ``cryptography``'s keys, which only the
tests use), and STS answers with their drawn parts masked."""

import base64
import contextlib
import copy
import hashlib
import hmac
import json
import re
import socket
import threading
import time
import urllib.parse
import urllib.request

from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.utils import kvconfig as ref_kv
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.utils import kvconfig as port_kv

SINGLETONS = ("mt-dsync-refresh",)


def _join_new_threads(before: set, timeout: float) -> list[str]:
    deadline = time.monotonic() + timeout
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()
                and not t.name.startswith(SINGLETONS)]
        if not left or time.monotonic() > deadline:
            return [t.name for t in left]
        left[0].join(0.05)


@contextlib.contextmanager
def no_state_left(timeout: float = 10.0):
    """Put back both metric registries; check the kvconfig registries'
    subsystems, the socket default timeout and urllib's opener unchanged
    and every thread started inside joined (the singleton aside)."""
    before = set(threading.enumerate())
    regs = [(m.GLOBAL, dict(m.GLOBAL._counters),
             copy.deepcopy(m.GLOBAL._hists))
            for m in (ref_metrics, port_metrics)]
    kvs = [(kv, copy.deepcopy(kv._REGISTRY)) for kv in (ref_kv, port_kv)]
    sock_timeout = socket.getdefaulttimeout()
    opener = urllib.request._opener
    try:
        yield
    finally:
        left = _join_new_threads(before, timeout)
        for reg, counters, hists in regs:
            with reg._mu:
                reg._counters.clear()
                reg._counters.update(counters)
                reg._hists.clear()
                reg._hists.update(hists)
        # a module the servers import for the first time registers its
        # subsystems: that stays, what was registered before may not change
        changed = [kv.__name__ for kv, saved in kvs
                   if any(kv._REGISTRY.get(k) != v for k, v in saved.items())]
        assert not left, f"threads outlived the module: {left}"
        assert not changed, f"kvconfig registries changed: {changed}"
        assert socket.getdefaulttimeout() == sock_timeout
        # urlopen caches its default opener on first use; nothing else
        # may be installed
        now = urllib.request._opener
        assert now is opener or (opener is None and all(
            type(h).__module__ == "urllib.request" for h in now.handlers))


def counter(pkg_metrics, name: str) -> dict:
    """{labels: value} of one counter family in a package's registry."""
    return {labels: v for (n, labels), v in
            pkg_metrics.GLOBAL.snapshot().items() if n == name}


def counted(pkg_metrics, name: str, before: dict) -> dict:
    """What one counter family gained since ``before`` (``counter``),
    labels that gained nothing left out: an earlier test may have
    counted a label in one package's registry and not the other's."""
    now = counter(pkg_metrics, name)
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


# -- LDAP ---------------------------------------------------------------------

BASE = "dc=example,dc=org"
USERS = f"ou=users,{BASE}"
GROUPS = f"ou=groups,{BASE}"
READERS = f"cn=readers,{GROUPS}"
ADMINS = f"cn=admins,{GROUPS}"


def ldap_settings(addr: str, lookup_password: str = "lookup-secret") -> dict:
    """The ``identity_ldap`` keys for the standard directory at ``addr``."""
    return {"server_addr": addr,
            "lookup_bind_dn": f"cn=lookup,{BASE}",
            "lookup_bind_password": lookup_password,
            "user_dn_search_base_dn": USERS,
            "user_dn_search_filter": "(uid=%s)",
            "group_search_filter": "(&(objectClass=groupOfNames)(member=%d))",
            "group_search_base_dn": GROUPS}


def set_env(mp, subsys: str, values: dict) -> None:
    for k, v in values.items():
        mp.setenv(f"MT_{subsys.upper()}_{k.upper()}", v)


@contextlib.contextmanager
def stub_running(stub):
    """``stub`` (an LDAP or etcd stub of ``tests/``) started; stopped and
    its serving thread joined on exit.  Yields its address."""
    addr = stub.start()
    try:
        yield addr
    finally:
        stub.stop()
        stub._thread.join(10)


# -- OpenID -------------------------------------------------------------------

ISSUER = "https://idp.example.test"
CLIENT = "minio-tpu-app"
HS_SECRET = "oidc-shared-secret"


def b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def hs256_token(claims: dict, secret: str = HS_SECRET) -> str:
    h = b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    c = b64url(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{h}.{c}".encode(),
                   hashlib.sha256).digest()
    return f"{h}.{c}.{b64url(sig)}"


def rsa_key():
    """A 2048-bit RSA key (``cryptography``'s)."""
    from cryptography.hazmat.primitives.asymmetric import rsa
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def jwk_of(key, kid: str) -> dict:
    nums = key.public_key().public_numbers()
    n_len = (nums.n.bit_length() + 7) // 8
    return {"kty": "RSA", "kid": kid, "alg": "RS256", "use": "sig",
            "n": b64url(nums.n.to_bytes(n_len, "big")),
            "e": b64url(nums.e.to_bytes(3, "big"))}


def rs256_token(key, claims: dict, kid: str | None = "k1",
                digest=None) -> str:
    """An RS256 JWT signed by ``key`` (``digest``: another hash, to make
    a signature whose DigestInfo is not SHA-256's)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding
    head = {"alg": "RS256", "typ": "JWT"}
    if kid is not None:
        head["kid"] = kid
    h = b64url(json.dumps(head).encode())
    c = b64url(json.dumps(claims).encode())
    sig = key.sign(f"{h}.{c}".encode(), padding.PKCS1v15(),
                   digest or hashes.SHA256())
    return f"{h}.{c}.{b64url(sig)}"


def claims(**over) -> dict:
    base = {"iss": ISSUER, "aud": CLIENT, "sub": "user-42",
            "exp": int(time.time()) + 600, "policy": "readwrite"}
    base.update(over)
    return {k: v for k, v in base.items() if v is not None}


# -- STS over HTTP ------------------------------------------------------------

_DRAWN = re.compile(rb"<(RequestId|AccessKeyId|SecretAccessKey|SessionToken"
                    rb"|Expiration)>[^<]*</\1>")


def sts_post(srv, form: dict):
    """An unsigned STS form POST to ``srv``; the answer, any status."""
    c = S3Client(f"http://127.0.0.1:{srv.port}", "", "")
    return c.request("POST", "/", body=urllib.parse.urlencode(form).encode(),
                     headers={"Content-Type":
                              "application/x-www-form-urlencoded"},
                     sign=False, expect=())


def masked(body: bytes) -> bytes:
    """An STS answer with its request id and credentials masked."""
    return _DRAWN.sub(rb"<\1/>", body)


def session_of(srv, body: bytes) -> S3Client:
    """A client of the credentials in an STS answer."""
    def field(name):
        return re.search(rb"<%s>([^<]*)</" % name.encode(), body) \
            .group(1).decode()
    return S3Client(f"http://127.0.0.1:{srv.port}", field("AccessKeyId"),
                    field("SecretAccessKey"),
                    session_token=field("SessionToken"))


def token_claims(body: bytes) -> dict:
    """The session token's claims, but the drawn key and the expiry."""
    tok = re.search(rb"<SessionToken>([^<]*)</", body).group(1).decode()
    c = json.loads(base64.urlsafe_b64decode(
        tok.split(".")[1] + "=" * (-len(tok.split(".")[1]) % 4)))
    return {k: v for k, v in c.items() if k not in ("accessKey", "exp")}

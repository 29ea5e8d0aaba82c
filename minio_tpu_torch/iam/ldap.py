"""LDAP identities for AssumeRoleWithLDAPIdentity (``minio_tpu/iam/ldap.py``,
cmd/config/identity/ldap with cmd/sts-handlers.go:436).

The lookup-bind flow: bind as the lookup user, search the user's DN,
check the password with a bind as that DN on a second connection, then
search the DNs of the user's groups.  The port carries its own LDAPv3
client over TCP: a BER codec (definite lengths, the types LDAPv3 uses),
RFC 4515 filters (equality, presence, and, or, not) and the simple bind
and search operations.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass

# -- BER ----------------------------------------------------------------------

SEQUENCE = 0x30
SET = 0x31
INTEGER = 0x02
OCTET_STRING = 0x04
ENUMERATED = 0x0A
BOOLEAN = 0x01

APP_BIND_REQUEST = 0x60
APP_BIND_RESPONSE = 0x61
APP_UNBIND_REQUEST = 0x42
APP_SEARCH_REQUEST = 0x63
APP_SEARCH_ENTRY = 0x64
APP_SEARCH_DONE = 0x65

CTX_SIMPLE_AUTH = 0x80          # [0] primitive inside BindRequest
FILTER_AND = 0xA0
FILTER_OR = 0xA1
FILTER_NOT = 0xA2
FILTER_EQ = 0xA3
FILTER_PRESENT = 0x87

SCOPE_BASE = 0
SCOPE_ONE = 1
SCOPE_SUB = 2


def ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = b""
    while n:
        out = bytes([n & 0xFF]) + out
        n >>= 8
    return bytes([0x80 | len(out)]) + out


def ber(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + ber_len(len(content)) + content


def ber_int(v: int, tag: int = INTEGER) -> bytes:
    """A non-negative integer, big-endian, with a leading zero byte where
    the top bit would read as a sign."""
    out = b"\x00" if v == 0 else b""
    while v:
        out = bytes([v & 0xFF]) + out
        v >>= 8
    if out[0] & 0x80:
        out = b"\x00" + out
    return ber(tag, out)


def ber_str(s: str | bytes, tag: int = OCTET_STRING) -> bytes:
    return ber(tag, s.encode() if isinstance(s, str) else s)


class BERReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def read_tlv(self) -> tuple[int, bytes]:
        tag = self.buf[self.pos]
        first = self.buf[self.pos + 1]
        self.pos += 2
        if first < 0x80:
            length = first
        else:
            nb = first & 0x7F
            length = int.from_bytes(self.buf[self.pos:self.pos + nb], "big")
            self.pos += nb
        val = self.buf[self.pos:self.pos + length]
        if len(val) != length:
            raise ValueError("truncated BER value")
        self.pos += length
        return tag, val


def decode_int(content: bytes) -> int:
    return int.from_bytes(content, "big")


# -- filters (RFC 4515) ---------------------------------------------------------

def parse_filter(expr: str) -> bytes:
    """A filter string as BER: equality, presence, and, or, not."""
    out, rest = _parse_one(expr.strip())
    if rest.strip():
        raise ValueError(f"trailing filter content: {rest!r}")
    return out


def _parse_one(expr: str) -> tuple[bytes, str]:
    if not expr.startswith("("):
        raise ValueError(f"filter must start with '(': {expr!r}")
    inner = expr[1:]
    if inner[0] in "&|!":
        tag = {"&": FILTER_AND, "|": FILTER_OR, "!": FILTER_NOT}[inner[0]]
        rest = inner[1:]
        parts = []
        while rest.startswith("("):
            part, rest = _parse_one(rest)
            parts.append(part)
        if not rest.startswith(")"):
            raise ValueError("unterminated composite filter")
        return ber(tag, b"".join(parts)), rest[1:]
    end = inner.index(")")
    body, rest = inner[:end], inner[end + 1:]
    attr, eq, value = body.partition("=")
    if not eq:
        raise ValueError(f"no '=' in filter component {body!r}")
    if value == "*":
        return ber_str(attr, FILTER_PRESENT), rest
    # the escapes exist only in the string form: the assertion value
    # goes on the wire as the raw characters
    return ber(FILTER_EQ,
               ber_str(attr) + ber_str(_unescape_filter(value))), rest


def _unescape_filter(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 3 <= len(s):
            out.append(chr(int(s[i + 1:i + 3], 16)))
            i += 3
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _escape_filter(s: str) -> str:
    """RFC 4515 escaping of an assertion value."""
    return "".join(f"\\{ord(ch):02x}" if ch in ("*", "(", ")", "\\", "\x00")
                   else ch for ch in s)


# -- the client -----------------------------------------------------------------

class LDAPError(Exception):
    pass


class LDAPClient:
    """Simple bind and search over one TCP connection (no TLS)."""

    def __init__(self, addr: str, timeout: float = 10.0):
        if ":" in addr:
            host, _, port = addr.rpartition(":")
        else:
            host, port = addr, ""       # a bare host: port 389
        self._sock = socket.create_connection(
            (host or "127.0.0.1", int(port or 389)), timeout=timeout)
        self._msgid = 0
        self._mu = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.sendall(ber(SEQUENCE, ber_int(self._msgid + 1)
                                   + ber(APP_UNBIND_REQUEST, b"")))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _send(self, op: bytes) -> int:
        self._msgid += 1
        self._sock.sendall(ber(SEQUENCE, ber_int(self._msgid) + op))
        return self._msgid

    def _recv_msg(self) -> tuple[int, int, bytes]:
        """(message id, operation tag, operation content)."""
        first = self._recv_exact(2)[1]
        if first < 0x80:
            length = first
        else:
            length = int.from_bytes(self._recv_exact(first & 0x7F), "big")
        r = BERReader(self._recv_exact(length))
        _, mid = r.read_tlv()
        optag, opv = r.read_tlv()
        return decode_int(mid), optag, opv

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise LDAPError("connection closed by directory server")
            out += chunk
        return out

    def simple_bind(self, dn: str, password: str) -> bool:
        """True on success, False on invalidCredentials (49)."""
        with self._mu:
            mid = self._send(ber(APP_BIND_REQUEST,
                                 ber_int(3) + ber_str(dn)
                                 + ber_str(password, CTX_SIMPLE_AUTH)))
            rmid, optag, opv = self._recv_msg()
            if rmid != mid or optag != APP_BIND_RESPONSE:
                raise LDAPError("unexpected bind response")
            result = decode_int(BERReader(opv).read_tlv()[1])
            if result == 0:
                return True
            if result == 49:
                return False
            raise LDAPError(f"bind failed: resultCode={result}")

    def search(self, base_dn: str, filter_expr: str,
               attributes: list[str] | None = None,
               scope: int = SCOPE_SUB) -> list[tuple[str, dict]]:
        """[(dn, {attribute: [values]})] of the entries that match."""
        attrs = b"".join(ber_str(a) for a in (attributes or []))
        with self._mu:
            mid = self._send(ber(APP_SEARCH_REQUEST,
                                 ber_str(base_dn)
                                 + ber_int(scope, ENUMERATED)
                                 + ber_int(0, ENUMERATED)  # never deref
                                 + ber_int(0) + ber_int(0)  # no limits
                                 + ber(BOOLEAN, b"\x00")    # types only: no
                                 + parse_filter(filter_expr)
                                 + ber(SEQUENCE, attrs)))
            out = []
            while True:
                rmid, optag, opv = self._recv_msg()
                if rmid != mid:
                    raise LDAPError("interleaved response")
                if optag == APP_SEARCH_ENTRY:
                    out.append(_search_entry(opv))
                elif optag == APP_SEARCH_DONE:
                    code = decode_int(BERReader(opv).read_tlv()[1])
                    if code not in (0, 32):         # 32: noSuchObject
                        raise LDAPError(f"search failed: {code}")
                    return out
                else:
                    raise LDAPError(f"unexpected op 0x{optag:x}")


def _search_entry(opv: bytes) -> tuple[str, dict]:
    r = BERReader(opv)
    _, dn = r.read_tlv()
    _, attrseq = r.read_tlv()
    attrs: dict[str, list[str]] = {}
    ar = BERReader(attrseq)
    while not ar.eof():
        er = BERReader(ar.read_tlv()[1])
        _, name = er.read_tlv()
        vr = BERReader(er.read_tlv()[1])
        vals = []
        while not vr.eof():
            vals.append(vr.read_tlv()[1].decode())
        attrs[name.decode()] = vals
    return dn.decode(), attrs


# -- config and the lookup-bind flow --------------------------------------------

@dataclass
class LDAPConfig:
    """The ``identity_ldap`` keys (cmd/config/identity/ldap/config.go)."""
    server_addr: str = ""
    lookup_bind_dn: str = ""
    lookup_bind_password: str = ""
    user_dn_search_base_dn: str = ""
    user_dn_search_filter: str = ""          # %s: the username
    group_search_filter: str = ""            # %s: the username, %d: the DN
    group_search_base_dn: str = ""
    sts_expiry_s: int = 3600

    @property
    def enabled(self) -> bool:
        return bool(self.server_addr)

    @classmethod
    def from_config(cls, cfg) -> "LDAPConfig":
        def get(key, default=""):
            return cfg.get("identity_ldap", key) or default
        return cls(
            server_addr=get("server_addr"),
            lookup_bind_dn=get("lookup_bind_dn"),
            lookup_bind_password=get("lookup_bind_password"),
            user_dn_search_base_dn=get("user_dn_search_base_dn"),
            user_dn_search_filter=get("user_dn_search_filter"),
            group_search_filter=get("group_search_filter"),
            group_search_base_dn=get("group_search_base_dn"),
            sts_expiry_s=_parse_duration(get("sts_expiry", "1h")))


def _parse_duration(s: str) -> int:
    """'1h' / '30m' / '90s' / a bare number -> whole seconds; 3600 for
    what does not parse."""
    s = s.strip().lower()
    mult = 1
    for suffix, m in (("h", 3600), ("m", 60), ("s", 1)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    try:
        return int(float(s) * mult)
    except ValueError:
        return 3600


@dataclass
class LDAPIdentity:
    """Bind and resolve against the configured directory
    (cmd/config/identity/ldap/ldap.go Bind, lookup-bind mode)."""
    config: LDAPConfig

    def bind(self, username: str, password: str) -> tuple[str, list[str]]:
        """(the user's DN, its group DNs) once the password checks out;
        LDAPError otherwise."""
        cfg = self.config
        if not cfg.enabled:
            raise LDAPError("LDAP is not configured")
        if not username or not password:
            raise LDAPError("empty LDAP credentials")
        lookup = LDAPClient(cfg.server_addr)
        try:
            if not lookup.simple_bind(cfg.lookup_bind_dn,
                                      cfg.lookup_bind_password):
                raise LDAPError("lookup bind rejected")
            entries = lookup.search(
                cfg.user_dn_search_base_dn,
                cfg.user_dn_search_filter.replace(
                    "%s", _escape_filter(username)), attributes=[])
            if len(entries) != 1:
                raise LDAPError(
                    f"user search matched {len(entries)} entries")
            user_dn = entries[0][0]
            # a failed bind spoils its connection: check on another
            verify = LDAPClient(cfg.server_addr)
            try:
                if not verify.simple_bind(user_dn, password):
                    raise LDAPError("invalid credentials")
            finally:
                verify.close()
            groups: list[str] = []
            if cfg.group_search_filter:
                gfilt = cfg.group_search_filter \
                    .replace("%d", _escape_filter(user_dn)) \
                    .replace("%s", _escape_filter(username))
                base = cfg.group_search_base_dn or cfg.user_dn_search_base_dn
                groups = [dn for dn, _ in lookup.search(base, gfilt,
                                                        attributes=[])]
            return user_dn, groups
        finally:
            lookup.close()

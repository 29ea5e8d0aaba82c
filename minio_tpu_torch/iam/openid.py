"""OpenID Connect tokens for AssumeRoleWithWebIdentity
(``minio_tpu/iam/openid.py``, cmd/config/identity/openid with
cmd/sts-handlers.go).

A web-identity JWT is checked against the ``identity_openid`` subsystem:
its signature (HS256 under ``hs256_secret``, or RS256 under a key of the
JWKS given inline in ``jwks`` or in the file ``jwks_file``; there is no
discovery fetch), ``exp``, ``iss`` and ``aud`` or ``azp``; its policy
names come from the ``claim_name`` claim.  RS256 is verified here
(RSASSA-PKCS1-v1_5 with SHA-256, RFC 8017 §8.2.2) with Python's own
integers, so no crypto library is needed.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field

from .sts import _b64url_dec

# DER of DigestInfo(sha256, NULL) before the 32-byte hash (RFC 8017 §9.2)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


class OpenIDError(Exception):
    pass


def rs256_verify(n: int, e: int, signing_input: bytes, sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256: the signature as long
    as the modulus and below it, and ``sig^e mod n`` exactly
    ``00 01 FF.. 00 || DigestInfo || SHA-256(signing_input)``.  Keys that
    are not a valid public key (an even or too small ``e`` or ``n``, ``e``
    not below ``n``) verify nothing."""
    if n < 3 or n % 2 == 0 or e < 3 or e % 2 == 0 or e >= n:
        return False
    k = (n.bit_length() + 7) // 8
    t = SHA256_DIGEST_INFO + hashlib.sha256(signing_input).digest()
    if len(sig) != k or k < len(t) + 11:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    return hmac.compare_digest(
        em, b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t)


def _rs256_verify(jwk: dict, signing_input: bytes, sig: bytes) -> bool:
    try:
        n = int.from_bytes(_b64url_dec(jwk["n"]), "big")
        e = int.from_bytes(_b64url_dec(jwk["e"]), "big")
    except Exception:  # noqa: BLE001 — a key that does not decode
        return False
    return rs256_verify(n, e, signing_input, sig)


@dataclass
class OpenIDProvider:
    issuer: str
    client_id: str                       # the expected audience
    claim_name: str = "policy"           # the claim naming the policies
    jwks: dict = field(default_factory=dict)     # {"keys": [...]}
    hs256_secret: str = ""

    @classmethod
    def from_config(cls, cfg) -> "OpenIDProvider | None":
        """The provider of the ``identity_openid`` subsystem; None unless
        ``enable`` is on.  An inline ``jwks`` wins over ``jwks_file``."""
        if cfg.get("identity_openid", "enable") != "on":
            return None
        jwks = {}
        path = cfg.get("identity_openid", "jwks_file")
        if path:
            with open(path) as f:
                jwks = json.load(f)
        inline = cfg.get("identity_openid", "jwks")
        if inline:
            jwks = json.loads(inline)
        return cls(issuer=cfg.get("identity_openid", "issuer"),
                   client_id=cfg.get("identity_openid", "client_id"),
                   claim_name=cfg.get("identity_openid", "claim_name")
                   or "policy",
                   jwks=jwks,
                   hs256_secret=cfg.get("identity_openid", "hs256_secret"))

    def _verify_signature(self, header: dict, signing_input: bytes,
                          sig: bytes) -> None:
        alg = header.get("alg", "")
        if alg == "HS256":
            if not self.hs256_secret:
                raise OpenIDError("HS256 token but no shared secret "
                                  "configured")
            want = hmac.new(self.hs256_secret.encode(), signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise OpenIDError("bad token signature")
            return
        if alg == "RS256":
            kid = header.get("kid")
            keys = [k for k in self.jwks.get("keys", [])
                    if k.get("kty") == "RSA" and
                    (kid is None or k.get("kid") == kid)]
            if not keys:
                raise OpenIDError(f"no RSA key for kid={kid!r}")
            if any(_rs256_verify(k, signing_input, sig) for k in keys):
                return
            raise OpenIDError("bad token signature")
        raise OpenIDError(f"unsupported alg {alg!r}")

    def authenticate(self, token: str) -> dict:
        """A web-identity JWT's claims once it checks out; OpenIDError
        otherwise."""
        try:
            h64, c64, s64 = token.split(".")
            header = json.loads(_b64url_dec(h64))
            claims = json.loads(_b64url_dec(c64))
            sig = _b64url_dec(s64)
        except (ValueError, json.JSONDecodeError) as e:
            raise OpenIDError("malformed JWT") from e
        self._verify_signature(header, f"{h64}.{c64}".encode(), sig)
        if claims.get("exp", 0) < time.time():
            raise OpenIDError("token expired")
        if self.issuer and claims.get("iss") != self.issuer:
            raise OpenIDError(f"issuer mismatch: {claims.get('iss')!r}")
        aud = claims.get("aud", "")
        auds = aud if isinstance(aud, list) else [aud]
        if self.client_id and self.client_id not in auds and \
                claims.get("azp") != self.client_id:
            raise OpenIDError("audience mismatch")
        if not claims.get("sub"):
            raise OpenIDError("token has no sub")
        return claims

    def policies_of(self, claims: dict) -> list[str]:
        """The policy names of the configured claim: a comma list or a
        JSON array."""
        v = claims.get(self.claim_name, "")
        if isinstance(v, list):
            return [str(p) for p in v]
        return [p.strip() for p in str(v).split(",") if p.strip()]

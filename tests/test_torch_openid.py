"""The port's OpenID tokens (``iam/openid.py``) and
AssumeRoleWithWebIdentity against ``minio_tpu``'s.

HS256 and RS256 tokens, good and bad, are accepted or refused alike, with
the same claims or the same message.  The RS256 keys are made and the
tokens signed with ``cryptography``, so the port's own RSASSA-PKCS1-v1_5
verify is held against the reference's, which calls ``cryptography``:
a tampered byte, the wrong key, a signature one byte short or long, one
not below the modulus, another digest's DigestInfo and a padding with too
few FF bytes are refused by both.  Over HTTP, both servers built with the
same ``identity_openid`` settings (an HS256 secret and an inline JWKS)
answer the same forms with the same status and XML, their request id and
credentials masked; the sessions' tokens carry the same claims and their
requests are authorised alike."""

import base64
import hashlib
import json

import pytest

from minio_tpu.iam import openid as ref_oidc
from minio_tpu_torch.iam import openid as port_oidc

from ._torch_control import client, servers
from ._torch_ident import (CLIENT, HS_SECRET, ISSUER, b64url, claims,
                           hs256_token, jwk_of, masked, no_state_left,
                           rs256_token, rsa_key, session_of, set_env,
                           sts_post, token_claims)


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with no_state_left():
        yield


@pytest.fixture(scope="module")
def keys():
    """(the JWKS's key, another key, the JWKS)."""
    k1, k2 = rsa_key(), rsa_key()
    return k1, k2, {"keys": [jwk_of(k1, "k1"),
                             {"kty": "oct", "kid": "k9", "k": "x"}]}


def _raw_signed(key, em: bytes) -> bytes:
    """``em`` raised to the private exponent: a signature whose padding
    is whatever ``em`` holds."""
    priv = key.private_numbers()
    n = priv.public_numbers.n
    k = (n.bit_length() + 7) // 8
    return pow(int.from_bytes(em, "big"), priv.d, n).to_bytes(k, "big")


def _resigned(token: str, sig: bytes) -> str:
    h, c, _ = token.split(".")
    return f"{h}.{c}.{b64url(sig)}"


def _sig(token: str) -> bytes:
    s = token.split(".")[2]
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _token(name: str, k1, k2) -> str:
    """The token of case ``name``."""
    from cryptography.hazmat.primitives import hashes
    good = rs256_token(k1, claims(policy="readonly"))
    n = k1.public_key().public_numbers().n
    k = (n.bit_length() + 7) // 8
    if name == "rs-short-padding":
        h, c, _ = good.split(".")
        t = port_oidc.SHA256_DIGEST_INFO + hashlib.sha256(
            f"{h}.{c}".encode()).digest()
        em = b"\x00\x01" + b"\xff" * 7 + b"\x00" + \
            b"\x01" * (k - len(t) - 10) + t
        return _resigned(good, _raw_signed(k1, em))
    flipped = bytearray(_sig(good))
    flipped[len(flipped) // 2] ^= 1
    return {
        "hs-good": hs256_token(claims()),
        "hs-expired": hs256_token(claims(exp=1)),
        "hs-wrong-iss": hs256_token(claims(iss="https://evil")),
        "hs-wrong-aud": hs256_token(claims(aud="other-app")),
        "hs-azp": hs256_token(claims(aud="other-app", azp=CLIENT)),
        "hs-aud-list": hs256_token(claims(aud=["x", CLIENT])),
        "hs-no-sub": hs256_token(claims(sub=None)),
        "hs-bad-secret": hs256_token(claims(), secret="wrong"),
        "malformed": "garbage",
        "alg-none": b64url(json.dumps({"alg": "none"}).encode()) + "." +
        b64url(json.dumps(claims()).encode()) + ".",
        "rs-good": good,
        "rs-no-kid": rs256_token(k1, claims(), kid=None),
        "rs-unknown-kid": rs256_token(k1, claims(), kid="k7"),
        "rs-tampered": _resigned(good, bytes(flipped)),
        "rs-wrong-key": rs256_token(k2, claims()),
        "rs-short-sig": _resigned(good, _sig(good)[1:]),
        "rs-long-sig": _resigned(good, b"\x00" + _sig(good)),
        "rs-s-not-below-n": _resigned(good, n.to_bytes(k, "big")),
        "rs-sha1": rs256_token(k1, claims(), digest=hashes.SHA1()),
    }[name]


_CASES = ["hs-good", "hs-expired", "hs-wrong-iss", "hs-wrong-aud", "hs-azp",
          "hs-aud-list", "hs-no-sub", "hs-bad-secret", "malformed",
          "alg-none", "rs-good", "rs-no-kid", "rs-unknown-kid",
          "rs-tampered", "rs-wrong-key", "rs-short-sig", "rs-long-sig",
          "rs-s-not-below-n", "rs-sha1", "rs-short-padding"]


def _outcome(provider, token: str):
    try:
        c = provider.authenticate(token)
        return ("ok", c, provider.policies_of(c))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", _CASES)
def test_tokens_are_judged_alike(keys, name):
    k1, k2, jwks = keys
    token = _token(name, k1, k2)
    got = [_outcome(mod.OpenIDProvider(issuer=ISSUER, client_id=CLIENT,
                                       jwks=jwks, hs256_secret=HS_SECRET),
                    token) for mod in (port_oidc, ref_oidc)]
    assert got[0] == got[1]
    assert (got[0][0] == "ok") == (name in ("hs-good", "hs-azp",
                                            "hs-aud-list", "rs-good",
                                            "rs-no-kid"))


def test_policy_claims_and_config_alike(tmp_path):
    claims_forms = [{"policy": "a, b,c"}, {"policy": ["x", 3]}, {},
                    {"groups": "g1"}, {"policy": ""}]
    for name in ("policy", "groups"):
        for c in claims_forms:
            assert port_oidc.OpenIDProvider("i", "c", name).policies_of(c) \
                == ref_oidc.OpenIDProvider("i", "c", name).policies_of(c)
    jwks_file = tmp_path / "jwks.json"
    jwks_file.write_text(json.dumps({"keys": [{"kty": "RSA", "kid": "f"}]}))
    for values in ({"enable": "off"},
                   {"enable": "on", "issuer": ISSUER, "client_id": CLIENT,
                    "claim_name": "", "jwks_file": str(jwks_file)},
                   {"enable": "on", "jwks_file": str(jwks_file),
                    "jwks": '{"keys": []}', "hs256_secret": "s"}):
        class Cfg:
            @staticmethod
            def get(subsys, key, v=values):
                return v.get(key, "")
        p = port_oidc.OpenIDProvider.from_config(Cfg)
        r = ref_oidc.OpenIDProvider.from_config(Cfg)
        assert (p and p.__dict__) == (r and r.__dict__)


# -- AssumeRoleWithWebIdentity over HTTP ------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory, keys):
    with pytest.MonkeyPatch.context() as mp:
        set_env(mp, "identity_openid", {
            "enable": "on", "issuer": ISSUER, "client_id": CLIENT,
            "hs256_secret": HS_SECRET, "jwks": json.dumps(keys[2])})
        with servers(tmp_path_factory.mktemp("oidc"), mp) as (ref, port):
            assert port.openid is not None and ref.openid is not None
            for srv in (ref, port):
                c = client(srv)
                c.make_bucket("oidcbkt")
                c.put_object("oidcbkt", "obj", b"oidc-data")
            yield ref, port


def _form(name: str, k1, k2) -> dict:
    action = "AssumeRoleWithWebIdentity"
    extra = {}
    if name == "no-policy":
        tok = hs256_token(claims(policy=None))
    elif name == "unknown-policy":
        tok = hs256_token(claims(policy="readonly,nosuch"))
    elif name == "policy-list":
        tok = hs256_token(claims(policy=["readonly", "writeonly"]))
    elif name == "no-token":
        tok = ""
    elif name == "client-grants":
        action, tok = "AssumeRoleWithClientGrants", hs256_token(claims())
    else:
        tok = _token({"bad-duration": "hs-good",
                      "short-duration": "hs-good"}.get(name, name), k1, k2)
        extra = {"bad-duration": {"DurationSeconds": "x"},
                 "short-duration": {"DurationSeconds": "10"}}.get(name, {})
    return {"Action": action, "Version": "2011-06-15",
            "WebIdentityToken": tok, **extra}


@pytest.mark.parametrize("name", [
    "hs-good", "rs-good", "policy-list", "client-grants", "hs-expired",
    "hs-wrong-aud", "rs-tampered", "no-policy", "unknown-policy",
    "no-token", "bad-duration", "short-duration"])
def test_sts_web_identity_answers_and_authorises_alike(pair, keys, name):
    ref, port = pair
    form = _form(name, keys[0], keys[1])
    r, p = sts_post(ref, form), sts_post(port, form)
    assert p.status == r.status
    assert masked(p.body) == masked(r.body)
    if r.status != 200:
        return
    assert token_claims(p.body) == token_claims(r.body)
    rows = []
    for srv, body in ((ref, r.body), (port, p.body)):
        sess = session_of(srv, body)
        rows.append([
            sess.get_object("oidcbkt", "obj", expect=()).status,
            sess.request("PUT", "/oidcbkt/new", body=b"x", expect=()).status,
            sess.request("GET", "/oidcbkt", expect=()).status])
    assert rows[0] == rows[1]

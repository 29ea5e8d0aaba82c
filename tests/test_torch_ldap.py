"""The port's LDAP identities (``iam/ldap.py``) and
AssumeRoleWithLDAPIdentity against ``minio_tpu``'s.

The BER codec, the RFC 4515 filters and their escaping give the same
bytes (or the same refusal) for inputs drawn from a numpy seed; the
lookup-bind flow against the directory of ``tests/ldap_stub.py`` (which
decodes with the reference's codec) resolves the same DN and groups and
refuses alike.  Over HTTP, both servers built with the same
``identity_ldap`` settings map DNs through ``set-user-policy`` alike and
answer the same STS forms with the same status and XML, their request id
and credentials masked; the sessions' tokens carry the same claims and
their requests are authorised alike."""

import json

import numpy as np
import pytest

from minio_tpu.iam import ldap as ref_ldap
from minio_tpu_torch.iam import ldap as port_ldap

from . import ldap_stub
from ._torch_control import both, client, servers
from ._torch_ident import (ADMINS, READERS, USERS, ldap_settings, masked,
                           no_state_left, session_of, set_env, sts_post,
                           stub_running, token_claims)


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with no_state_left():
        yield


def _directory():
    d = ldap_stub.standard_directory()
    d.add(f"uid=svc-carol,{USERS}", uid="svc-carol",
          userPassword="carol-pass", objectClass=["person"])
    d.add(f"uid=a*b (x),{USERS}", uid="a*b (x)", userPassword="odd-pass",
          objectClass=["person"])
    return d


@pytest.fixture(scope="module")
def directory():
    with stub_running(ldap_stub.StubLDAPServer(_directory())) as addr:
        yield addr


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return (type(e).__name__, str(e))


# -- the codec ------------------------------------------------------------------

_SPECIAL = "*()\\\x00"


def _value(rng, n: int) -> str:
    chars = "abcxyz019 =,-" + _SPECIAL + "é"
    return "".join(chars[i] for i in rng.integers(0, len(chars), n))


def _filter(rng, depth: int) -> str:
    kind = int(rng.integers(0, 6 if depth < 3 else 2))
    attr = ("uid", "cn", "member", "objectClass")[int(rng.integers(0, 4))]
    if kind == 0:
        return f"({attr}={port_ldap._escape_filter(_value(rng, 6))})"
    if kind == 1:
        return f"({attr}=*)"
    if kind == 5:
        return f"(!{_filter(rng, depth + 1)})"
    op = "&" if kind in (2, 3) else "|"
    parts = "".join(_filter(rng, depth + 1)
                    for _ in range(int(rng.integers(1, 4))))
    return f"({op}{parts})"


_BAD_FILTERS = ["uid=x", "(uid=x", "(uidx)", "(&(uid=x)", "(uid=x))",
                "(uid=\\zz)", "", "(&(uid=a)(cn=b)x)"]


@pytest.mark.parametrize("case", range(16))
def test_codec_matches_the_reference(case):
    rng = np.random.default_rng(case)
    n = int(rng.integers(0, 1 << int(rng.integers(1, 40))))
    blob = rng.bytes(int(rng.integers(0, 300)))
    for mod_args in ((n,), (n, port_ldap.ENUMERATED)):
        assert port_ldap.ber_int(*mod_args) == ref_ldap.ber_int(*mod_args)
    for length in (len(blob), len(blob) << 9, len(blob) << 17):
        assert port_ldap.ber_len(length) == ref_ldap.ber_len(length)
    assert port_ldap.ber_str(blob) == ref_ldap.ber_str(blob)
    text = _value(rng, int(rng.integers(0, 20)))
    assert port_ldap.ber_str(text, port_ldap.FILTER_PRESENT) == \
        ref_ldap.ber_str(text, ref_ldap.FILTER_PRESENT)
    assert port_ldap._escape_filter(text) == ref_ldap._escape_filter(text)
    filt = _filter(rng, 0)
    enc = port_ldap.parse_filter(filt)
    assert enc == ref_ldap.parse_filter(filt)
    msg = port_ldap.ber(port_ldap.SEQUENCE,
                        port_ldap.ber_int(n) + enc + port_ldap.ber_str(blob))
    tlvs = []
    for mod in (port_ldap, ref_ldap):
        r = mod.BERReader(msg)
        _, body = r.read_tlv()
        inner = mod.BERReader(body)
        got = []
        while not inner.eof():
            got.append(inner.read_tlv())
        tlvs.append((got, mod.decode_int(got[0][1])))
    assert tlvs[0] == tlvs[1] and tlvs[0][1] == n
    bad = _BAD_FILTERS[case % len(_BAD_FILTERS)]
    assert _outcome(port_ldap.parse_filter, bad) == \
        _outcome(ref_ldap.parse_filter, bad)
    cut = msg[:int(rng.integers(1, len(msg)))]
    assert _outcome(lambda b: port_ldap.BERReader(b).read_tlv(), cut) == \
        _outcome(lambda b: ref_ldap.BERReader(b).read_tlv(), cut)


# -- the lookup-bind flow ---------------------------------------------------------

@pytest.mark.parametrize("user,password,settings", [
    ("svc-alice", "alice-pass", {}),
    ("svc-bob", "bob-pass", {}),
    ("svc-carol", "carol-pass", {}),
    ("a*b (x)", "odd-pass", {}),
    ("svc-alice", "wrong", {}),
    ("nobody", "x", {}),
    ("svc-*", "alice-pass", {}),
    ("svc-alice", "", {}),
    ("svc-alice", "alice-pass", {"lookup_bind_password": "nope"}),
    ("svc-alice", "alice-pass", {"group_search_filter": ""}),
    ("svc-alice", "alice-pass", {"sts_expiry": "90m"}),
], ids=["alice", "bob", "carol-no-group", "escaped-uid", "bad-password",
        "unknown-user", "wildcard-user", "empty-password", "bad-lookup",
        "no-group-filter", "expiry"])
def test_bind_resolves_and_refuses_alike(directory, user, password,
                                         settings):
    values = {**ldap_settings(directory), **settings}

    class Cfg:
        @staticmethod
        def get(subsys, key):
            assert subsys == "identity_ldap"
            return values.get(key, "")

    out = []
    for mod in (port_ldap, ref_ldap):
        cfg = mod.LDAPConfig.from_config(Cfg)
        out.append((cfg.__dict__, _outcome(mod.LDAPIdentity(cfg).bind,
                                           user, password)))
    assert out[0] == out[1]


def test_client_search_and_bind_alike(directory):
    out = []
    for mod in (port_ldap, ref_ldap):
        c = mod.LDAPClient(directory)
        try:
            out.append((c.simple_bind("cn=lookup,dc=example,dc=org",
                                      "lookup-secret"),
                        c.search("dc=example,dc=org", "(objectClass=*)",
                                 attributes=["uid"]),
                        c.search("dc=example,dc=org",
                                 "(|(uid=svc-bob)(cn=zz))"),
                        c.simple_bind("uid=svc-bob," + USERS, "nope")))
        finally:
            c.close()
    assert out[0] == out[1]
    assert out[0][0] is True and out[0][3] is False


# -- AssumeRoleWithLDAPIdentity over HTTP ------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory, directory):
    with pytest.MonkeyPatch.context() as mp:
        set_env(mp, "identity_ldap", ldap_settings(directory))
        with servers(tmp_path_factory.mktemp("ldap"), mp) as (ref, port):
            assert port.ldap is not None and ref.ldap is not None
            for srv in (ref, port):
                c = client(srv)
                c.make_bucket("ldapbkt")
                c.put_object("ldapbkt", "obj", b"ldap-data")
            for dn, pols in ((READERS, "readonly"),
                             (ADMINS, "readwrite,writeonly"),
                             ("uid=ghost," + USERS, "readonly")):
                r, p = both(ref, port, "POST",
                            "/minio-tpu/admin/v1/set-user-policy",
                            f"accessKey={dn}&policies={pols}")
                assert p.status == r.status == 200
                assert json.loads(p.body) == json.loads(r.body)
            yield ref, port


_FORMS = {
    "alice": {"LDAPUsername": "svc-alice", "LDAPPassword": "alice-pass"},
    "bob-900": {"LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
                "DurationSeconds": "900"},
    "bob-session-policy": {
        "LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
        "Policy": json.dumps({"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:ListBucket"],
             "Resource": ["arn:aws:s3:::*"]}]})},
    "bad-password": {"LDAPUsername": "svc-alice", "LDAPPassword": "nope"},
    "unknown-user": {"LDAPUsername": "nobody", "LDAPPassword": "x"},
    "no-password": {"LDAPUsername": "svc-alice"},
    "unmapped": {"LDAPUsername": "svc-carol", "LDAPPassword": "carol-pass"},
    "long-policy": {"LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
                    "Policy": "x" * 2049},
    "bad-policy": {"LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
                   "Policy": "{"},
    "bad-duration": {"LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
                     "DurationSeconds": "x"},
    "short-duration": {"LDAPUsername": "svc-bob", "LDAPPassword": "bob-pass",
                       "DurationSeconds": "10"},
}


@pytest.mark.parametrize("name", sorted(_FORMS))
def test_sts_ldap_answers_and_authorises_alike(pair, name):
    ref, port = pair
    form = {"Action": "AssumeRoleWithLDAPIdentity", "Version": "2011-06-15",
            **_FORMS[name]}
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
            sess.get_object("ldapbkt", "obj", expect=()).status,
            sess.request("PUT", "/ldapbkt/new", body=b"x", expect=()).status,
            sess.request("GET", "/ldapbkt", expect=()).status,
            sess.request("HEAD", "/ldapbkt/obj", expect=()).status])
    assert rows[0] == rows[1]

"""The port's IAMSys, STS and admin identity routes against
``minio_tpu``'s.

In the layer: the same mutations (policies, users, their status,
service accounts, groups, STS sessions) leave byte-equal sealed
``config/iam.json`` on every drive of both packages' metadata sets, with
``os.urandom`` pinned (``_torch_iam.pin_random``); each package loads
the other's, and one sealed under an old secret is loaded and resealed
alike; both answer ``lookup_secret`` and ``is_allowed`` alike for every
identity.  STS tokens are the same bytes and verify alike.  Over HTTP
(``_torch_control.servers``): the same admin identity calls answer the
same status and JSON, AssumeRole the same credentials, and a session's
requests (its token missing, wrong or right) the same status; an
identity allowed ``admin:*`` is admitted to the admin API."""

import json

import pytest

from minio_tpu.iam import policy as ref_pol
from minio_tpu.iam import sts as ref_sts
from minio_tpu.iam.sys import IAMSys as RefIAM
from minio_tpu_torch.iam import policy as port_pol
from minio_tpu_torch.iam import sts as port_sts
from minio_tpu_torch.iam.sys import IAMSys as PortIAM
from minio_tpu_torch.s3.client import S3Client

from ._torch_control import AK, PER, SK, both, client, servers
from ._torch_iam import T_NOW, pin_random, sealed
from ._torch_versions import close, port_layer, ref_layer

ALPHA_RW = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:*"],
     "Resource": ["arn:aws:s3:::alpha", "arn:aws:s3:::alpha/*"]},
    {"Effect": "Deny", "Action": ["s3:DeleteObject"],
     "Resource": ["arn:aws:s3:::alpha/keep/*"]}]}
GET_ONLY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject"],
     "Resource": ["arn:aws:s3:::*"]}]})
ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
           "s3:ListBucket", "admin:*"]
RESOURCES = ["alpha", "alpha/k", "alpha/keep/k", "beta/k"]


def _mutate(iam, pol) -> list:
    """The same mutations on either package's IAMSys; what each
    returned that is drawn at random (keys, the session)."""
    out = []
    iam.set_policy("alpha-rw", pol.Policy.from_json(json.dumps(ALPHA_RW)))
    iam.add_user("u1", "u1-secret-key", ["alpha-rw"])
    iam.add_user("u2", "u2-secret-key", ["readonly"])
    sa = iam.new_service_account("u1")
    out.append((sa.access_key, sa.secret_key, sa.policies))
    iam.new_service_account("u2", "sa-fixed", "sa-fixed-secret")
    iam.set_group_policy("writers", ["writeonly"])
    iam.add_user_to_group("u2", "writers")
    creds = iam.assume_role("u1", 900, GET_ONLY)
    out.append((creds.access_key, creds.secret_key, creds.session_token,
                creds.expiration))
    iam.add_user("u3", "u3-secret-key", ["consoleAdmin"])
    iam.set_user_status("u3", False)
    iam.attach_policy("u2", ["readonly", "alpha-rw"])
    iam.set_policy("tmp", pol.Policy.from_json(GET_ONLY))
    iam.delete_policy("tmp")
    iam.add_user("u4", "u4-secret-key")
    iam.remove_user("u4")
    return out


@pytest.fixture
def layers(tmp_path, monkeypatch):
    pin_random(monkeypatch)
    ref = ref_layer(tmp_path / "ref")
    port = port_layer(tmp_path / "port")
    yield ref, port, tmp_path
    close(ref, port)


def _verdicts(iam, keys) -> list:
    return [(k, iam.lookup_secret(k), [
        iam.is_allowed(k, a, r) for a in ACTIONS for r in RESOURCES] + [
        iam.session_policy_allows(k, a, r) for a in ACTIONS
        for r in RESOURCES]) for k in keys]


def test_mutations_seal_the_same_bytes(layers):
    ref_l, port_l, root = layers
    ref = RefIAM(ref_l, AK, SK)
    port = PortIAM(port_l, AK, SK)
    drawn = _mutate(ref, ref_pol)
    assert _mutate(port, port_pol) == drawn
    want = sealed(root / "ref", 6, "config/iam.json")
    got = sealed(root / "port", 6, "config/iam.json")
    assert got == want and len(set(got)) == 1
    keys = [AK, "u1", "u2", "u3", "u4", drawn[0][0], "sa-fixed",
            drawn[1][0], "nobody"]
    assert _verdicts(port, keys) == _verdicts(ref, keys)
    assert [u.to_dict() for u in port.list_users()] == \
        [u.to_dict() for u in ref.list_users()]
    assert [u.to_dict() for u in port.list_service_accounts("u1")] == \
        [u.to_dict() for u in ref.list_service_accounts("u1")]
    assert port.list_groups() == ref.list_groups()
    assert port.list_policies() == ref.list_policies()


def test_each_loads_the_others_state(layers):
    ref_l, port_l, root = layers
    keys = [AK, "u1", "u2", "u3", "sa-fixed", "nobody"]
    for writer_l, (w_cls, w_pol), tag, r_cls, r_layer in (
            (ref_l, (RefIAM, ref_pol), "ref", PortIAM, port_layer),
            (port_l, (PortIAM, port_pol), "port", RefIAM, ref_layer)):
        writer = w_cls(writer_l, AK, SK)
        drawn = _mutate(writer, w_pol)
        # a layer of the other package over the writer's drives
        lay = r_layer(root / tag)
        try:
            reader = r_cls(lay, AK, SK)
            reader.load()
            ks = keys + [drawn[0][0], drawn[1][0]]
            assert _verdicts(reader, ks) == _verdicts(writer, ks)
            assert reader.list_policies() == writer.list_policies()
            assert reader.get_policy("alpha-rw").to_json() == \
                writer.get_policy("alpha-rw").to_json()
        finally:
            close(lay)


def test_an_old_secret_is_resealed_alike(layers, monkeypatch):
    ref_l, port_l, root = layers
    for lay, cls, pol in ((ref_l, RefIAM, ref_pol),
                          (port_l, PortIAM, port_pol)):
        _mutate(cls(lay, AK, "old-root-secret"), pol)
    monkeypatch.setenv("MT_ADMIN_SECRET_OLD", "old-root-secret")
    pin_random(monkeypatch, seed=99)
    for lay, cls in ((ref_l, RefIAM), (port_l, PortIAM)):
        iam = cls(lay, AK, SK)
        iam.load()
        assert iam.lookup_secret("u1") == "u1-secret-key"
    want = sealed(root / "ref", 6, "config/iam.json")
    assert sealed(root / "port", 6, "config/iam.json") == want
    monkeypatch.delenv("MT_ADMIN_SECRET_OLD")
    fresh = PortIAM(port_l, AK, SK)      # the new secret alone opens it
    fresh.load()
    assert fresh.lookup_secret("u2") == "u2-secret-key"


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_each_reseals_the_others_old_blob(layers, monkeypatch, direction):
    """One package's ``iam.json`` sealed under a retired secret is loaded
    by the other, which reseals it; the first then opens it under the
    new secret alone."""
    ref_l, port_l, root = layers
    w_cls, w_pol, tag, r_cls, r_layer = \
        (RefIAM, ref_pol, "ref", PortIAM, port_layer) \
        if direction == "ref-to-port" else \
        (PortIAM, port_pol, "port", RefIAM, ref_layer)
    writer_l = ref_l if tag == "ref" else port_l
    _mutate(w_cls(writer_l, AK, "old-root-secret"), w_pol)
    old = sealed(root / tag, 6, "config/iam.json")
    monkeypatch.setenv("MT_ADMIN_SECRET_OLD", "old-root-secret")
    lay = r_layer(root / tag)
    try:
        r_cls(lay, AK, SK).load()
    finally:
        close(lay)
    monkeypatch.delenv("MT_ADMIN_SECRET_OLD")
    resealed = sealed(root / tag, 6, "config/iam.json")
    assert resealed != old and len(set(resealed)) == 1
    fresh = w_cls(writer_l, AK, SK)
    fresh.load()
    assert fresh.lookup_secret("u1") == "u1-secret-key"
    assert fresh.is_allowed("u1", "s3:PutObject", "alpha/k")


def test_expired_sessions_are_purged_alike(layers, monkeypatch):
    """Sessions minted an hour and a half ago have expired: they no
    longer authenticate, the next AssumeRole sweeps them, and so does
    ``purge_expired``; the sealed state stays byte-equal."""
    import types
    ref_l, port_l, root = layers
    counts = []
    for lay, cls, pol, sts in ((ref_l, RefIAM, ref_pol, ref_sts),
                               (port_l, PortIAM, port_pol, port_sts)):
        iam = cls(lay, AK, SK)
        _mutate(iam, pol)
        monkeypatch.setattr(sts, "time", types.SimpleNamespace(
            time=lambda: T_NOW - 5400))
        old = [iam.assume_role("u1", 900).access_key for _ in range(2)]
        monkeypatch.setattr(sts, "time", types.SimpleNamespace(
            time=lambda: T_NOW))
        counts.append([iam.lookup_secret(k) for k in old] +
                      [iam.purge_expired(), iam.purge_expired()])
    # the second mint swept the first; purge takes the second
    assert counts[0] == counts[1] == [None, None, 1, 0]
    want = sealed(root / "ref", 6, "config/iam.json")
    assert sealed(root / "port", 6, "config/iam.json") == want


def test_sts_tokens_equal_the_references(monkeypatch):
    pin_random(monkeypatch)
    want = ref_sts.mint("u1", SK, 3600)
    got = port_sts.mint("u1", SK, 3600)
    assert got == port_sts.TempCredentials(*want.__dict__.values())
    assert got.expiration == T_NOW + 3600
    for mod in (ref_sts, port_sts):
        claims = mod.verify_token(got.session_token, SK)
        assert claims == {"accessKey": got.access_key, "parent": "u1",
                          "exp": got.expiration}
        for bad, code in ((got.session_token + "x", "InvalidToken"),
                          ("a.b", "InvalidToken")):
            with pytest.raises(mod.STSError) as e:
                mod.verify_token(bad, SK)
            assert e.value.code == code
        with pytest.raises(mod.STSError):
            mod.verify_token(got.session_token, "other-secret")
        with pytest.raises(mod.STSError) as e:
            mod.mint("u1", SK, 60)
        assert e.value.code == "InvalidParameterValue"
    expired = port_sts.sign_token({"accessKey": "x", "exp": 1}, SK)
    for mod in (ref_sts, port_sts):
        with pytest.raises(mod.STSError) as e:
            mod.verify_token(expired, SK)
        assert e.value.code == "ExpiredToken"


# -- over HTTP ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("iam")
    try:
        pin_random(mp)
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                for b in ("alpha", "beta"):
                    client(srv).make_bucket(b)
            yield ref, port, root
    finally:
        mp.undo()


ADMIN_CALLS = [
    ("PUT", "policy/alpha-rw", "", json.dumps(ALPHA_RW).encode()),
    ("POST", "add-user", "", json.dumps({
        "accessKey": "u1", "secretKey": "u1-secret-key",
        "policies": ["alpha-rw"]}).encode()),
    ("POST", "add-user", "", json.dumps({
        "accessKey": "u2", "secretKey": "u2-secret-key",
        "policies": ["nosuch"]}).encode()),
    ("POST", "add-user", "", json.dumps({
        "accessKey": "u2", "secretKey": "u2-secret-key"}).encode()),
    ("POST", "add-user", "", b"{"),
    ("POST", "set-user-policy", "accessKey=u2&policies=readonly", b""),
    ("POST", "set-user-policy", "accessKey=ghost&policies=readonly", b""),
    ("POST", "set-user-status", "accessKey=u2&status=maybe", b""),
    ("POST", "set-user-status", "accessKey=u2&status=disabled", b""),
    ("POST", "set-user-status", "accessKey=u2&status=enabled", b""),
    ("GET", "list-users", "", b""),
    ("POST", "add-service-account", "", json.dumps(
        {"parent": "u1"}).encode()),
    ("POST", "add-service-account", "", json.dumps(
        {"parent": "u1", "accessKey": "sa-1",
         "secretKey": "sa-1-secret"}).encode()),
    ("GET", "list-service-accounts", "parent=u1", b""),
    ("POST", "delete-service-account", "accessKey=u2", b""),
    ("POST", "delete-service-account", "accessKey=ghost", b""),
    ("POST", "set-group-policy", "", json.dumps(
        {"group": "writers", "policies": ["writeonly"]}).encode()),
    ("POST", "add-user-to-group", "accessKey=u2&group=writers", b""),
    ("GET", "list-groups", "", b""),
    ("GET", "policy", "", b""),
    ("GET", "policy/alpha-rw", "", b""),
    ("GET", "policy/nosuch", "", b""),
    ("DELETE", "policy/readonly", "", b""),
    ("POST", "add-user", "", json.dumps({
        "accessKey": "ops", "secretKey": "ops-secret-key",
        "policies": ["consoleAdmin"]}).encode()),
    ("POST", "add-user", "", json.dumps({
        "accessKey": "gone", "secretKey": "gone-secret-key"}).encode()),
    ("POST", "remove-user", "accessKey=gone", b""),
    ("POST", "remove-user", "accessKey=gone", b""),
]


# the calls where the reference answers 500: the names it binds inside
# ``handle`` make its NoSuchUser and NoSuchPolicy handlers raise
# UnboundLocalError (ROADMAP Queue 3 item 24); the port answers 404
REF_500 = {("POST", "add-user", 2), ("POST", "delete-service-account", 15),
           ("GET", "policy/nosuch", 21), ("DELETE", "policy/readonly", 22),
           ("POST", "remove-user", 26)}


def test_admin_identity_routes_answer_alike(pair):
    ref, port, root = pair
    for i, (method, route, query, body) in enumerate(ADMIN_CALLS):
        r, p = both(ref, port, method, f"/minio-tpu/admin/v1/{route}",
                    query, body)
        if (method, route, i) in REF_500:
            assert (r.status, r.xml().findtext("Code")) == \
                (500, "InternalError")
            assert p.status == 404 and "error" in json.loads(p.body)
            continue
        assert (p.status, json.loads(p.body)) == \
            (r.status, json.loads(r.body)), (method, route, query)
    want = sealed(root / "ref", PER, "config/iam.json")
    assert sealed(root / "port", PER, "config/iam.json") == want


def test_admin_api_admits_identities_allowed_admin(pair):
    ref, port, _ = pair
    for srv in (ref, port):
        ops = client(srv, "ops", "ops-secret-key").request(
            "GET", "/minio-tpu/admin/v1/list-users", expect=())
        u1 = client(srv, "u1", "u1-secret-key").request(
            "GET", "/minio-tpu/admin/v1/list-users", expect=())
        assert ops.status == 200 and "u1" in json.loads(ops.body)
        assert (u1.status, u1.xml().findtext("Code")) == (403, "AccessDenied")


def _sts(srv, key, secret, form: dict):
    import urllib.parse
    return client(srv, key, secret).request(
        "POST", "/", body=urllib.parse.urlencode(form).encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        expect=())


def _strip_request_id(body: bytes) -> bytes:
    import re
    return re.sub(rb"<RequestId>[0-9a-f]+</RequestId>", b"", body)


@pytest.mark.parametrize("form", [
    {"Action": "AssumeRole", "DurationSeconds": "900", "Policy": GET_ONLY},
    {"Action": "AssumeRole", "DurationSeconds": "10"},
    {"Action": "AssumeRole", "DurationSeconds": "x"},
    {"Action": "AssumeRole", "Policy": "{"},
    {"Action": "GetSessionToken"},
    {"Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": "t"},
    {"Action": "AssumeRoleWithLDAPIdentity", "LDAPUsername": "a",
     "LDAPPassword": "b"},
], ids=["assume", "short", "bad-duration", "bad-policy", "unknown", "oidc",
        "ldap"])
def test_sts_answers_alike(pair, form):
    ref, port, _ = pair
    r = _sts(ref, "u1", "u1-secret-key", form)
    p = _sts(port, "u1", "u1-secret-key", form)
    assert p.status == r.status
    assert _strip_request_id(p.body) == _strip_request_id(r.body)


def test_a_session_is_bounded_and_needs_its_token(pair):
    ref, port, root = pair
    out = []
    for srv in (ref, port):
        sess = client(srv, "u1", "u1-secret-key").assume_role(
            900, json.loads(GET_ONLY))
        c = client(srv)
        c.put_object("alpha", "s/k", b"session")
        rows = [sess.get_object("alpha", "s/k", expect=()).status,
                sess.request("PUT", "/alpha/s/k2", body=b"x",
                             expect=()).status,
                sess.request("GET", "/beta", expect=()).status]
        bare = S3Client(sess.endpoint, sess.access_key, sess.secret_key)
        wrong = S3Client(sess.endpoint, sess.access_key, sess.secret_key,
                         session_token=sess.session_token[:-2] + "xx")
        for cl in (bare, wrong):
            r = cl.get_object("alpha", "s/k", expect=())
            rows.append((r.status, r.xml().findtext("Code")))
        # a session cannot mint another
        r = _sts(srv, sess.access_key, sess.secret_key,
                 {"Action": "AssumeRole"})
        rows.append(r.status)
        out.append(rows)
    assert out[0] == out[1] == [200, 403, 403, (403, "AccessDenied"),
                                (403, "AccessDenied"), 403]

"""The port's bucket policies against ``minio_tpu``'s: the same documents
accepted, refused and written back, the same three-valued verdicts for
seeded principals, actions and resources; and over HTTP
(``_torch_control.servers``) the same answers to PUT, GET and DELETE
``?policy`` and to the anonymous and IAM requests a policy grants or
denies, on the buffered and the streamed PUT route.  A streamed PUT that
is refused answers 403 before its body is encoded (no codec launch, no
object, no staging file), and an anonymous one a policy allows is
admitted on that route."""

import json
import os

import numpy as np
import pytest

from minio_tpu.bucket import policy as ref_bp
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.bucket import policy as port_bp
from minio_tpu_torch.ops import hh, rs_kernels

from ._torch_control import AK, PER, SETS, SK, THRESHOLD, both, client, \
    servers
from ._torch_versions import body

PUBLIC = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Principal": {"AWS": ["*"]},
     "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::pol/pub/*"]},
    {"Effect": "Allow", "Principal": "*", "Action": ["s3:PutObject"],
     "Resource": ["arn:aws:s3:::pol/drop/*"]},
    {"Effect": "Deny", "Principal": {"AWS": "u1"},
     "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::pol/secret/*"]}]}


def _doc(rng) -> dict:
    principals = ["*", {"AWS": "*"}, {"AWS": ["u1"]}, {"AWS": ["u1", "u2"]}]
    actions = ["s3:GetObject", "s3:PutObject", "s3:*", "s3:List*"]
    resources = ["arn:aws:s3:::pol/*", "arn:aws:s3:::pol",
                 "arn:aws:s3:::pol/a/*", "pol/?"]
    conds = [None, {"StringEquals": {"aws:username": "u1"}},
             {"StringLike": {"s3:prefix": "a/*"}}]
    sts = []
    for _ in range(int(rng.integers(1, 4))):
        st = {"Effect": "Deny" if rng.random() < 0.3 else "Allow",
              "Principal": principals[rng.integers(0, 4)],
              "Action": actions[rng.integers(0, 4)],
              "Resource": [resources[i] for i in
                           rng.choice(4, rng.integers(1, 3))]}
        c = conds[rng.integers(0, 3)]
        if c:
            st["Condition"] = c
        sts.append(st)
    return {"Version": "2012-10-17", "Statement": sts}


@pytest.mark.parametrize("seed", range(6))
def test_verdicts_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        raw = json.dumps(_doc(rng)).encode()
        ref = ref_bp.BucketPolicy.parse(raw, "pol")
        port = port_bp.BucketPolicy.parse(raw, "pol")
        assert port.to_json() == ref.to_json()
        for who in ("", "u1", "u2", "u3"):
            for action in ("s3:GetObject", "s3:PutObject", "s3:ListBucket",
                           "admin:*"):
                for res in ("pol", "pol/a/x", "pol/b", "other/x"):
                    for ctx in ({}, {"aws:username": "u1"}):
                        assert port.is_allowed(who, action, res, ctx) == \
                            ref.is_allowed(who, action, res, ctx)


@pytest.mark.parametrize("raw", [
    b"{", b'{"Statement": []}',
    b'{"Statement": {"Effect": "Allow", "Action": "s3:*", "Resource": "*"}}',
    b'{"Statement": {"Principal": 5, "Action": "s3:*"}}',
    b'{"Statement": {"Principal": "*", "Action": "s3:*", '
    b'"Resource": "arn:aws:s3:::other/*"}}',
    b'{"Statement": {"Principal": "*", "Action": "s3:*", '
    b'"Resource": "pol/*", "Condition": {"NumericEquals": {"a": 1}}}}',
    b'{"Statement": {"Principal": "*", "Action": "s3:*", '
    b'"Resource": "pol/*", "Condition": {"StringEquals": 1}}}',
], ids=["json", "empty", "no-principal", "bad-principal", "other-bucket",
        "operator", "condition"])
def test_bad_documents_are_refused_alike(raw):
    for mod in (ref_bp, port_bp):
        with pytest.raises(mod.BucketPolicyError):
            mod.BucketPolicy.parse(raw, "pol")


# -- over HTTP ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("bpolicy")
    try:
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                client(srv).make_bucket("pol")
                adm = AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)
                adm.add_user("u1", "u1-secret-key", ["readonly"])
                adm.add_user("u2", "u2-secret-key")
            yield ref, port, root
    finally:
        mp.undo()


def test_policy_subresource_answers_alike(pair):
    ref, port, _ = pair
    doc = json.dumps(PUBLIC).encode()
    for method, body_, who in (
            ("GET", b"", AK), ("DELETE", b"", AK), ("PUT", b"{", AK),
            ("PUT", doc, "u1"), ("PUT", doc, AK), ("GET", b"", AK),
            ("GET", b"", "u1"), ("POST", b"", AK)):
        r, p = (client(srv, who, SK if who == AK else "u1-secret-key")
                .request(method, "/pol", "policy", body_, expect=())
                for srv in (ref, port))
        assert p.status == r.status, (method, who)
        if r.status >= 300:
            assert p.xml().findtext("Code") == r.xml().findtext("Code")
        else:
            assert p.body == r.body
            assert p.headers["Content-Type"] == r.headers["Content-Type"]
    r, p = both(ref, port, "GET", "/nosuchbucket", "policy")
    assert (p.status, p.xml().findtext("Code")) == \
        (r.status, r.xml().findtext("Code")) == (404, "NoSuchBucket")


def _counts():
    return (rs_kernels.COUNTS.plain, hh.COUNTS.plain)


@pytest.mark.parametrize("size", [4000, THRESHOLD + 4000],
                         ids=["buffered", "streamed"])
def test_the_policy_grants_and_denies_alike(pair, size):
    ref, port, root = pair
    data = body(size, 5)
    out = []
    for srv in (ref, port):
        c = client(srv)
        c.put_object("pol", "pub/x", data)
        c.put_object("pol", "secret/x", data)
        anon, rows = client(srv, "", ""), []
        r = anon.request("GET", "/pol/pub/x", sign=False, expect=())
        rows.append((r.status, r.body == data))
        for path in ("/pol/secret/x", "/pol/pub"):
            r = anon.request("GET", path, sign=False, expect=())
            rows.append((r.status, r.xml().findtext("Code")))
        for key in (f"drop/{size}", f"pub/{size}"):
            r = anon.request("PUT", f"/pol/{key}", body=data, sign=False,
                             expect=())
            rows.append(r.status)
        u1 = client(srv, "u1", "u1-secret-key")   # readonly, but denied
        rows.append(u1.get_object("pol", "secret/x", expect=()).status)
        rows.append(u1.get_object("pol", "pub/x", expect=()).status)
        u2 = client(srv, "u2", "u2-secret-key")   # no policy of its own
        rows.append(u2.get_object("pol", "pub/x", expect=()).status)
        rows.append(u2.request("PUT", f"/pol/drop/u2-{size}", body=data,
                               expect=()).status)
        rows.append(u2.request("PUT", f"/pol/else/{size}", body=data,
                               expect=()).status)
        out.append(rows)
    assert out[0] == out[1]
    assert out[1] == [(200, True), (403, "AccessDenied"),
                      (403, "AccessDenied"), 200, 403, 403, 200, 200,
                      200, 403]


def test_a_refused_streamed_put_encodes_nothing(pair):
    """The stream route authorises before it reads a batch: no codec
    launch (on the CPU, no plain run), no object, no staging file."""
    _, port, root = pair
    data = body(THRESHOLD + 9000, 6)
    before = _counts()
    for who in (("", ""), ("u1", "u1-secret-key")):
        r = client(port, *who).request("PUT", "/pol/else/denied", body=data,
                                       sign=bool(who[0]), expect=())
        assert (r.status, r.xml().findtext("Code")) == (403, "AccessDenied")
    assert _counts() == before
    assert client(port).head_object("pol", "else/denied",
                                    expect=()).status == 404
    for i in range(SETS * PER):
        d = root / "port" / f"d{i}"
        assert not (d / "pol" / "else").exists()
        assert os.listdir(d / ".mt.sys" / "tmp") == []
    # the same body, allowed anonymously by the policy, is encoded
    r = client(port, "", "").request("PUT", "/pol/drop/allowed", body=data,
                                     sign=False, expect=())
    assert r.status == 200 and _counts() > before
    assert client(port).get_object("pol", "drop/allowed").body == data

"""The port's POST-policy uploads against ``minio_tpu``'s: the same form
parsed, the same policy verdicts and signature checks (V4 and V2) for
seeded forms; and over HTTP (``_torch_control.servers``) the same
answers to uploads that succeed (204, 200, 201 with a PostResponse, 303
with a redirect) and to those the policy, the signature or IAM refuses,
with the object read back or absent alike."""

import base64
import datetime
import hashlib
import hmac
import json
import re

import numpy as np
import pytest

from minio_tpu.s3 import postpolicy as ref_pp
from minio_tpu_torch.s3 import postpolicy as port_pp

from ._torch_control import AK, SK, client, servers
from ._torch_versions import body

NOW = datetime.datetime(2026, 10, 17, 10, 0, tzinfo=datetime.timezone.utc)
LATER = "2026-10-17T12:00:00.000Z"


def _form(fields: dict, data: bytes, boundary: str = "b0und") -> bytes:
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
             f'name="{k}"\r\n\r\n{v}\r\n'.encode() for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 'name="file"; filename="f.bin"\r\n\r\n'.encode() + data
                 + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode()


def test_forms_parse_alike():
    data = body(3000, 1)
    raw = _form({"Key": "a/${filename}", "X-Amz-Meta-Z": "1",
                 "policy": "cG9s"}, data)
    ct = "multipart/form-data; boundary=b0und"
    assert port_pp.parse_form(raw, ct) == ref_pp.parse_form(raw, ct)
    for mod in (ref_pp, port_pp):
        with pytest.raises(mod.SigError) as e:
            mod.parse_form(b"plain", "text/plain")
        assert e.value.code == "MalformedPOSTRequest"


CONDITIONS = [
    {"bucket": "ppb"}, ["eq", "$key", "a/k"], ["starts-with", "$key", "a/"],
    ["starts-with", "$Content-Type", "text/"], ["content-length-range", 0, 10],
    ["content-length-range", 100, 100000], ["in", "$key", "x"],
    ["eq", "$x-amz-meta-z", "1"], "bad", ["content-length-range", "x", 1]]


def _verdict(mod, *args, **kw):
    try:
        return mod.check_policy(*args, **kw)
    except mod.SigError as e:
        return e.code


@pytest.mark.parametrize("seed", range(6))
def test_policy_verdicts_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        conds = [CONDITIONS[i] for i in
                 rng.choice(len(CONDITIONS), rng.integers(0, 4))]
        exp = [LATER, "2020-01-01T00:00:00Z", "garbage", None][
            rng.integers(0, 4)]
        doc = {"conditions": conds}
        if exp:
            doc["expiration"] = exp
        pol = base64.b64encode(json.dumps(doc).encode()).decode()
        fields = {"bucket": "ppb", "key": ["a/k", "b/k"][rng.integers(0, 2)],
                  "content-type": ["text/plain", "image/png"][
                      rng.integers(0, 2)], "x-amz-meta-z": "1"}
        size = int(rng.integers(0, 200))
        now = NOW.timestamp()
        assert _verdict(port_pp, pol, fields, size, now=now) == \
            _verdict(ref_pp, pol, fields, size, now=now)
    for bad in ("!!", base64.b64encode(b"[1]").decode()):
        assert _verdict(port_pp, bad, {}, 0) == _verdict(ref_pp, bad, {}, 0)


@pytest.mark.parametrize("case", ["v4", "v4-wrong", "v4-scope", "v2",
                                  "v2-wrong", "unknown", "none"])
def test_signature_verdicts_equal_the_references(case):
    doc = {"expiration": LATER, "conditions": []}
    if case.startswith("v4") or case == "unknown":
        fields = ref_pp.sign_policy_v4(
            "nobody" if case == "unknown" else AK,
            "bad" if case == "v4-wrong" else SK, doc,
            "eu-west-1" if case == "v4-scope" else "us-east-1", NOW)
        assert fields == port_pp.sign_policy_v4(
            "nobody" if case == "unknown" else AK,
            "bad" if case == "v4-wrong" else SK, doc,
            "eu-west-1" if case == "v4-scope" else "us-east-1", NOW)
    elif case.startswith("v2"):
        pol = base64.b64encode(json.dumps(doc).encode()).decode()
        sig = base64.b64encode(hmac.new(
            (SK + ("x" if case == "v2-wrong" else "")).encode(),
            pol.encode(), hashlib.sha1).digest()).decode()
        fields = {"policy": pol, "awsaccesskeyid": AK, "signature": sig}
    else:
        fields = {"policy": "e30="}
    got = []
    for mod in (ref_pp, port_pp):
        try:
            got.append(mod.verify_signature({AK: SK}.get, fields,
                                            "us-east-1"))
        except mod.SigError as e:
            got.append(e.code)
    assert got[0] == got[1]
    assert (got[1] == AK) == (case in ("v4", "v2"))


# -- over HTTP ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("postpolicy")
    try:
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                client(srv).make_bucket("ppb")
                client(srv).make_bucket("other")
                from minio_tpu_torch.admin.client import AdminClient
                adm = AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)
                adm.add_user("reader", "reader-secret", ["readonly"])
            yield ref, port
    finally:
        mp.undo()


def _post(srv, bucket, key, data, conds=(), fields=None, who=(AK, SK),
          expires=LATER, region="us-east-1"):
    doc = {"expiration": expires,
           "conditions": [{"bucket": bucket}, *conds]}
    form = {"key": key, **(fields or {}),
            **port_pp.sign_policy_v4(who[0], who[1], doc, region)}
    c = client(srv)
    return c.send("POST", f"http://127.0.0.1:{srv.port}/{bucket}",
                  _form(form, data), {"Content-Type":
                                      "multipart/form-data; boundary=b0und"},
                  expect=())


CASES = {
    "204": dict(key="up/a", conds=[["starts-with", "$key", "up/"]]),
    "filename": dict(key="up/${filename}"),
    "200": dict(key="up/b", fields={"success_action_status": "200"}),
    "201": dict(key="up/c", fields={"success_action_status": "201",
                                    "Content-Type": "text/plain",
                                    "x-amz-meta-tag": "t"}),
    "303": dict(key="up/d", fields={
        "success_action_redirect": "http://example.invalid/done"}),
    "too-large": dict(key="up/e", conds=[["content-length-range", 0, 10]]),
    "condition": dict(key="up/f", conds=[["eq", "$key", "up/other"]]),
    "expired": dict(key="up/g", expires="2020-01-01T00:00:00.000Z"),
    "wrong-secret": dict(key="up/h", who=(AK, "bad")),
    "unknown-key": dict(key="up/i", who=("nobody", SK)),
    "denied-by-iam": dict(key="up/j", who=("reader", "reader-secret")),
    "no-key": dict(key=""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_uploads_answer_alike(pair, case):
    ref, port = pair
    data = body(5000, 7)
    kw = CASES[case]
    r, p = (_post(srv, "ppb", data=data, **kw) for srv in (ref, port))
    assert p.status == r.status
    if r.status >= 300 and r.status != 303:
        assert p.xml().findtext("Code") == r.xml().findtext("Code")
    else:
        for h in ("ETag", "Location"):
            assert p.headers.get(h) == r.headers.get(h)
        assert re.sub(rb"\s", b"", p.body) == re.sub(rb"\s", b"", r.body)
    key = kw["key"].replace("${filename}", "f.bin")
    got, want = (client(srv).get_object("ppb", key, expect=()) if key else
                 None for srv in (port, ref))
    if key:
        assert got.status == want.status
        if want.status == 200:
            assert got.body == want.body == data
            assert got.headers.get("Content-Type") == \
                want.headers.get("Content-Type")
            assert got.headers.get("x-amz-meta-tag") == \
                want.headers.get("x-amz-meta-tag")

"""The port's SigV2 against ``minio_tpu``'s: the same string to sign,
header signature and presigned query for seeded requests, the same
verdicts on good, wrong, unknown-key, undated and expired requests; and
over HTTP (``_torch_control.servers``) the same answers to SigV2
header-signed and presigned requests, on the buffered and the streamed
PUT route alike."""

import email.utils
import time
import urllib.parse

import numpy as np
import pytest

from minio_tpu.s3 import sigv2 as ref_v2
from minio_tpu_torch.s3 import sigv2 as port_v2
from minio_tpu_torch.s3.client import S3Client

from ._torch_control import AK, SK, THRESHOLD, client, servers
from ._torch_versions import body

SUBS = ["acl", "policy", "uploads", "versionId", "versioning", "prefix",
        "list-type", "uploadId", "partNumber", "delete", "x"]


def _request(rng):
    method = ["GET", "PUT", "HEAD", "DELETE", "POST"][rng.integers(0, 5)]
    path = "/" + "/".join(f"p{rng.integers(0, 9)}"
                          for _ in range(rng.integers(0, 4)))
    query = {SUBS[i]: [["", "v1", "a b"][rng.integers(0, 3)]]
             for i in rng.choice(len(SUBS), rng.integers(0, 4))}
    headers = {"Date": "Sat, 17 Oct 2026 10:00:00 GMT"}
    if rng.random() < 0.5:
        headers["Content-Type"] = "text/plain"
    if rng.random() < 0.5:
        headers["Content-MD5"] = "1B2M2Y8AsgTpgAmY7PhCfg=="
    for i in range(rng.integers(0, 3)):
        headers[f"X-Amz-Meta-K{i}"] = f" v{i} "
    if rng.random() < 0.3:
        headers["x-amz-date"] = "20261017T100000Z"
    return method, path, query, headers


@pytest.mark.parametrize("seed", range(6))
def test_signing_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        method, path, query, headers = _request(rng)
        assert port_v2.string_to_sign(method, path, query, headers, "d") == \
            ref_v2.string_to_sign(method, path, query, headers, "d")
        assert port_v2.sign_header(AK, SK, method, path, query, headers) == \
            ref_v2.sign_header(AK, SK, method, path, query, headers)
        assert port_v2.presign(AK, SK, method, path, 2_000_000_000, query) \
            == ref_v2.presign(AK, SK, method, path, 2_000_000_000, query)


def _verdict(mod, fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except mod.SigError as e:
        return e.code


@pytest.mark.parametrize("case", ["good", "wrong-secret", "unknown-key",
                                  "no-date", "malformed", "tampered"])
def test_header_verdicts_equal_the_references(case):
    path, query = "/b/k", {"versionId": ["v"]}
    headers = {"Date": "Sat, 17 Oct 2026 10:00:00 GMT",
               "Content-Type": "x/y"}
    secret = "wrong" if case == "wrong-secret" else SK
    headers["Authorization"] = ref_v2.sign_header(
        "nobody" if case == "unknown-key" else AK, secret, "GET", path,
        query, headers)
    if case == "no-date":
        del headers["Date"]
    if case == "malformed":
        headers["Authorization"] = "AWS nocolon"
    if case == "tampered":
        headers["Content-Type"] = "x/z"
    got = [_verdict(mod, mod.verify_request, {AK: SK}.get, "GET", path,
                    query, headers) for mod in (ref_v2, port_v2)]
    assert got[0] == got[1]
    assert (got[1] == AK) == (case == "good")


@pytest.mark.parametrize("case", ["good", "expired", "wrong", "missing"])
def test_presigned_verdicts_equal_the_references(case):
    exp = 2_000_000_000 if case != "expired" else 1_000_000_000
    q = urllib.parse.parse_qs(ref_v2.presign(
        AK, "wrong" if case == "wrong" else SK, "GET", "/b/k", exp))
    if case == "missing":
        del q["Expires"]
    got = [_verdict(mod, mod.verify_presigned, {AK: SK}.get, "GET", "/b/k",
                    q, {}, now=1_500_000_000) for mod in (ref_v2, port_v2)]
    assert got[0] == got[1]
    assert (got[1] == AK) == (case == "good")


# -- over HTTP ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("sigv2")
    try:
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                client(srv).make_bucket("vtwo")
            yield ref, port
    finally:
        mp.undo()


def _v2(srv, key=AK, secret=SK) -> S3Client:
    return S3Client(f"http://127.0.0.1:{srv.port}", key, secret)


@pytest.mark.parametrize("size", [1000, THRESHOLD + 5000],
                         ids=["buffered", "streamed"])
def test_v2_requests_answer_alike(pair, size):
    data = body(size, 3)
    out = []
    for srv in pair:
        c = _v2(srv)
        rows = [c.request_v2("PUT", f"/vtwo/k{size}", body=data).status]
        r = c.request_v2("GET", f"/vtwo/k{size}")
        rows.append((r.status, r.body == data, r.headers["ETag"]))
        rows.append(c.request_v2("HEAD", f"/vtwo/k{size}").status)
        r = c.send("GET", c.presign_v2("GET", "vtwo", f"k{size}"))
        rows.append((r.status, r.body == data))
        bad = _v2(srv, AK, "not-the-secret")
        for method, b in (("GET", b""), ("PUT", data)):
            r = bad.request_v2(method, f"/vtwo/k{size}", body=b, expect=())
            rows.append((r.status, r.xml().findtext("Code")))
        r = _v2(srv, "nobody").request_v2("GET", f"/vtwo/k{size}",
                                          expect=())
        rows.append((r.status, r.xml().findtext("Code")))
        # an expired presigned URL
        url = c.presign_v2("GET", "vtwo", f"k{size}", expires_s=-10)
        r = c.send("GET", url, expect=())
        rows.append((r.status, r.xml().findtext("Code")))
        # a V2 request without its Date
        hdrs = {"Authorization": port_v2.sign_header(
            AK, SK, "GET", f"/vtwo/k{size}", {}, {})}
        r = c.send("GET", f"{c.endpoint}/vtwo/k{size}", b"", hdrs,
                   expect=())
        rows.append((r.status, r.xml().findtext("Code")))
        out.append(rows)
    assert out[0] == out[1]
    assert out[1][:2] == [200, (200, True, out[1][1][2])]
    assert out[1][4] == (403, "SignatureDoesNotMatch")


def test_v2_date_is_the_http_date(pair):
    """The client signs over an RFC 1123 Date, as SDKs send it."""
    ref, port = pair
    for srv in (ref, port):
        c = _v2(srv)
        when = email.utils.parsedate_to_datetime(
            email.utils.formatdate(usegmt=True))
        assert abs(when.timestamp() - time.time()) < 5
        assert c.request_v2("GET", "/vtwo", "list-type=2").status == 200

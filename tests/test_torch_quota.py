"""Hard bucket quotas: the port's ``Quota`` document against
``minio_tpu``'s, and the two servers (each built by its own
``build_server``, ``_torch_control``) refusing the same writes with the
same 403 ``XMinioAdminBucketQuotaExceeded``, before the body is encoded:
a refused PUT launches no codec op."""

import json

import pytest

from minio_tpu.bucket import quota as ref_q
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.bucket import quota as port_q

from ._torch_control import AK, SK, both, client, servers

DOCS = [b'{"quota": 1024, "quotatype": "hard"}',
        b'{"quota": 0}',
        b'{"quota": 5, "quotatype": "fifo"}',
        b'{"quotatype": "hard"}']
BAD = [b"not json", b'{"quota": -1}', b'{"quota": 1, "quotatype": "soft"}']


@pytest.mark.parametrize("doc", DOCS)
def test_quota_documents_equal(doc):
    r, p = ref_q.Quota.parse(doc), port_q.Quota.parse(doc)
    assert (p.quota, p.quota_type) == (r.quota, r.quota_type)
    assert p.to_json() == r.to_json()
    for usage, incoming in ((0, 0), (1000, 24), (1000, 25), (5, 1)):
        assert p.allows(usage, incoming) == r.allows(usage, incoming)


@pytest.mark.parametrize("doc", BAD)
def test_quota_refusals_equal(doc):
    with pytest.raises(ref_q.QuotaError) as r:
        ref_q.Quota.parse(doc)
    with pytest.raises(port_q.QuotaError) as p:
        port_q.Quota.parse(doc)
    assert str(p.value) == str(r.value)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    with servers(tmp_path_factory.mktemp("quota"), mp) as (ref, port):
        yield ref, port
    mp.undo()


def _codec_ops(srv) -> float:
    text = AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK).metrics()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("mt_tpu_ops_total"))


def _code(resp) -> str:
    return resp.xml().findtext("Code")


def test_hard_quota_refuses_alike(pair):
    ref, port = pair
    for srv in pair:
        client(srv).make_bucket("qbkt")
    a = [AdminClient(f"http://127.0.0.1:{s.port}", AK, SK) for s in pair]
    for adm in a:
        adm.set_bucket_quota("qbkt", 10_000)
    assert a[1].get_bucket_quota("qbkt") == a[0].get_bucket_quota("qbkt") \
        == {"quota": 10_000, "quotatype": "hard"}
    r, p = both(ref, port, "PUT", "/qbkt/a", body=b"a" * 6000)
    assert r.status == p.status == 200
    before = _codec_ops(port)
    r, p = both(ref, port, "PUT", "/qbkt/b", body=b"b" * 6000)
    assert r.status == p.status == 403
    assert _code(p) == _code(r) == "XMinioAdminBucketQuotaExceeded"
    assert _codec_ops(port) == before, "a refused PUT reached the codec"
    # a part is charged as a PUT is; the upload itself may begin
    uids = [client(s).create_multipart_upload("qbkt", "mp") for s in pair]
    r, p = (client(s).request("PUT", "/qbkt/mp",
                              f"partNumber=1&uploadId={u}", b"p" * 5000,
                              expect=())
            for s, u in zip(pair, uids))
    assert r.status == p.status == 403
    assert _code(p) == _code(r)
    # the S3 ?quota view of the same document
    r, p = both(ref, port, "GET", "/qbkt", "quota")
    assert r.status == p.status == 200
    assert json.loads(p.body) == json.loads(r.body)
    # quota enable=off: stored, not enforced
    for adm in a:
        adm.set_config_kv("quota", "enable", "off")
    try:
        r, p = both(ref, port, "PUT", "/qbkt/b", body=b"b" * 6000)
        assert r.status == p.status == 200
    finally:
        for adm in a:
            adm.set_config_kv("quota", "enable", "on")
    r, p = both(ref, port, "PUT", "/qbkt/c", body=b"c" * 10)
    assert r.status == p.status == 403
    for adm in a:
        adm.clear_bucket_quota("qbkt")
    assert a[1].get_bucket_quota("qbkt") == a[0].get_bucket_quota("qbkt") \
        == {}
    r, p = both(ref, port, "PUT", "/qbkt/c", body=b"c" * 10)
    assert r.status == p.status == 200


@pytest.mark.parametrize("query,body", [
    ("bucket=qnone", b'{"quota": 1}'),
    ("bucket=qbkt", b'{"quota": -3}'),
    ("bucket=qbkt", b"{"),
], ids=["unknown-bucket", "negative", "malformed"])
def test_set_quota_refusals_alike(pair, query, body):
    ref, port = pair
    r, p = both(ref, port, "POST", "/minio-tpu/admin/v1/set-bucket-quota",
                query, body)
    assert r.status == p.status == 400


def test_s3_quota_put_alike(pair):
    ref, port = pair
    for srv in pair:
        client(srv).make_bucket("qput")
    r, p = both(ref, port, "PUT", "/qput", "quota",
                b'{"quota": 100, "quotatype": "hard"}')
    assert r.status == p.status == 200
    r, p = both(ref, port, "PUT", "/qput", "quota", b'{"quota": -1}')
    assert r.status == p.status == 400 and _code(p) == _code(r)
    r, p = both(ref, port, "PUT", "/qput/x", body=b"x" * 101)
    assert r.status == p.status == 403
    r, p = both(ref, port, "DELETE", "/qput", "quota")
    assert r.status == p.status == 405

"""SSE-S3, SSE-KMS and SSE-C on the port's S3 server against
``minio_tpu``'s (ROADMAP Queue 3 item 40: the port served an SSE-S3
object's ciphertext).

Both servers (``_torch_control``: two sets of four drives, 4 KiB blocks,
clocks and uuids pinned) serve TLS with the shared test PKI
(``tests/_pki.py``), seal under one master key
(``MINIO_TPU_KMS_SECRET_KEY``) and compress what the default extensions
name; each package draws its object keys, data keys and DARE nonces
from its own pinned stream (``_torch_versions.Draws``), so the same
requests leave the same bytes.  Objects of every size band, multipart
objects (one DARE stream per part, a range across a part boundary),
a compressed-and-encrypted ``.bin``, a bucket's default encryption, the
refusals of a missing or wrong customer key, CopyObject and
UploadPartCopy between the kinds: every answer equal, the drives equal,
and each package's server reads the drives the other wrote."""

import base64
import hashlib
import os

import pytest

from minio_tpu import server_main as ref_main
from minio_tpu.crypto import sse as ref_sse
from minio_tpu.secure import transport as ref_transport
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.crypto import dare as port_dare
from minio_tpu_torch.crypto import sse as port_sse
from minio_tpu_torch.secure import transport as port_transport

from . import _pki
from ._torch_control import AK, SK, client, servers
from ._torch_objfeat import S3NS, Pair, assert_drives_equal
from ._torch_versions import Draws, body, pin

MASTER = "sse-test-key:" + base64.b64encode(bytes(range(32))).decode()
CKEY = bytes(range(100, 132))
OTHER_KEY = bytes(range(1, 33))


def _ssec(key: bytes = CKEY, copy: bool = False) -> dict:
    pre = "x-amz-copy-source-" if copy else "x-amz-"
    return {f"{pre}server-side-encryption-customer-algorithm": "AES256",
            f"{pre}server-side-encryption-customer-key":
                base64.b64encode(key).decode(),
            f"{pre}server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(key).digest()).decode()}


S3 = {"x-amz-server-side-encryption": "AES256"}
KMS = {"x-amz-server-side-encryption": "aws:kms"}
TEXT = b"".join(b"entry %06d: an object the front compresses\n" % i
                for i in range(6000))
# key -> (body, request headers): every size band under SSE-S3, SSE-KMS
# and SSE-C, and a .bin that is compressed, then encrypted
OBJECTS = {
    "s3/inline.dat": (body(1000, 1), S3),
    "s3/packed.dat": (body(300_000, 2), S3),
    "s3/part.dat": (body(1_200_000, 3), S3),
    "s3/streamed.dat": (body(2_000_000, 4), S3),
    "kms/obj.dat": (body(300_000, 5), KMS),
    "c/obj.dat": (body(300_000, 6), _ssec()),
    "c/part.dat": (body(1_200_000, 7), _ssec()),
    "both.bin": (TEXT, S3),
}
PARTS = [body(200_000, 8), body(70_000, 9), body(150_000, 10)]


def _complete(pair, key, uid, etags, headers=None):
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    return pair.same("POST", f"/sse/{key}", f"uploadId={uid}",
                     doc.encode(), headers=headers, status=200)


def _multipart(pair, key, headers):
    up = pair.same("POST", f"/sse/{key}", "uploads", headers=headers,
                   status=200)
    uid = up.xml().findtext(f"{S3NS}UploadId")
    part_hdrs = headers if "x-amz-server-side-encryption-customer-key" \
        in headers else None
    etags = [pair.same("PUT", f"/sse/{key}", f"partNumber={n}&uploadId={uid}",
                       body=p, headers=part_hdrs, status=200).headers["ETag"]
             for n, p in enumerate(PARTS, 1)]
    _complete(pair, key, uid, etags)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    pki = _pki.cluster_pki(tmp_path_factory)
    certs = pki.write_certs_dir(str(tmp_path_factory.mktemp("certs")))
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_TLS_ENABLE", "on")
    mp.setenv("MT_TLS_CERTS_DIR", certs)
    mp.setenv("MT_COMPRESSION_ENABLE", "on")
    mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
    root = tmp_path_factory.mktemp("sse")
    try:
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                srv.test_ca = pki.ca_cert
            # from here on each package draws from its own pinned stream
            mp.setattr(os, "urandom", Draws(16))
            p = Pair(ref, port, root)
            p.same("PUT", "/sse", status=200)
            for key, (data, hdrs) in OBJECTS.items():
                p.same("PUT", f"/sse/{key}", body=data, headers=hdrs,
                       status=200)
            _multipart(p, "mp/s3.dat", S3)
            _multipart(p, "mp/c.dat", _ssec())
            p.certs = certs
            yield p
    finally:
        mp.undo()
        ref_transport.configure(None)
        port_transport.configure(None)


def _get_headers(key):
    hdrs = OBJECTS[key][1] if key in OBJECTS else (
        _ssec() if key.startswith("mp/c") else {})
    return hdrs if "x-amz-server-side-encryption-customer-key" in hdrs \
        else {}


ALL = {**{k: d for k, (d, _) in OBJECTS.items()},
       "mp/s3.dat": b"".join(PARTS), "mp/c.dat": b"".join(PARTS)}


@pytest.mark.parametrize("key", sorted(ALL))
def test_get_and_head_answer_the_plain_object(pair, key):
    got = pair.same("GET", f"/sse/{key}", headers=_get_headers(key),
                    status=200)
    assert got.body == ALL[key]
    head = pair.same("HEAD", f"/sse/{key}", headers=_get_headers(key),
                     status=200)
    assert head.headers["Content-Length"] == str(len(ALL[key]))


@pytest.mark.parametrize("key", sorted(ALL))
@pytest.mark.parametrize("rng", [(0, 99), (65530, 65545), (199_990, 200_020),
                                 (269_990, 270_010), (-70_000, None)])
def test_ranges_decrypt_only_what_they_cover(pair, key, rng):
    """A range inside a DARE package, across packages, across the part
    boundaries of a multipart object (200,000 and 270,000) and a
    suffix."""
    data = ALL[key]
    first, last = rng
    spec = f"bytes=-{-first}" if last is None else f"bytes={first}-{last}"
    got = pair.same("GET", f"/sse/{key}",
                    headers={"Range": spec, **_get_headers(key)})
    if first >= len(data):
        assert got.status == 416
        return
    assert got.status == 206
    assert got.body == (data[first:] if last is None
                        else data[first:last + 1])


def test_sse_c_needs_its_key(pair):
    pair.same("GET", "/sse/c/obj.dat", status=400, err="InvalidRequest")
    pair.same("HEAD", "/sse/c/obj.dat", status=400)
    pair.same("GET", "/sse/c/obj.dat", headers=_ssec(OTHER_KEY),
              status=403, err="AccessDenied")
    bad = dict(_ssec())
    bad["x-amz-server-side-encryption-customer-key-md5"] = \
        base64.b64encode(b"x" * 16).decode()
    pair.same("PUT", "/sse/c/bad.dat", body=b"x", headers=bad, status=400,
              err="InvalidArgument")
    pair.same("PUT", "/sse/c/bad.dat", body=b"x",
              headers={"x-amz-server-side-encryption": "DES"}, status=400,
              err="InvalidEncryptionAlgorithmError")


@pytest.mark.parametrize("query", ["", "list-type=2", "versions"])
def test_listings_give_the_plain_size(pair, query):
    got = pair.same("GET", "/sse", query, status=200)
    sizes = {e.findtext(f"{S3NS}Key"): int(e.findtext(f"{S3NS}Size"))
             for e in got.xml() if e.findtext(f"{S3NS}Size")}
    for key in ALL:
        assert sizes[key] == len(ALL[key])


def test_bucket_default_encryption(pair):
    pair.same("GET", "/dflt", "encryption", status=404)
    pair.same("PUT", "/dflt", status=200)
    pair.same("GET", "/dflt", "encryption", status=404,
              err="ServerSideEncryptionConfigurationNotFoundError")
    cfg = (b'<ServerSideEncryptionConfiguration><Rule>'
           b'<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256'
           b'</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>'
           b'</ServerSideEncryptionConfiguration>')
    pair.same("PUT", "/dflt", "encryption", body=b"<bad/>", status=400,
              err="MalformedXML")
    pair.same("PUT", "/dflt", "encryption", body=cfg, status=200)
    pair.same("GET", "/dflt", "encryption", status=200)
    put = pair.same("PUT", "/dflt/k.dat", body=body(5000, 11), status=200)
    assert put.headers["x-amz-server-side-encryption"] == "AES256"
    got = pair.same("GET", "/dflt/k.dat", status=200)
    assert got.body == body(5000, 11)
    meta = pair.port.layer.get_object_info("dflt", "k.dat").user_defined
    assert port_sse.is_encrypted(meta)
    pair.same("DELETE", "/dflt", "encryption", status=204)
    pair.same("PUT", "/dflt/plain.dat", body=b"p" * 10, status=200)
    assert not port_sse.is_encrypted(
        pair.port.layer.get_object_info("dflt", "plain.dat").user_defined)


@pytest.mark.parametrize("src,src_hdrs,dst_hdrs", [
    ("c/obj.dat", _ssec(copy=True), S3),
    ("s3/part.dat", {}, {}),
    ("kms/obj.dat", {}, _ssec()),
    ("both.bin", {}, {}),
    ("mp/c.dat", _ssec(copy=True), KMS),
], ids=["ssec-to-s3", "s3-to-plain", "kms-to-ssec", "compressed-encrypted",
        "multipart-ssec-to-kms"])
def test_copies_decrypt_and_encrypt_again(pair, src, src_hdrs, dst_hdrs):
    dst = "copies/" + src.replace("/", "-")
    r = pair.same("PUT", f"/sse/{dst}",
                  headers={"x-amz-copy-source": f"/sse/{src}", **src_hdrs,
                           **dst_hdrs}, status=200)
    assert r.xml().findtext(f"{S3NS}ETag")
    get_hdrs = dst_hdrs if "x-amz-server-side-encryption-customer-key" \
        in dst_hdrs else {}
    assert pair.same("GET", f"/sse/{dst}", headers=get_hdrs,
                     status=200).body == ALL[src]


def test_copy_source_key_is_required(pair):
    pair.same("PUT", "/sse/copies/nokey.dat",
              headers={"x-amz-copy-source": "/sse/c/obj.dat"}, status=400,
              err="InvalidRequest")


def test_a_copy_onto_its_own_name_that_encrypts_is_allowed(pair):
    pair.same("PUT", "/sse/self.dat", body=body(9000, 12), status=200)
    pair.same("PUT", "/sse/self.dat",
              headers={"x-amz-copy-source": "/sse/self.dat"}, status=400,
              err="InvalidRequest")
    pair.same("PUT", "/sse/self.dat",
              headers={"x-amz-copy-source": "/sse/self.dat", **S3},
              status=200)
    got = pair.same("GET", "/sse/self.dat", status=200)
    assert got.body == body(9000, 12)
    assert got.headers["x-amz-server-side-encryption"] == "AES256"


def test_upload_part_copy_into_an_encrypted_upload(pair):
    up = pair.same("POST", "/sse/upc.dat", "uploads", headers=_ssec(),
                   status=200)
    uid = up.xml().findtext(f"{S3NS}UploadId")
    src = ALL["mp/s3.dat"]
    etags = []
    for n, (a, b) in enumerate(((0, 199_999), (199_990, 419_999)), 1):
        r = pair.same("PUT", "/sse/upc.dat", f"partNumber={n}&uploadId={uid}",
                      headers={"x-amz-copy-source": "/sse/mp/s3.dat",
                               "x-amz-copy-source-range": f"bytes={a}-{b}",
                               **_ssec()}, status=200)
        etags.append(r.xml().findtext(f"{S3NS}ETag"))
    _complete(pair, "upc.dat", uid, etags)
    got = pair.same("GET", "/sse/upc.dat", headers=_ssec(), status=200)
    assert got.body == src[:200_000] + src[199_990:420_000]


def test_drives_match_reference(pair):
    assert_drives_equal(pair.root, 8)


def test_each_package_reads_what_the_other_wrote(pair):
    for tag, main in (("ref", port_main), ("port", ref_main)):
        dirs = [str(pair.root / tag / f"d{i}") for i in range(8)]
        kw = ({"device": "cpu"} if main is port_main
              else {"backend": "numpy"})
        srv = main.build_server(dirs, "127.0.0.1:0", AK, SK, block_size=4096,
                                set_drive_count=4, **kw)
        srv.test_ca = pair.ref.test_ca
        srv.start()
        try:
            c = client(srv)
            for key, data in ALL.items():
                got = c.get_object("sse", key, headers=_get_headers(key))
                assert got.body == data, key
                if len(data) > 270_010:
                    got = c.get_object("sse", key, (199_990, 270_010),
                                       headers=_get_headers(key))
                    assert got.body == data[199_990:270_011], key
        finally:
            srv.stop()
            if main is ref_main:
                srv.layer.monitor.stop()
                for s in srv.layer.sets:
                    s._pool.shutdown(wait=True)


# -- the module alone, against the reference's ---------------------------------

@pytest.mark.parametrize("kind", ["SSE-S3", "SSE-KMS", "SSE-C"])
def test_object_keys_seal_and_open_across_packages(monkeypatch, kind):
    """The same draws give the same sealed metadata and ciphertext, and
    each package opens what the other sealed."""
    from minio_tpu.crypto import kms as ref_kms
    from minio_tpu_torch.crypto import kms as port_kms
    pin(monkeypatch, draws=3)
    hdrs = _ssec() if kind == "SSE-C" else {}
    rk = ref_kms.LocalKMS("k", bytes(32))
    pk = port_kms.LocalKMS("k", bytes(32))
    r = ref_sse.ObjectEncryption.new(kind, "b", "o", hdrs, rk)
    p = port_sse.ObjectEncryption.new(kind, "b", "o", hdrs, pk)
    assert (p.oek, p.meta) == (r.oek, r.meta)
    data = body(150_000, 13)
    ct = p.encrypt(data)
    assert ct == r.encrypt(data)
    assert ref_sse.ObjectEncryption.open(p.meta, "b", "o", hdrs,
                                         rk).decrypt(ct) == data
    assert port_sse.ObjectEncryption.open(r.meta, "b", "o", hdrs,
                                          pk).decrypt(ct) == data
    assert port_sse.response_headers(p.meta) == \
        ref_sse.response_headers(r.meta)


@pytest.mark.parametrize("sizes", [[100], [65536, 10], [70_000, 1, 65537]])
def test_ranged_decrypt_and_cipher_range_across_parts(sizes):
    key = bytes(32)
    enc = port_sse.ObjectEncryption(key, {})
    plains = [body(n, i) for i, n in enumerate(sizes)]
    cts = [port_dare.encrypt(key, p) for p in plains]
    blob, plain = b"".join(cts), b"".join(plains)
    parts = [(i + 1, len(c)) for i, c in enumerate(cts)]
    for off in range(0, len(plain), 9973):
        for n in (1, 4000, 70_000):
            n = min(n, len(plain) - off)
            got = port_sse.decrypt_object_range(
                enc, {}, len(blob), lambda o, k: blob[o:o + k], off, n, parts)
            assert got == plain[off:off + n]
            assert got == ref_sse.decrypt_object_range(
                ref_sse.ObjectEncryption(key, {}), {}, len(blob),
                lambda o, k: blob[o:o + k], off, n, parts)
            c0, c1 = port_sse.cipher_range({}, len(blob), off, n, parts)

            def read(o, k):
                assert c0 <= o and o + k <= c1
                return blob[o:o + k]
            assert port_sse.decrypt_object_range(
                enc, {}, len(blob), read, off, n, parts) == got

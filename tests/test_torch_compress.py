"""Transparent compression on the port's S3 server against
``minio_tpu``'s (ROADMAP Queue 3 item 40: the port served a compressed
object's stored bytes and listed its stored size).

The engine first, host against host: the port's pure-Python snappy
blocks, CRC32C and framing streams equal ``minio_tpu``'s at many sizes
and contents, and each decodes the other's.  Then both servers
(``_torch_control``: two sets of four drives, 4 KiB blocks, clocks and
uuids pinned) with ``compression enable on``: the same requests (PUT,
GET, ranged GET, HEAD, ListObjects V1 and V2, ListObjectVersions,
CopyObject, UploadPartCopy, multipart) answer alike, and the drives hold
the same bytes.  Last each package's server reads the drives the other
wrote."""

import os

import pytest

from minio_tpu import compress as ref_mtc
from minio_tpu import server_main as ref_main
from minio_tpu_torch import compress as port_mtc
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.compress import snappy_py

from ._torch_control import AK, SK, client, servers
from ._torch_objfeat import S3NS, Pair, assert_drives_equal
from ._torch_versions import body

SIZES = [0, 1, 15, 16, 4095, 4096, 65535, 65536, 65537, 200_000]
TEXT = b"".join(b"line %06d of a log the crawler keeps, status=ok\n" % i
                for i in range(4000))[:128_000]


def _contents(size: int) -> dict:
    return {"random": os.urandom(size),
            "text": (TEXT * (size // len(TEXT) + 1))[:size],
            "zeros": bytes(size),
            "runs": bytes((i // 97) % 7 for i in range(size))}


@pytest.mark.parametrize("size", SIZES)
def test_blocks_and_crc_equal_the_references(size):
    for kind, data in _contents(size).items():
        block = snappy_py.compress_block_py(data)
        assert block == ref_mtc.compress_block(data), kind
        assert snappy_py.decompress_block_py(
            ref_mtc.compress_block(data)) == data
        assert port_mtc.crc32c(data) == ref_mtc.crc32c(data), kind


@pytest.mark.parametrize("size", SIZES)
def test_streams_equal_the_references_and_decode_in_pieces(size):
    for kind, data in _contents(size).items():
        stream = port_mtc.compress_stream(data)
        assert stream == ref_mtc.compress_stream(data), kind
        assert ref_mtc.decompress_stream(stream) == data
        pieces = (stream[o:o + 1000] for o in range(0, len(stream), 1000))
        assert b"".join(port_mtc.decompress_chunks(pieces)) == data


def test_corrupt_streams_are_refused_alike():
    good = port_mtc.compress_stream(TEXT)
    flipped = bytearray(good)
    flipped[40] ^= 1
    for bad in (good[:-3], bytes(flipped), b"nosnappy" + good[8:],
                good[:10] + b"\x02\x01\x00\x00" + good[10:]):
        with pytest.raises(ref_mtc.CompressionError):
            ref_mtc.decompress_stream(bad)
        with pytest.raises(port_mtc.CompressionError):
            port_mtc.decompress_stream(bad)


@pytest.mark.parametrize("name,ctype,size,want", [
    ("a.txt", "", 5000, True), ("a.txt", "", 4095, False),
    ("a.dat", "", 5000, False), ("a.dat", "text/plain", 5000, True),
    ("a.dat", "application/json", 5000, True), ("a.gz", "", 5000, False),
    ("a.bin", "", 1 << 20, True), ("a.jpg", "image/jpeg", 5000, False)])
def test_eligibility_equals_the_references(name, ctype, size, want):
    exts = ".txt,.log,.csv,.json,.tar,.xml,.bin".split(",")
    types = "text/*,application/json,application/xml".split(",")
    for args in ((exts, types), (None, None)):
        got = port_mtc.is_compressible(name, ctype, size, *args)
        assert got == ref_mtc.is_compressible(name, ctype, size, *args)
    assert port_mtc.is_compressible(name, ctype, size, exts, types) == want


# -- the servers --------------------------------------------------------------

# a text object and one past the HTTP stream threshold, both compressed;
# one the configuration leaves alone
OBJECTS = {"log.txt": TEXT, "big.txt": TEXT * 13,
           "photo.dat": body(200_000, 3)}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_COMPRESSION_ENABLE", "on")
    root = tmp_path_factory.mktemp("compress")
    with servers(root, mp) as (ref, port):
        p = Pair(ref, port, root)
        p.same("PUT", "/cmp", status=200)
        p.same("PUT", "/cmp", "versioning",
               body=b'<VersioningConfiguration><Status>Enabled</Status>'
               b'</VersioningConfiguration>', status=200)
        for key, data in OBJECTS.items():
            p.same("PUT", f"/cmp/{key}", body=data, status=200)
        yield p
    mp.undo()


def test_get_answers_the_plain_bytes(pair):
    """Item 40: the port served 6,098 stored bytes of a 128,000-byte
    compressed text under the same ETag."""
    for key, data in OBJECTS.items():
        got = pair.same("GET", f"/cmp/{key}", status=200)
        assert got.body == data
        assert got.headers["Content-Length"] == str(len(data))


@pytest.mark.parametrize("rng", ["bytes=0-99", "bytes=70000-70100",
                                 "bytes=127990-", "bytes=-5000",
                                 "bytes=65530-65545", "bytes=128000-",
                                 "bytes=0-999999"])
def test_ranges_are_in_plain_bytes(pair, rng):
    got = pair.same("GET", "/cmp/log.txt", headers={"Range": rng})
    if got.status == 206:
        first, _, last = rng[6:].partition("-")
        if not first:
            assert got.body == TEXT[-int(last):]
        else:
            end = int(last) + 1 if last else len(TEXT)
            assert got.body == TEXT[int(first):end]


def test_head_answers_the_plain_size(pair):
    for key, data in OBJECTS.items():
        got = pair.same("HEAD", f"/cmp/{key}", status=200)
        assert got.headers["Content-Length"] == str(len(data))


@pytest.mark.parametrize("query", ["", "list-type=2", "versions",
                                   "list-type=2&prefix=log"])
def test_listings_give_the_plain_size(pair, query):
    got = pair.same("GET", "/cmp", query, status=200)
    sizes = {e.findtext(f"{S3NS}Key"): int(e.findtext(f"{S3NS}Size"))
             for e in got.xml() if e.findtext(f"{S3NS}Size")}
    for key, size in sizes.items():
        assert size == len(OBJECTS[key])


def test_copies_decode_and_encode_again(pair):
    """A compressed source copies to a name the configuration compresses
    and to one it does not; UploadPartCopy takes a plain-byte range."""
    for dst in ("copy.txt", "copy.dat"):
        pair.same("PUT", f"/cmp/{dst}",
                  headers={"x-amz-copy-source": "/cmp/log.txt"},
                  status=200)
        assert pair.same("GET", f"/cmp/{dst}", status=200).body == TEXT
    up = pair.same("POST", "/cmp/parts.txt", "uploads", status=200)
    uid = up.xml().findtext(f"{S3NS}UploadId")
    etags = []
    for n, rng in ((1, "bytes=0-69999"), (2, "bytes=70000-127999")):
        r = pair.same("PUT", "/cmp/parts.txt",
                      f"partNumber={n}&uploadId={uid}",
                      headers={"x-amz-copy-source": "/cmp/log.txt",
                               "x-amz-copy-source-range": rng}, status=200)
        etags.append(r.xml().findtext(f"{S3NS}ETag"))
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    pair.same("POST", "/cmp/parts.txt", f"uploadId={uid}", doc.encode(),
              status=200)
    assert pair.same("GET", "/cmp/parts.txt", status=200).body == TEXT


def test_sse_c_over_plain_http_is_refused(pair):
    """A customer key sent in the clear is refused before anything reads
    it (InsecureSSECustomerRequest), a copy source's too."""
    for hdr in ("x-amz-server-side-encryption-customer-algorithm",
                "x-amz-copy-source-server-side-encryption-customer-"
                "algorithm"):
        got = pair.same("PUT", "/cmp/k.dat", body=b"x",
                        headers={hdr: "AES256"}, status=400)
        assert b"Customer provided keys" in got.body


def test_drives_match_reference(pair):
    assert_drives_equal(pair.root, 8)


def test_each_package_reads_what_the_other_wrote(pair):
    """A server of each package over the other's drives answers the
    bodies and sizes."""
    for tag, main in (("ref", port_main), ("port", ref_main)):
        dirs = [str(pair.root / tag / f"d{i}") for i in range(8)]
        kw = ({"device": "cpu"} if main is port_main
              else {"backend": "numpy"})
        srv = main.build_server(dirs, "127.0.0.1:0", AK, SK, block_size=4096,
                                set_drive_count=4, **kw)
        srv.start()
        try:
            c = client(srv)
            for key, data in OBJECTS.items():
                assert c.get_object("cmp", key).body == data
                assert c.head_object("cmp", key).headers[
                    "Content-Length"] == str(len(data))
            assert c.get_object("cmp", "log.txt", (70000, 70100)).body == \
                TEXT[70000:70101]
        finally:
            srv.stop()
            if main is ref_main:
                srv.layer.monitor.stop()
                for s in srv.layer.sets:
                    s._pool.shutdown(wait=True)

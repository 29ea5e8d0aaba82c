"""The port's MessagePack subset and xl.meta against the msgpack package and
minio_tpu's XLMeta: byte-identical output, and each loads the other's."""

import msgpack
import pytest

from minio_tpu.storage import xl_meta as ref
from minio_tpu.storage.datatypes import (ChecksumInfo as RefChecksum,
                                         ErasureInfo as RefErasure,
                                         FileInfo as RefFileInfo,
                                         ObjectPartInfo as RefPart)
from minio_tpu_torch.storage import errors, msgpack_codec, xl_meta
from minio_tpu_torch.storage.datatypes import (ChecksumInfo, ErasureInfo,
                                               FileInfo, ObjectPartInfo)

# every type and size class of the subset
CORPUS = [
    None, True, False,
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, 1.5, -2.25, 1e300,
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65536, "é" * 20,
    b"", b"x" * 255, b"x" * 256, b"x" * 70000, bytearray(b"ab"),
    [], [1] * 15, [1] * 16, [1] * 70000, (1, "t"),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(70000)},
    {"a": [{"b": b"c"}], 1: None, "n": {"x": [1.0, -5, "s"]}},
]


@pytest.mark.parametrize("obj", CORPUS, ids=lambda o: repr(o)[:24])
def test_msgpack_matches_library(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.packb(obj) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


def test_msgpack_rejects_garbage():
    for bad in (b"\xc1", b"\xd9\x05ab", b"\x92\x01", b"\x01\x02"):
        with pytest.raises(ValueError):
            msgpack_codec.unpackb(bad)
    with pytest.raises(TypeError):
        msgpack_codec.packb(object())


def _version(mod: str, inline: bool):
    """One FileInfo built with either package's datatypes."""
    ns = {"ref": (RefFileInfo, RefErasure, RefChecksum, RefPart),
          "port": (FileInfo, ErasureInfo, ChecksumInfo, ObjectPartInfo)}
    FI, EI, CI, PI = ns[mod]
    return FI(volume="bkt", name="a/b", data_dir="" if inline else "uuid-1",
              mod_time=1_700_000_000_123456789, size=1234,
              metadata={"etag": "0" * 32, "content-type": "x/y"},
              parts=[PI(1, 1234, 1234, "0" * 32, 1_700_000_000_123456789)],
              erasure=EI(data_blocks=12, parity_blocks=4,
                         block_size=10 << 20, index=3,
                         distribution=list(range(16, 0, -1)),
                         checksums=[CI(1, "highwayhash256S")]),
              inline_data=b"\x00\xff" * 40 if inline else None)


@pytest.mark.parametrize("inline", [False, True])
def test_xl_meta_round_trips_both_ways(inline):
    ours = xl_meta.XLMeta()
    ours.add_version(_version("port", inline))
    theirs = ref.XLMeta()
    theirs.add_version(_version("ref", inline))
    assert ours.dump() == theirs.dump()
    back = ref.XLMeta.load(ours.dump()).to_fileinfo("bkt", "a/b")
    assert back.to_dict() == _version("ref", inline).to_dict()
    fwd = xl_meta.XLMeta.load(theirs.dump()).to_fileinfo("bkt", "a/b")
    assert fwd.to_dict() == _version("port", inline).to_dict()
    assert fwd.erasure.shard_size() == back.erasure.shard_size()


def test_xl_meta_rejects_corruption():
    with pytest.raises(errors.FileCorrupt):
        xl_meta.XLMeta.load(b"NOTXL" + b"\x80")
    with pytest.raises(errors.FileCorrupt):
        xl_meta.XLMeta.load(xl_meta.MAGIC + b"\x92")
    with pytest.raises(errors.FileCorrupt):
        xl_meta.XLMeta.load(xl_meta.MAGIC + msgpack_codec.packb({"v": 9}))

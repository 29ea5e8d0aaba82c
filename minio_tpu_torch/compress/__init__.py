"""Transparent object compression (``minio_tpu/compress/__init__.py``,
cmd/object-api-utils.go:436-449,916).

An object is stored as a snappy framing stream: the stream identifier,
then one chunk per 64 KiB of the body, each with the masked CRC32C of
its plain bytes, compressed (``compress_block``) or, where that does not
shrink it, stored as it is.  So every chunk verifies on its own, and a
GET decodes a chunk as soon as its bytes arrive (``decompress_chunks``).
A stream that names S2 (``klauspost/compress``'s framing) is read as
snappy and refused when a block uses S2's own opcodes.

The block codec and the CRC are ``snappy_py``'s, in pure Python, on the
host: the reference runs its codec on the host too.  An object's
metadata says it is compressed (``META_COMPRESSION``, with the
reference's value ``COMPRESSION_ALGO``) and holds its plain size
(``x-minio-internal-actual-size``, written by the S3 front).
"""

from __future__ import annotations

import struct

from .snappy_py import compress_block_py as compress_block
from .snappy_py import crc32c_py as crc32c
from .snappy_py import decompress_block_py, uncompressed_length_py


class CompressionError(Exception):
    pass


# a snappy op emits at most 64 bytes from at most one tag byte, so a
# block never expands past ~64 x its size: a declared length beyond that
# is a corrupt or hostile header, refused before it is allocated
_MAX_EXPANSION = 64


def decompress_block(data: bytes) -> bytes:
    try:
        want = uncompressed_length_py(data)
    except ValueError as e:
        raise CompressionError("corrupt snappy block") from e
    if want > max(1 << 16, len(data) * _MAX_EXPANSION):
        raise CompressionError(f"declared length {want} implausible for "
                               f"{len(data)} compressed bytes")
    return decompress_block_py(data)


# -- the framing format ----------------------------------------------------

_STREAM_IDENT = b"\xff\x06\x00\x00sNaPpY"
_S2_IDENT = b"\xff\x06\x00\x00S2sTwO"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_FRAME_MAX = 65536                  # plain bytes per chunk


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def compress_stream(data: bytes) -> bytes:
    """``data`` as a snappy framing stream; a chunk that does not shrink
    is stored uncompressed (docs/compression/README.md:86)."""
    out = bytearray(_STREAM_IDENT)
    for off in range(0, len(data), _FRAME_MAX) or [0]:
        chunk = bytes(data[off:off + _FRAME_MAX])
        crc = struct.pack("<I", _masked_crc(chunk))
        comp = compress_block(chunk)
        kind, payload = ((_CHUNK_COMPRESSED, comp) if len(comp) < len(chunk)
                         else (_CHUNK_UNCOMPRESSED, chunk))
        out += bytes([kind]) + struct.pack("<I", 4 + len(payload))[:3]
        out += crc + payload
    return bytes(out)


def decompress_stream(data: bytes) -> bytes:
    """The whole stream's plain bytes."""
    return b"".join(decompress_chunks((data,)))


def decompress_chunks(chunks):
    """The plain bytes of a stream given as an iterator of its slices,
    one chunk's at a time as each completes: a consumer holds one 64 KiB
    chunk and the undecoded rest, never the object.  A source that ends
    mid-chunk raises CompressionError; ``chunks`` is closed at the end."""
    buf = bytearray()
    checked_ident = False
    s2 = False
    try:
        for piece in chunks:
            if piece:
                buf += piece
            if not checked_ident:
                if len(buf) < len(_STREAM_IDENT):
                    continue
                s2 = bytes(buf[:len(_S2_IDENT)]) == _S2_IDENT
                if not (s2 or bytes(buf[:len(_STREAM_IDENT)])
                        == _STREAM_IDENT):
                    raise CompressionError(
                        "missing snappy stream identifier")
                del buf[:len(_STREAM_IDENT)]
                checked_ident = True
            while len(buf) >= 4:
                ln = buf[1] | (buf[2] << 8) | (buf[3] << 16)
                if len(buf) < 4 + ln:
                    break
                kind, body = buf[0], bytes(buf[4:4 + ln])
                del buf[:4 + ln]
                plain = _decode_frame(kind, ln, body, s2)
                if plain:
                    yield plain
        if not checked_ident:
            raise CompressionError("missing snappy stream identifier")
        if buf:
            raise CompressionError("truncated chunk header" if len(buf) < 4
                                   else "truncated chunk")
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()


def _decode_frame(kind: int, ln: int, body: bytes, s2: bool) -> bytes:
    """One chunk decoded and its CRC checked; b"" for a skippable one."""
    if kind in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
        if ln < 4:
            raise CompressionError("short chunk")
        crc = struct.unpack("<I", body[:4])[0]
        payload = body[4:]
        try:
            plain = decompress_block(payload) \
                if kind == _CHUNK_COMPRESSED else payload
        except (CompressionError, ValueError) as e:
            if s2:
                raise CompressionError(
                    "S2-extended block opcodes are not supported: "
                    "rewrite the object with snappy compression") from e
            raise CompressionError(str(e)) from e
        if _masked_crc(plain) != crc:
            raise CompressionError("chunk CRC mismatch")
        return plain
    if kind == 0xFF or 0x80 <= kind <= 0xFD:
        return b""                      # a repeated ident, or skippable
    raise CompressionError(f"unknown chunk type {kind:#x}")


# -- eligibility (cmd/object-api-utils.go:436-449) --------------------------

# content already compressed, never compressed again
DEFAULT_EXCLUDE_EXTENSIONS = [
    ".gz", ".bz2", ".zst", ".zip", ".7z", ".rar", ".xz", ".lz4", ".snappy",
    ".mp4", ".mkv", ".mov", ".jpg", ".jpeg", ".png", ".gif", ".webp",
    ".mp3", ".aac", ".ogg",
]
DEFAULT_EXCLUDE_TYPES = [
    "video/", "audio/", "image/",
    "application/zip", "application/x-gzip", "application/x-bzip2",
    "application/x-compress", "application/x-xz", "application/zstd",
]
MIN_COMPRESSIBLE_SIZE = 4096    # below this a body gains nothing

META_COMPRESSION = "x-minio-internal-compression"
COMPRESSION_ALGO = "klauspost/compress/s2"   # the reference's marker


def is_compressible(object_name: str, content_type: str, size: int,
                    include_extensions: list[str] | None = None,
                    include_types: list[str] | None = None) -> bool:
    """Whether a body is stored compressed (isCompressible): never below
    ``MIN_COMPRESSIBLE_SIZE``; with include lists (the ``compression``
    subsystem's ``extensions`` and ``mime_types``) only what matches one;
    without, all that no exclusion names."""
    if 0 <= size < MIN_COMPRESSIBLE_SIZE:
        return False
    name = object_name.lower()
    ctype = (content_type or "").lower()
    if include_extensions or include_types:
        return any(ext and name.endswith(ext.lower())
                   for ext in include_extensions or []) or any(
            t and ctype.startswith(t.lower().rstrip("*"))
            for t in include_types or [])
    return not (any(name.endswith(ext) for ext in DEFAULT_EXCLUDE_EXTENSIONS)
                or any(ctype.startswith(t) for t in DEFAULT_EXCLUDE_TYPES))

"""The snappy block codec and CRC32C in pure Python, the port's engine
(``minio_tpu/compress/snappy_py.py``).

The matcher and emit rules are those of ``minio_tpu``'s engines (its
``native/snappy.cc`` and its own ``snappy_py``): the same greedy
hash-table matcher over 64 KiB fragments, so the same input gives the
same block bytes, and a block either wrote decodes in the other.
"""

from __future__ import annotations

_HASH_BITS = 14
_HASH_MUL = 0x1E35A7BD


def _emit_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _emit_literal(out: bytearray, src: bytes, start: int, end: int) -> None:
    n = end - start
    m = n - 1
    if m < 60:
        out.append(m << 2)
    elif m < (1 << 8):
        out.append(60 << 2)
        out.append(m)
    elif m < (1 << 16):
        out.append(61 << 2)
        out += m.to_bytes(2, "little")
    elif m < (1 << 24):
        out.append(62 << 2)
        out += m.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += m.to_bytes(4, "little")
    out += src[start:end]


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    while length >= 68:
        out.append((63 << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= 64
    if length > 64:
        out.append((59 << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= 60
    if length >= 12 or offset >= 2048:
        out.append(((length - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")
    else:
        out.append(((offset >> 8) << 5) | ((length - 4) << 2) | 1)
        out.append(offset & 0xFF)


def _compress_fragment(src: bytes, out: bytearray) -> None:
    n = len(src)
    table: dict[int, int] = {}
    lit_start = 0
    if n >= 15:
        limit = n - 4
        table[(int.from_bytes(src[0:4], "little") * _HASH_MUL &
               0xFFFFFFFF) >> (32 - _HASH_BITS)] = 0
        i = 1
        while i <= limit:
            v = int.from_bytes(src[i:i + 4], "little")
            h = (v * _HASH_MUL & 0xFFFFFFFF) >> (32 - _HASH_BITS)
            cand = table.get(h, -1)
            table[h] = i
            if cand >= 0 and src[cand:cand + 4] == src[i:i + 4]:
                length = 4
                while i + length < n and \
                        src[cand + length] == src[i + length]:
                    length += 1
                if lit_start < i:
                    _emit_literal(out, src, lit_start, i)
                _emit_copy(out, i - cand, length)
                i += length
                lit_start = i
                if i <= limit:
                    v2 = int.from_bytes(src[i - 1:i + 3], "little")
                    table[(v2 * _HASH_MUL & 0xFFFFFFFF) >>
                          (32 - _HASH_BITS)] = i - 1
            else:
                i += 1
    if lit_start < n:
        _emit_literal(out, src, lit_start, n)


def compress_block_py(data: bytes) -> bytes:
    out = bytearray()
    _emit_uvarint(out, len(data))
    for off in range(0, len(data), 65536):
        _compress_fragment(data[off:off + 65536], out)
    return bytes(out)


def uncompressed_length_py(data: bytes) -> int:
    v, shift, i = 0, 0, 0
    while i < len(data) and shift < 64:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v
        shift += 7
    raise ValueError("bad snappy preamble")


def decompress_block_py(data: bytes) -> bytes:
    # preamble
    want, shift, i = 0, 0, 0
    while True:
        if i >= len(data) or shift >= 64:
            raise ValueError("bad snappy preamble")
        b = data[i]
        i += 1
        want |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                nb = length - 60
                if i + nb > n:
                    raise ValueError("truncated literal length")
                length = int.from_bytes(data[i:i + nb], "little") + 1
                i += nb
            if i + length > n or len(out) + length > want:
                raise ValueError("corrupt literal")
            out += data[i:i + length]
            i += length
        else:
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                if i >= n:
                    raise ValueError("truncated copy")
                offset = ((tag >> 5) << 8) | data[i]
                i += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                if i + 2 > n:
                    raise ValueError("truncated copy")
                offset = int.from_bytes(data[i:i + 2], "little")
                i += 2
            else:
                length = (tag >> 2) + 1
                if i + 4 > n:
                    raise ValueError("truncated copy")
                offset = int.from_bytes(data[i:i + 4], "little")
                i += 4
            o = len(out)
            if offset == 0 or offset > o or o + length > want:
                raise ValueError("corrupt copy")
            if offset >= length:
                out += out[o - offset:o - offset + length]
            else:
                for _ in range(length):      # overlapping copy
                    out.append(out[-offset])
    if len(out) != want:
        raise ValueError("snappy length mismatch")
    return bytes(out)


_CRC_TABLE: list[int] | None = None


def _crc_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c_py(data: bytes) -> int:
    tbl = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF

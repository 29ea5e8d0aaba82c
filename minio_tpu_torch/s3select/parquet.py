"""Minimal Parquet reader/writer for S3 Select
(``minio_tpu/s3select/parquet.py``).

Scope: pkg/s3select/internal/parquet-go (the bundled reader used by
select.go's parquet input serialization).  This implements the subset S3
Select needs — flat schemas, data page v1, PLAIN and
RLE_DICTIONARY/PLAIN_DICTIONARY encodings, UNCOMPRESSED, SNAPPY and GZIP
page codecs (SNAPPY through the port's ``compress/``, the pure-Python
engine the object path uses) — plus a writer producing standard files
for tests and tooling.

Format essentials:
  file   = "PAR1" pages... FileMetaData(thrift compact) len(4 LE) "PAR1"
  page   = PageHeader(thrift compact) [compressed] page body
  v1 data page body (flat) = [def levels: RLE hybrid w/ 4-byte len]
                             [values: PLAIN or dict indices]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from .. import compress as mtc

MAGIC = b"PAR1"

# parquet.thrift Type enum
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN = range(8)
# CompressionCodec
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
# Encoding
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE = 0, 2, 3
ENC_RLE_DICT = 8
# PageType
PAGE_DATA, PAGE_INDEX, PAGE_DICT, PAGE_DATA_V2 = 0, 1, 2, 3
# FieldRepetitionType
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# ConvertedType (subset)
CT_UTF8 = 0


class ParquetError(ValueError):
    """ValueError so mid-stream decode failures surface as a parse
    error (400) through run_select's reader error handling."""


# ---------------------------------------------------------------------------
# Thrift compact protocol (decode + encode, the subset parquet uses)
# ---------------------------------------------------------------------------

CT_STOP, CT_TRUE, CT_FALSE, CT_BYTE, CT_I16, CT_I32, CT_I64, CT_DOUBLE, \
    CT_BINARY, CT_LIST, CT_SET, CT_MAP, CT_STRUCT = range(13)


class TReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def double(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def skip(self, ftype: int) -> None:
        if ftype in (CT_TRUE, CT_FALSE):
            return
        if ftype == CT_BYTE:
            self.pos += 1
        elif ftype in (CT_I16, CT_I32, CT_I64):
            self.varint()
        elif ftype == CT_DOUBLE:
            self.pos += 8
        elif ftype == CT_BINARY:
            self.binary()
        elif ftype in (CT_LIST, CT_SET):
            size, etype = self.list_header()
            for _ in range(size):
                self.skip(etype)
        elif ftype == CT_STRUCT:
            for fid, ft in self.fields():
                self.skip(ft)
        else:
            raise ParquetError(f"cannot skip thrift type {ftype}")

    def list_header(self) -> tuple[int, int]:
        b = self.byte()
        size = b >> 4
        if size == 15:
            size = self.varint()
        return size, b & 0x0F

    def fields(self) -> Iterator[tuple[int, int]]:
        """Yield (field id, type) until STOP; caller reads/skips value.
        Boolean values are encoded in the type (CT_TRUE/CT_FALSE)."""
        fid = 0
        while True:
            b = self.byte()
            if b == CT_STOP:
                return
            delta = b >> 4
            ftype = b & 0x0F
            fid = fid + delta if delta else self.zigzag()
            yield fid, ftype


class TWriter:
    def __init__(self):
        self.out = bytearray()
        self._fid_stack: list[int] = []
        self._fid = 0

    def varint(self, n: int) -> None:
        while True:
            if n < 0x80:
                self.out.append(n)
                return
            self.out.append((n & 0x7F) | 0x80)
            n >>= 7

    def zigzag(self, n: int) -> None:
        self.varint((n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1)

    def struct_begin(self) -> None:
        self._fid_stack.append(self._fid)
        self._fid = 0

    def struct_end(self) -> None:
        self.out.append(CT_STOP)
        self._fid = self._fid_stack.pop()

    def field(self, fid: int, ftype: int) -> None:
        delta = fid - self._fid
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ftype)
        else:
            self.out.append(ftype)
            self.zigzag(fid)
        self._fid = fid

    def i32(self, fid: int, v: int) -> None:
        self.field(fid, CT_I32)
        self.zigzag(v)

    def i64(self, fid: int, v: int) -> None:
        self.field(fid, CT_I64)
        self.zigzag(v)

    def binary(self, fid: int, v: bytes) -> None:
        self.field(fid, CT_BINARY)
        self.varint(len(v))
        self.out += v

    def list_begin(self, fid: int, etype: int, size: int) -> None:
        self.field(fid, CT_LIST)
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self.varint(size)


# ---------------------------------------------------------------------------
# metadata model
# ---------------------------------------------------------------------------

@dataclass
class Column:
    name: str
    type: int                      # parquet physical type
    repetition: int = REQUIRED
    converted: Optional[int] = None     # CT_UTF8 for strings


@dataclass
class _ChunkMeta:
    type: int = 0
    codec: int = 0
    num_values: int = 0
    data_page_offset: int = 0
    dict_page_offset: Optional[int] = None
    total_compressed_size: int = 0
    path: list[str] = field(default_factory=list)


def _decode_schema(r: TReader) -> list[Column]:
    cols: list[Column] = []
    size, _ = r.list_header()
    for i in range(size):
        name, ptype, rep, conv, nchildren = "", None, REQUIRED, None, 0
        for fid, ft in r.fields():
            if fid == 1:
                ptype = r.zigzag()
            elif fid == 3:
                rep = r.zigzag()
            elif fid == 4:
                name = r.binary().decode()
            elif fid == 5:
                nchildren = r.zigzag()
            elif fid == 6:
                conv = r.zigzag()
            else:
                r.skip(ft)
        if i == 0:
            if nchildren != size - 1:
                raise ParquetError("nested schemas not supported")
            continue                      # root element
        if ptype is None:
            raise ParquetError("nested schemas not supported")
        cols.append(Column(name, ptype, rep, conv))
    return cols


def _decode_chunk_meta(r: TReader) -> _ChunkMeta:
    m = _ChunkMeta()
    for fid, ft in r.fields():
        if fid == 3:                      # ColumnMetaData
            for cfid, cft in r.fields():
                if cfid == 1:
                    m.type = r.zigzag()
                elif cfid == 3:
                    n, _et = r.list_header()
                    m.path = [r.binary().decode() for _ in range(n)]
                elif cfid == 4:
                    m.codec = r.zigzag()
                elif cfid == 5:
                    m.num_values = r.zigzag()
                elif cfid == 7:
                    m.total_compressed_size = r.zigzag()
                elif cfid == 9:
                    m.data_page_offset = r.zigzag()
                elif cfid == 11:
                    m.dict_page_offset = r.zigzag()
                else:
                    r.skip(cft)
        else:
            r.skip(ft)
    return m


@dataclass
class _PageHeader:
    type: int = 0
    uncompressed_size: int = 0
    compressed_size: int = 0
    num_values: int = 0
    encoding: int = ENC_PLAIN


def _decode_page_header(r: TReader) -> _PageHeader:
    h = _PageHeader()
    for fid, ft in r.fields():
        if fid == 1:
            h.type = r.zigzag()
        elif fid == 2:
            h.uncompressed_size = r.zigzag()
        elif fid == 3:
            h.compressed_size = r.zigzag()
        elif fid in (5, 7):               # DataPageHeader/DictionaryPageHeader
            for pfid, pft in r.fields():
                if pfid == 1:
                    h.num_values = r.zigzag()
                elif pfid == 2:
                    h.encoding = r.zigzag()
                else:
                    r.skip(pft)
        else:
            r.skip(ft)
    return h


# ---------------------------------------------------------------------------
# value decoding
# ---------------------------------------------------------------------------

def _decompress(body: bytes, codec: int, want: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return body
    if codec == CODEC_SNAPPY:
        return mtc.decompress_block(body)
    if codec == CODEC_GZIP:
        import gzip
        return gzip.decompress(body)
    raise ParquetError(f"unsupported codec {codec}")


# in-memory materialization cap: a 4-byte RLE run (or a forged
# num_rows) may legally DECLARE billions of values; materializing them
# from a small Select input is a decompression bomb, not a query
# (fuzz-tier finding).  64M values per chunk is far beyond any sane
# Select payload.
_MAX_VALUES = 1 << 26


def _read_rle_hybrid(buf: bytes, pos: int, end: int, bit_width: int,
                     count: int) -> list[int]:
    """RLE/bit-packed hybrid runs until `count` values are produced."""
    if count > _MAX_VALUES:
        raise ParquetError(f"value count {count} exceeds the in-memory "
                           f"reader limit")
    out: list[int] = []
    byte_width = (bit_width + 7) // 8
    while len(out) < count and pos < end:
        header = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:                     # bit-packed group
            groups = header >> 1
            nbits = groups * 8 * bit_width
            nbytes = (nbits + 7) // 8
            avail = max(0, min(nbytes, end - pos))
            bits = int.from_bytes(buf[pos:pos + avail], "little")
            pos += nbytes
            mask = (1 << bit_width) - 1
            # iterate only over bits the buffer actually holds: a
            # forged group count must not spin past the data
            have = (avail * 8) // bit_width if bit_width else 0
            for i in range(min(groups * 8, have)):
                if len(out) >= count:
                    break
                out.append((bits >> (i * bit_width)) & mask)
        else:                              # RLE run
            run = header >> 1
            v = int.from_bytes(buf[pos:pos + byte_width], "little") \
                if byte_width else 0
            pos += byte_width
            out.extend([v] * min(run, count - len(out)))
    if len(out) < count:
        raise ParquetError("truncated RLE/bit-packed run")
    return out


def _decode_plain(buf: bytes, ptype: int, count: int) -> list[Any]:
    vals: list[Any] = []
    pos = 0
    if ptype == INT32:
        return list(struct.unpack_from(f"<{count}i", buf, 0))
    if ptype == INT64:
        return list(struct.unpack_from(f"<{count}q", buf, 0))
    if ptype == DOUBLE:
        return list(struct.unpack_from(f"<{count}d", buf, 0))
    if ptype == FLOAT:
        return list(struct.unpack_from(f"<{count}f", buf, 0))
    if ptype == BOOLEAN:
        for i in range(count):
            vals.append(bool((buf[i // 8] >> (i % 8)) & 1))
        return vals
    if ptype == BYTE_ARRAY:
        for _ in range(count):
            n = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            vals.append(bytes(buf[pos:pos + n]))
            pos += n
        return vals
    raise ParquetError(f"unsupported physical type {ptype}")


def _bit_width(maxval: int) -> int:
    return max(maxval.bit_length(), 0)


class ParquetReader:
    """Row-oriented reader over a flat parquet file held in memory."""

    def __init__(self, data: bytes):
        if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
            raise ParquetError("not a parquet file (bad magic)")
        try:
            self._parse_footer(data)
        except ParquetError:
            raise
        except (struct.error, IndexError, UnicodeDecodeError,
                OverflowError, MemoryError, ValueError) as e:
            # truncated/corrupt metadata must surface as a parse error
            # (400), not an unhandled 500 — including non-UTF8 schema
            # names and absurd varint sizes (fuzz-tier findings)
            raise ParquetError(f"corrupt parquet metadata: {e}") from e

    def _parse_footer(self, data: bytes) -> None:
        footer_len = struct.unpack("<I", data[-8:-4])[0]
        meta = TReader(data[-8 - footer_len:-8])
        self.data = data
        self.columns: list[Column] = []
        self.num_rows = 0
        self._row_groups: list[tuple[int, list[_ChunkMeta]]] = []
        for fid, ft in meta.fields():
            if fid == 2:
                self.columns = _decode_schema(meta)
            elif fid == 3:
                self.num_rows = meta.zigzag()
            elif fid == 4:
                size, _ = meta.list_header()
                for _ in range(size):
                    rows, chunks = 0, []
                    for gfid, gft in meta.fields():
                        if gfid == 1:
                            n, _et = meta.list_header()
                            chunks = [_decode_chunk_meta(meta)
                                      for _ in range(n)]
                        elif gfid == 3:
                            rows = meta.zigzag()
                        else:
                            meta.skip(gft)
                    self._row_groups.append((rows, chunks))
            else:
                meta.skip(ft)
        self._by_name = {c.name: c for c in self.columns}

    # -- column chunk decode ------------------------------------------------

    def _read_chunk(self, meta: _ChunkMeta, col: Column,
                    rows: int) -> list[Any]:
        pos = meta.dict_page_offset \
            if meta.dict_page_offset is not None else meta.data_page_offset
        dictionary: Optional[list[Any]] = None
        values: list[Any] = []
        max_def = 1 if col.repetition == OPTIONAL else 0
        while len(values) < rows:
            r = TReader(self.data, pos)
            h = _decode_page_header(r)
            body = self.data[r.pos:r.pos + h.compressed_size]
            pos = r.pos + h.compressed_size
            body = _decompress(body, meta.codec, h.uncompressed_size)
            if h.type == PAGE_DICT:
                dictionary = _decode_plain(body, col.type, h.num_values)
                continue
            if h.type != PAGE_DATA:
                raise ParquetError(
                    f"unsupported page type {h.type} (need data page v1)")
            bpos = 0
            defs = None
            if max_def:
                dlen = struct.unpack_from("<I", body, 0)[0]
                defs = _read_rle_hybrid(body, 4, 4 + dlen,
                                        _bit_width(max_def), h.num_values)
                bpos = 4 + dlen
            present = h.num_values if defs is None \
                else sum(1 for d in defs if d == max_def)
            if h.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
                if dictionary is None:
                    raise ParquetError("dictionary page missing")
                bw = body[bpos]
                idx = _read_rle_hybrid(body, bpos + 1, len(body), bw,
                                       present)
                page_vals = [dictionary[i] for i in idx]
            elif h.encoding == ENC_PLAIN:
                page_vals = _decode_plain(body[bpos:], col.type, present)
            else:
                raise ParquetError(f"unsupported encoding {h.encoding}")
            if defs is None:
                values.extend(page_vals)
            else:
                it = iter(page_vals)
                values.extend(next(it) if d == max_def else None
                              for d in defs)
        return values[:rows]

    # -- row iteration ------------------------------------------------------

    def rows(self) -> Iterator[dict[str, Any]]:
        try:
            yield from self._rows_inner()
        except ParquetError:
            raise
        except (struct.error, IndexError, UnicodeDecodeError,
                OverflowError, MemoryError, ValueError) as e:
            raise ParquetError(f"corrupt parquet data: {e}") from e

    def _rows_inner(self) -> Iterator[dict[str, Any]]:
        for nrows, chunks in self._row_groups:
            table: dict[str, list[Any]] = {}
            for m in chunks:
                name = m.path[-1] if m.path else ""
                col = self._by_name.get(name)
                if col is None:
                    continue
                vals = self._read_chunk(m, col, nrows)
                if col.type == BYTE_ARRAY and col.converted == CT_UTF8:
                    vals = [v.decode("utf-8", "replace")
                            if isinstance(v, bytes) else v for v in vals]
                table[name] = vals
            for i in range(nrows):
                yield {name: table[name][i] for name in table}


# ---------------------------------------------------------------------------
# writer (tests + tooling): one row group, PLAIN, optional snappy
# ---------------------------------------------------------------------------

def _encode_plain(vals: list[Any], ptype: int) -> bytes:
    if ptype == INT32:
        return struct.pack(f"<{len(vals)}i", *vals)
    if ptype == INT64:
        return struct.pack(f"<{len(vals)}q", *vals)
    if ptype == DOUBLE:
        return struct.pack(f"<{len(vals)}d", *vals)
    if ptype == FLOAT:
        return struct.pack(f"<{len(vals)}f", *vals)
    if ptype == BOOLEAN:
        out = bytearray((len(vals) + 7) // 8)
        for i, v in enumerate(vals):
            if v:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)
    if ptype == BYTE_ARRAY:
        out = bytearray()
        for v in vals:
            b = v.encode() if isinstance(v, str) else bytes(v)
            out += struct.pack("<I", len(b)) + b
        return bytes(out)
    raise ParquetError(f"unsupported physical type {ptype}")


def _rle_bits(values: list[int], bit_width: int) -> bytes:
    """Encode as a single bit-packed group run (fine for test files)."""
    groups = (len(values) + 7) // 8
    out = bytearray()
    header = (groups << 1) | 1
    while True:
        if header < 0x80:
            out.append(header)
            break
        out.append((header & 0x7F) | 0x80)
        header >>= 7
    bits = 0
    for i, v in enumerate(values):
        bits |= (v & ((1 << bit_width) - 1)) << (i * bit_width)
    out += bits.to_bytes((groups * 8 * bit_width + 7) // 8, "little")
    return bytes(out)


def write_parquet(columns: list[Column], rows: list[dict[str, Any]],
                  codec: int = CODEC_UNCOMPRESSED) -> bytes:
    """Serialize rows into a single-row-group parquet file."""
    out = bytearray(MAGIC)
    chunk_metas: list[tuple[Column, int, int, int]] = []  # col, off, size, n
    for col in columns:
        vals = [r.get(col.name) for r in rows]
        max_def = 1 if col.repetition == OPTIONAL else 0
        body = bytearray()
        if max_def:
            defs = [0 if v is None else 1 for v in vals]
            enc = _rle_bits(defs, 1)
            body += struct.pack("<I", len(enc)) + enc
            present = [v for v in vals if v is not None]
        else:
            if any(v is None for v in vals):
                raise ParquetError(f"required column {col.name} has nulls")
            present = vals
        body += _encode_plain(present, col.type)
        raw = bytes(body)
        comp = mtc.compress_block(raw) if codec == CODEC_SNAPPY else raw
        # PageHeader
        w = TWriter()
        w.struct_begin()
        w.i32(1, PAGE_DATA)
        w.i32(2, len(raw))
        w.i32(3, len(comp))
        w.field(5, CT_STRUCT)              # DataPageHeader
        w.struct_begin()
        w.i32(1, len(vals))
        w.i32(2, ENC_PLAIN)
        w.i32(3, ENC_RLE)
        w.i32(4, ENC_RLE)
        w.struct_end()
        w.struct_end()
        off = len(out)
        out += w.out + comp
        chunk_metas.append((col, off, len(w.out) + len(comp), len(vals)))

    # FileMetaData footer
    w = TWriter()
    w.struct_begin()
    w.i32(1, 1)                            # version
    w.list_begin(2, CT_STRUCT, len(columns) + 1)
    w.struct_begin()                       # root schema element
    w.binary(4, b"schema")
    w.i32(5, len(columns))
    w.struct_end()
    for col in columns:
        w.struct_begin()
        w.i32(1, col.type)
        w.i32(3, col.repetition)
        w.binary(4, col.name.encode())
        if col.converted is not None:
            w.i32(6, col.converted)
        w.struct_end()
    w.i64(3, len(rows))                    # num_rows
    w.list_begin(4, CT_STRUCT, 1)          # row_groups
    w.struct_begin()
    w.list_begin(1, CT_STRUCT, len(chunk_metas))
    total = 0
    for col, off, size, n in chunk_metas:
        total += size
        w.struct_begin()                   # ColumnChunk
        w.i64(2, off)                      # file_offset
        w.field(3, CT_STRUCT)              # ColumnMetaData
        w.struct_begin()
        w.i32(1, col.type)
        w.list_begin(2, CT_I32, 1)
        w.zigzag(ENC_PLAIN)
        w.list_begin(3, CT_BINARY, 1)
        w.varint(len(col.name.encode()))
        w.out += col.name.encode()
        w.i32(4, codec)
        w.i64(5, n)
        w.i64(6, size)
        w.i64(7, size)
        w.i64(9, off)                      # data_page_offset
        w.struct_end()
        w.struct_end()
    w.i64(2, total)                        # total_byte_size
    w.i64(3, len(rows))                    # num_rows
    w.struct_end()
    w.struct_end()
    footer = bytes(w.out)
    out += footer
    out += struct.pack("<I", len(footer))
    out += MAGIC
    return bytes(out)


def parquet_records(data: bytes) -> Iterator[dict[str, Any]]:
    """Record stream for the select engine (records.py reader shape).
    The footer parses eagerly so a bad file fails before iteration."""
    return ParquetReader(data).rows()

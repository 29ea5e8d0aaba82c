"""Record readers/writers for S3 Select (``minio_tpu/s3select/records.py``;
pkg/s3select/csv/, json/).

CSV input honors FileHeaderInfo USE/IGNORE/NONE, custom delimiters and
quotes (pkg/s3select/csv/args.go); JSON input handles LINES and DOCUMENT
types (pkg/s3select/json/args.go).  Positional columns are always
available as _1.._N, matching the reference's column addressing.
"""

from __future__ import annotations

import csv as _csv
import io
import json as _json
from typing import Iterator

from ..utils import close_quietly


def csv_records(data: bytes, opts: dict) -> Iterator[dict]:
    return csv_records_stream((data,), opts)


def csv_records_stream(blocks, opts: dict) -> Iterator[dict]:
    """CSV rows over an iterator of byte blocks, each holding COMPLETE
    records (a :class:`RecordChunker` upstream guarantees no record —
    even a quoted multi-line field — straddles a block).  Header state
    carries across blocks, so block boundaries are invisible to the
    caller; one-block input is exactly the old whole-buffer reader."""
    rd = opts.get("record_delim", "\n")
    comment = opts.get("comment") or None
    header_mode = opts.get("header", "NONE")
    headers: list[str] | None = None
    saw_first = False                # first NON-skipped row is the header
    for block in blocks:
        text = block.decode("utf-8", errors="replace")
        if rd not in ("\n", "\r\n"):
            text = text.replace(rd, "\n")
        reader = _csv.reader(
            io.StringIO(text),
            delimiter=opts.get("field_delim", ",") or ",",
            quotechar=opts.get("quote", '"') or '"')
        for fields in reader:
            if not fields:
                continue
            if comment and fields[0].startswith(comment):
                continue
            if not saw_first:
                saw_first = True
                if header_mode == "USE":
                    headers = [h.strip() for h in fields]
                    continue
                if header_mode == "IGNORE":
                    continue
            # named keys only when headers exist — SELECT * must not
            # emit columns twice; _N positional addressing is resolved
            # by the SQL evaluator's index fallback
            row: dict = {}
            for j, v in enumerate(fields):
                if headers and j < len(headers):
                    row[headers[j]] = v
                else:
                    row[f"_{j + 1}"] = v
            yield row


class RecordChunker:
    """Splits an arbitrary byte stream into blocks of COMPLETE records
    — the streaming scanner's framing layer.  ``feed`` returns every
    byte up to (and including) the last record delimiter that sits
    OUTSIDE a quoted field, retaining the tail; ``flush`` returns the
    final partial record.  Quoting follows the csv module's reader
    rules EXACTLY (the whole-buffer parser the streamed path must stay
    byte-identical to): a quote opens a quoted field only at FIELD
    START (buffer start, after the field delimiter, or after the
    record delimiter) — a stray mid-field quote is literal; inside
    quotes a doubled quote is an escaped literal and any other quote
    closes the field.  State is per-buffer only: the buffer always
    begins outside quotes because cuts only happen at outside-quote
    delimiters.  Pass ``quote=None`` for quote-free formats (JSON
    Lines)."""

    def __init__(self, record_delim: bytes = b"\n",
                 quote: bytes | None = b'"',
                 field_delim: bytes = b","):
        self._delim = record_delim or b"\n"
        self._quote = quote if quote else None
        self._field_delim = field_delim or b","
        self._buf = bytearray()

    def feed(self, data: bytes) -> bytes:
        self._buf += data
        buf = self._buf
        if self._quote is None or self._quote not in buf:
            cut = buf.rfind(self._delim)
            if cut < 0:
                return b""
            cut += len(self._delim)
            out = bytes(buf[:cut])
            del buf[:cut]
            return out
        # quoted content present: split at quote chars (C speed) and
        # classify each inter-quote segment inside/outside by walking
        # the O(#quotes) boundary list with the csv rules above, then
        # take the LAST delimiter in an outside segment
        raw = bytes(buf)
        segs = raw.split(self._quote)
        qlen = len(self._quote)
        n = len(segs)
        offsets = []
        pos = 0
        for s in segs:
            offsets.append(pos)
            pos += len(s) + qlen
        inside = [False] * n            # seg 0 starts outside
        fd = self._field_delim[-1:]
        rd = self._delim[-1:]
        in_q = False
        j = 1
        while j < n:
            if not in_q:
                p = offsets[j] - qlen   # this boundary's quote char
                prev = raw[p - 1:p] if p else b""
                if p == 0 or prev == fd or prev == rd:
                    in_q = True         # opening quote at field start
                # else: literal mid-field quote, no state change
                inside[j] = in_q
                j += 1
            elif segs[j] == b"":
                # adjacent quote: "" escape (still inside) — or, when
                # the quote is the buffer's LAST byte, an AMBIGUOUS
                # close-vs-escape whose other half may arrive next
                # feed: defer (stay inside; a cut can always wait for
                # more data, the re-scan then decides with context)
                inside[j] = True
                j += 1
                if j < n:
                    inside[j] = True
                    j += 1
            else:
                in_q = False            # closing quote
                inside[j] = False
                j += 1
        cut = -1
        for i in range(n - 1, -1, -1):
            if inside[i]:
                continue
            k = segs[i].rfind(self._delim)
            if k >= 0:
                cut = offsets[i] + k
                break
        if cut < 0:
            return b""
        cut += len(self._delim)
        out = bytes(buf[:cut])
        del buf[:cut]
        return out

    def flush(self) -> bytes:
        out = bytes(self._buf)
        self._buf = bytearray()
        return out


def record_blocks(chunks, record_delim: bytes = b"\n",
                  quote: bytes | None = b'"',
                  field_delim: bytes = b",") -> Iterator[bytes]:
    """Re-frame a byte-chunk iterator at record boundaries: yields one
    block of complete records per input chunk (skipping chunks that
    completed none), then the final partial record."""
    ck = RecordChunker(record_delim, quote, field_delim)
    try:
        for chunk in chunks:
            block = ck.feed(chunk)
            if block:
                yield block
        tail = ck.flush()
        if tail:
            yield tail
    finally:
        close_quietly(chunks)


def json_records(data: bytes, opts: dict) -> Iterator[dict]:
    jtype = opts.get("type", "LINES")
    text = data.decode("utf-8", errors="replace")
    if jtype == "LINES":
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            yield _wrap(_json.loads(line))
    else:  # DOCUMENT: one value, or concatenated values
        dec = _json.JSONDecoder()
        i, n = 0, len(text)
        while i < n:
            while i < n and text[i].isspace():
                i += 1
            if i >= n:
                break
            obj, end = dec.raw_decode(text, i)
            i = end
            if isinstance(obj, list):
                for item in obj:
                    yield _wrap(item)
            else:
                yield _wrap(obj)


def _wrap(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    return {"_1": obj}


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def to_csv_record(row: dict, opts: dict) -> bytes:
    delim = opts.get("field_delim", ",") or ","
    quote = opts.get("quote", '"') or '"'
    rd = opts.get("record_delim", "\n")
    fields = []
    for v in row.values():
        s = _fmt(v)
        if delim in s or quote in s or "\n" in s or "\r" in s:
            s = quote + s.replace(quote, quote + quote) + quote
        fields.append(s)
    return (delim.join(fields) + rd).encode()


def to_json_record(row: dict, opts: dict) -> bytes:
    rd = opts.get("record_delim", "\n")
    clean = {k: v for k, v in row.items()}
    # compact separators: the service emits no whitespace in JSON
    # output records (observable AWS behavior; select.go json writer)
    return (_json.dumps(clean, default=str, separators=(",", ":"))
            + rd).encode()

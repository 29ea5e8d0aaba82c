"""S3 Select: SQL over CSV, JSON and Parquet objects
(``minio_tpu/s3select/__init__.py``; pkg/s3select, select.go:541
NewS3Select and :398, the Evaluate record loop).

``sql.py`` is the lexer, parser and evaluator, ``records.py`` the CSV
and JSON record readers and writers with the ``RecordChunker``,
``parquet.py`` the Parquet reader, and ``message.py`` the AWS
event-stream framing.  ``run_select_stream`` parses the
SelectObjectContentRequest, pulls the object's decoded bytes a block at
a time (gzip and bzip2 inputs decoded as they stream), splits them at
record boundaries, runs the query over the records and yields the
framed events as the scan advances; ``run_select`` is the same scan over
one buffer.  A JSON Lines input is evaluated row by row with the full
WHERE: the reference's native prefilter (``native/jsonscan.cc``) only
skips rows that WHERE would drop, so the answers are the same.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from ..utils import close_quietly
from . import message, records, sql


class SelectError(Exception):
    """Carries an S3 error code for the handler."""

    def __init__(self, code: str, msg: str = ""):
        super().__init__(msg or code)
        self.code = code


def _text(el, name: str, default: str = "") -> str:
    if el is None:
        return default
    v = el.findtext(name)
    return default if v is None else v


class SelectRequest:
    """Parsed SelectObjectContentRequest (pkg/s3select/select.go:114)."""

    def __init__(self, expression: str, input_format: str,
                 input_opts: dict, output_format: str, output_opts: dict,
                 compression: str, progress: bool = False):
        self.expression = expression
        self.input_format = input_format      # "CSV" | "JSON"
        self.input_opts = input_opts
        self.output_format = output_format    # "CSV" | "JSON"
        self.output_opts = output_opts
        self.compression = compression    # "NONE" | "GZIP" | "BZIP2"
        # RequestProgress.Enabled (select.go:114 parseRequestProgress):
        # periodic Progress frames ride the stream only when asked
        self.progress = progress

    @classmethod
    def parse(cls, payload: bytes) -> "SelectRequest":
        try:
            root = ET.fromstring(payload)
        except ET.ParseError as e:
            raise SelectError("MalformedXML") from e
        # strip namespaces
        for el in root.iter():
            if "}" in el.tag:
                el.tag = el.tag.split("}", 1)[1]
        expr = root.findtext("Expression") or ""
        etype = root.findtext("ExpressionType") or "SQL"
        if etype.upper() != "SQL" or not expr.strip():
            raise SelectError("InvalidExpressionType")
        inser = root.find("InputSerialization")
        if inser is None:
            raise SelectError("InvalidRequestParameter",
                              "InputSerialization required")
        compression = _text(inser, "CompressionType", "NONE").upper()
        if compression not in ("NONE", "GZIP", "BZIP2"):
            raise SelectError("InvalidCompressionFormat")
        csv_el, json_el = inser.find("CSV"), inser.find("JSON")
        parquet_el = inser.find("Parquet")
        if parquet_el is not None:
            # parquet pages carry their own codec; object-level
            # compression is invalid (select.go parquet input rules)
            if compression != "NONE":
                raise SelectError("InvalidCompressionFormat")
            fmt, opts = "PARQUET", {}
        elif csv_el is not None:
            fmt = "CSV"
            opts = {
                "header": _text(csv_el, "FileHeaderInfo", "NONE").upper(),
                "field_delim": _text(csv_el, "FieldDelimiter", ","),
                "record_delim": _text(csv_el, "RecordDelimiter", "\n"),
                "quote": _text(csv_el, "QuoteCharacter", '"'),
                "comment": _text(csv_el, "Comments", ""),
            }
        elif json_el is not None:
            fmt = "JSON"
            opts = {"type": _text(json_el, "Type", "LINES").upper()}
        else:
            raise SelectError("InvalidDataSource")
        outser = root.find("OutputSerialization")
        ocsv = outser.find("CSV") if outser is not None else None
        ojson = outser.find("JSON") if outser is not None else None
        if ojson is not None:
            ofmt, oopts = "JSON", {
                "record_delim": _text(ojson, "RecordDelimiter", "\n")}
        else:
            ofmt, oopts = "CSV", {
                "field_delim": _text(ocsv, "FieldDelimiter", ","),
                "record_delim": _text(ocsv, "RecordDelimiter", "\n"),
                "quote": _text(ocsv, "QuoteCharacter", '"'),
            }
        prog = root.find("RequestProgress")
        progress = _text(prog, "Enabled", "FALSE").upper() == "TRUE"
        return cls(expr, fmt, opts, ofmt, oopts, compression, progress)


class _ScanState:
    """Live byte counters the pipeline wrappers tick as blocks flow —
    the source of Progress/Stats numbers."""

    __slots__ = ("scanned", "processed", "returned")

    def __init__(self):
        self.scanned = 0      # stored (possibly compressed) bytes read
        self.processed = 0    # bytes after object-level decompression
        self.returned = 0     # output payload bytes emitted


def _counted(chunks, st: _ScanState, attr: str):
    """Pass chunks through, adding their lengths to one counter."""
    try:
        for c in chunks:
            setattr(st, attr, getattr(st, attr) + len(c))
            yield c
    finally:
        close_quietly(chunks)


def _gunzip_chunks(chunks):
    """Streaming multi-member gzip decode; empty/truncated/corrupt
    input raises SelectError exactly where ``gzip.decompress`` would
    have (the buffered reference semantics)."""
    import zlib
    d = zlib.decompressobj(31)
    fed = False                 # current member has received bytes
    members = 0
    try:
        for c in chunks:
            data = c
            while data:
                try:
                    out = d.decompress(data)
                except zlib.error as e:
                    raise SelectError("InvalidCompressionFormat") from e
                fed = True
                if out:
                    yield out
                if d.eof:
                    members += 1
                    data = d.unused_data
                    d = zlib.decompressobj(31)
                    fed = False
                else:
                    data = b""
        if members == 0 or fed:
            # no complete stream at all, or one ended mid-member —
            # gzip.decompress raises EOFError for both
            raise SelectError("InvalidCompressionFormat")
    finally:
        close_quietly(chunks)


def _bunzip_chunks(chunks):
    """Streaming (possibly concatenated) bzip2 decode, matching
    ``bz2.decompress``: empty input is empty output, garbage AFTER a
    complete stream is ignored, a stream ending mid-member errors."""
    import bz2
    d = bz2.BZ2Decompressor()
    fed = False
    members = 0
    try:
        for c in chunks:
            data = c
            while data:
                try:
                    out = d.decompress(data)
                except (OSError, ValueError, EOFError) as e:
                    if members:
                        return      # trailing garbage: ignored
                    raise SelectError("InvalidCompressionFormat") from e
                fed = True
                if out:
                    yield out
                if d.eof:
                    members += 1
                    data = d.unused_data
                    d = bz2.BZ2Decompressor()
                    fed = False
                else:
                    data = b""
        if fed:
            raise SelectError("InvalidCompressionFormat")
    finally:
        close_quietly(chunks)


def _rechunk(chunks, n: int):
    """Split oversized pieces so downstream blocks stay <= n bytes —
    a non-streaming layer (the ObjectLayer default reader yields the
    whole object as one chunk) must not defeat the record splitter's
    memory bound."""
    try:
        for c in chunks:
            if len(c) <= n:
                yield c
            else:
                for off in range(0, len(c), n):
                    yield bytes(c[off:off + n])
    finally:
        close_quietly(chunks)


def _record_reader(req: SelectRequest, blocks):
    """One continuous record stream over complete-record blocks —
    what sql.execute consumes."""
    if req.input_format == "CSV":
        yield from records.csv_records_stream(blocks, req.input_opts)
        return
    for block in blocks:
        yield from records.json_records(block, req.input_opts)


# Records event payload cap (message.go maxRecordSize): the buffered
# reference chunked its whole output at these boundaries, and the
# incremental framer reproduces them exactly — byte-identical streams
RECORDS_CHUNK = 1 << 20
# scanned-byte interval between periodic Progress frames (when the
# request asked); each is preceded by a Cont keep-alive frame
PROGRESS_INTERVAL = 8 << 20


def run_select_stream(payload: bytes, chunks, *,
                      block_bytes: int = 1 << 20,
                      on_stats=None):
    """Incremental SelectObjectContentRequest scanner: pulls decoded
    object bytes from ``chunks`` block-at-a-time, feeds record
    splitting and the query, and yields framed events as the scan
    advances — peak memory O(block) regardless of object size
    (select.go:398 Evaluate record loop).

    Request/SQL parse errors raise :exc:`SelectError` eagerly, before
    the first frame; reader errors surface as SelectError from the
    generator mid-iteration (the handler turns them into a 400 when
    nothing was sent yet, an error frame when the stream is live).
    ``on_stats(scanned, processed, returned)`` fires before the Stats
    frame.  JSON DOCUMENT and Parquet inputs need random access /
    whole-value parses and fall back to materializing the object."""
    req = SelectRequest.parse(payload)
    try:
        query = sql.parse_query(req.expression)
    except sql.SQLError as e:
        raise SelectError("ParseSelectFailure", str(e)) from e
    return _frames(req, query, chunks, block_bytes, on_stats)


def _frames(req: SelectRequest, query, chunks, block_bytes: int,
            on_stats):
    st = _ScanState()
    src = _counted(chunks, st, "scanned")
    if req.compression == "GZIP":
        src = _gunzip_chunks(src)
    elif req.compression == "BZIP2":
        src = _bunzip_chunks(src)
    src = _counted(src, st, "processed")
    if block_bytes > 0:
        src = _rechunk(src, block_bytes)

    if req.input_format == "PARQUET" or (
            req.input_format == "JSON" and
            req.input_opts.get("type", "LINES") != "LINES"):
        # whole-value inputs: Parquet needs footer-first random access,
        # a JSON DOCUMENT is one value — materialize (the documented
        # non-streaming fallback; CSV and JSON Lines stay O(block))
        # (the front charges twice the decoded size for it)
        data = b"".join(src)
        if req.input_format == "PARQUET":
            from . import parquet as pq
            try:
                reader = pq.parquet_records(data)
            except pq.ParquetError as e:
                raise SelectError("InvalidDataSource", str(e)) from e
        else:
            reader = records.json_records(data, req.input_opts)
    else:
        quote = None
        delim = b"\n"
        if req.input_format == "CSV":
            delim = (req.input_opts.get("record_delim") or "\n").encode()
            q = req.input_opts.get("quote", '"')
            quote = q.encode() if q else None
        fdelim = (req.input_opts.get("field_delim") or ",").encode() \
            if req.input_format == "CSV" else b","
        blocks = records.record_blocks(src, delim, quote, fdelim)
        reader = _record_reader(req, blocks)

    pending = bytearray()
    last_progress = 0
    try:
        try:
            rows = sql.execute(query, reader)
            for row in rows:
                if req.output_format == "JSON":
                    rec = records.to_json_record(row, req.output_opts)
                else:
                    rec = records.to_csv_record(row, req.output_opts)
                pending += rec
                st.returned += len(rec)
                while len(pending) >= RECORDS_CHUNK:
                    yield message.records_event(
                        bytes(pending[:RECORDS_CHUNK]))
                    del pending[:RECORDS_CHUNK]
                if req.progress and \
                        st.scanned - last_progress >= PROGRESS_INTERVAL:
                    last_progress = st.scanned
                    yield message.continuation_event()
                    yield message.progress_event(
                        st.scanned, st.processed, st.returned)
        except sql.SQLError as e:
            raise SelectError("EvaluatorInvalidArguments", str(e)) from e
        except (ValueError, TypeError, KeyError) as e:
            # reader parse failures surface mid-iteration (generators):
            # malformed input is a 400 parse error, never a 500
            code = {"JSON": "JSONParsingError",
                    "PARQUET": "InvalidDataSource"}.get(
                req.input_format, "CSVParsingError")
            raise SelectError(code, str(e)) from e
        if pending:
            yield message.records_event(bytes(pending))
        if req.progress:
            yield message.progress_event(st.scanned, st.processed,
                                         st.returned)
        if on_stats is not None:
            on_stats(st.scanned, st.processed, st.returned)
        yield message.stats_event(st.scanned, st.processed, st.returned)
        yield message.end_event()
    finally:
        close_quietly(src)


def run_select(payload: bytes, data: bytes) -> bytes:
    """Execute a SelectObjectContentRequest against object bytes;
    returns the framed event-stream response body.  One join over the
    incremental scanner — the whole-buffer path and the streaming path
    ARE the same code, so their outputs are byte-identical by
    construction.
    block_bytes=0: the single whole-buffer chunk is not re-split."""
    return b"".join(run_select_stream(payload, (data,), block_bytes=0))

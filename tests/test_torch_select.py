"""S3 Select on the port (``minio_tpu_torch/s3select``, ``POST
?select&select-type=2``) against ``minio_tpu``'s.

The host oracles first, at many inputs: for a table of requests (CSV
with and without a header, JSON lines and documents, Parquet written by
the reference's ``write_parquet``, gzip and bzip2 inputs; WHERE,
projections, aggregates, LIMIT, casts, a malformed query, an unknown
function) the port's framed answer equals the reference's byte for
byte, event-stream CRCs included, or both refuse with the same code;
the streamed scan at several block sizes equals the buffered one.  Then
the servers, at few: both (``_torch_control``: two sets of four drives,
4 KiB blocks) answer the same Select alike on a plain, an SSE-S3 and a
compressed CSV object, past ``SELECT_FLUSH_BYTES`` (the chunked
route), and under memory pressure (503 before a byte is read)."""

import base64
import bz2
import gzip
import json
import os

import numpy as np
import pytest

import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu import s3select as ref_sel
from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.s3select import parquet as ref_pq
from minio_tpu.utils import memgov as ref_memgov
from minio_tpu_torch import s3select as port_sel
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.utils import memgov as port_memgov

from ._torch_control import servers
from ._torch_objfeat import Pair
from ._torch_versions import Draws


def _req(expression, input_xml, output_xml="<CSV/>", progress=False):
    prog = ("<RequestProgress><Enabled>TRUE</Enabled></RequestProgress>"
            if progress else "")
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<SelectObjectContentRequest '
        'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
        f"<Expression>{expression}</Expression>"
        "<ExpressionType>SQL</ExpressionType>"
        f"{prog}"
        f"<InputSerialization>{input_xml}</InputSerialization>"
        f"<OutputSerialization>{output_xml}</OutputSerialization>"
        "</SelectObjectContentRequest>").encode()


def _rows(n: int, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    cities = ["paris", "tokyo", "lima", "oslo, north", 'say "hi"']
    return [{"id": i, "name": f"user{i}",
             "amount": round(float(rng.uniform(0, 1000)), 2),
             "city": cities[int(rng.integers(0, len(cities)))]}
            for i in range(n)]


ROWS = _rows(600)


def _csv(rows, header=True, delim=",") -> bytes:
    def field(v):
        s = str(v)
        return '"' + s.replace('"', '""') + '"' \
            if delim in s or '"' in s else s
    lines = [delim.join(rows[0])] if header else []
    lines += [delim.join(field(r[k]) for k in r) for r in rows]
    return ("\n".join(lines) + "\n").encode()


def _jsonl(rows) -> bytes:
    return b"".join(json.dumps(r).encode() + b"\n" for r in rows)


PQ_COLS = [ref_pq.Column("id", ref_pq.INT64),
           ref_pq.Column("name", ref_pq.BYTE_ARRAY,
                         converted=ref_pq.CT_UTF8),
           ref_pq.Column("amount", ref_pq.DOUBLE),
           ref_pq.Column("rank", ref_pq.INT32, repetition=ref_pq.OPTIONAL)]
PQ_ROWS = [{"id": r["id"], "name": r["name"], "amount": r["amount"],
            "rank": None if r["id"] % 7 == 0 else r["id"] % 11}
           for r in ROWS[:200]]

CSV_USE = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
INPUTS = {
    "csv": (_csv(ROWS), CSV_USE),
    "csv-noheader": (_csv(ROWS, header=False),
                     "<CSV><FileHeaderInfo>NONE</FileHeaderInfo></CSV>"),
    "csv-ignore": (_csv(ROWS),
                   "<CSV><FileHeaderInfo>IGNORE</FileHeaderInfo></CSV>"),
    "csv-semicolon": (_csv(ROWS, delim=";"),
                      "<CSV><FileHeaderInfo>USE</FileHeaderInfo>"
                      "<FieldDelimiter>;</FieldDelimiter></CSV>"),
    "jsonl": (_jsonl(ROWS), "<JSON><Type>LINES</Type></JSON>"),
    "jsondoc": (json.dumps(ROWS[:300]).encode(),
                "<JSON><Type>DOCUMENT</Type></JSON>"),
    "parquet": (ref_pq.write_parquet(PQ_COLS, PQ_ROWS), "<Parquet/>"),
    "parquet-snappy": (ref_pq.write_parquet(PQ_COLS, PQ_ROWS,
                                            codec=ref_pq.CODEC_SNAPPY),
                       "<Parquet/>"),
    "gzip": (gzip.compress(_csv(ROWS), mtime=0),
             "<CompressionType>GZIP</CompressionType>" + CSV_USE),
    "bzip2": (bz2.compress(_csv(ROWS)),
              "<CompressionType>BZIP2</CompressionType>" + CSV_USE),
}
QUERIES = {
    "star": "SELECT * FROM S3Object",
    "where": "SELECT s.name, s.amount FROM S3Object s "
             "WHERE CAST(s.amount AS FLOAT) > 900",
    "aggregate": "SELECT COUNT(*), SUM(CAST(s.amount AS FLOAT)), "
                 "MIN(CAST(s.id AS INT)), MAX(s.name) FROM S3Object s",
    "limit": "SELECT s.id FROM S3Object s LIMIT 7",
    "cast-like": "SELECT UPPER(s.name), CAST(s.id AS INT) * 2 FROM "
                 "S3Object s WHERE s.name LIKE 'user1%' AND "
                 "CAST(s.id AS INT) BETWEEN 10 AND 150",
    "positional": "SELECT s._2, s._1 FROM S3Object s WHERE s._4 = 'lima'",
}
ERRORS = {
    "malformed": "SELEC name FROM S3Object",
    "unknown-function": "SELECT FROBNICATE(s.name) FROM S3Object s",
    "bad-table": "SELECT * FROM Table1",
}


def _answer(mod, payload: bytes, data: bytes):
    """The framed answer, or the error code the scan refused with."""
    try:
        return mod.run_select(payload, data)
    except mod.SelectError as e:
        return ("error", e.code)


@pytest.mark.parametrize("output", ["<CSV/>", "<JSON/>"])
@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("source", sorted(INPUTS))
def test_answers_equal_the_references(source, query, output):
    data, input_xml = INPUTS[source]
    payload = _req(QUERIES[query], input_xml, output)
    got = _answer(port_sel, payload, data)
    assert got == _answer(ref_sel, payload, data)


@pytest.mark.parametrize("query", sorted(ERRORS))
@pytest.mark.parametrize("source", ["csv", "jsonl", "parquet"])
def test_refusals_equal_the_references(source, query):
    data, input_xml = INPUTS[source]
    payload = _req(ERRORS[query], input_xml)
    with pytest.raises(port_sel.SelectError) as got:
        port_sel.run_select(payload, data)
    with pytest.raises(ref_sel.SelectError) as want:
        ref_sel.run_select(payload, data)
    assert got.value.code == want.value.code


@pytest.mark.parametrize("payload", [
    b"<not xml", b"<SelectObjectContentRequest/>",
    _req("SELECT * FROM S3Object", "<CompressionType>LZMA</CompressionType>"
         "<CSV/>"),
    _req("SELECT * FROM S3Object", "<Avro/>"),
    _req("SELECT * FROM S3Object", "<CompressionType>GZIP</CompressionType>"
         "<Parquet/>"),
], ids=["not-xml", "empty", "lzma", "avro", "gzip-parquet"])
def test_malformed_requests_are_refused_alike(payload):
    data = INPUTS["csv"][0]
    assert _answer(port_sel, payload, data) == \
        _answer(ref_sel, payload, data)


def test_corrupt_inputs_are_refused_alike():
    for data, input_xml in (
            (gzip.compress(_csv(ROWS))[:-9],
             "<CompressionType>GZIP</CompressionType>" + CSV_USE),
            (b"garbage", "<CompressionType>BZIP2</CompressionType><CSV/>"),
            (b'{"a": 1}\n{"a": \n', "<JSON><Type>LINES</Type></JSON>"),
            (b"PAR1 not parquet PAR1", "<Parquet/>")):
        payload = _req("SELECT * FROM S3Object", input_xml)
        assert _answer(port_sel, payload, data) == \
            _answer(ref_sel, payload, data)


def test_progress_frames_equal_the_references(monkeypatch):
    data = _csv(ROWS * 8)
    payload = _req(QUERIES["where"], CSV_USE, progress=True)
    for mod in (port_sel, ref_sel):
        monkeypatch.setattr(mod, "PROGRESS_INTERVAL", 16 * 1024)
    got = b"".join(port_sel.run_select_stream(
        payload, iter([data[i:i + 5000] for i in range(0, len(data), 5000)]),
        block_bytes=8192))
    want = b"".join(ref_sel.run_select_stream(
        payload, iter([data[i:i + 5000] for i in range(0, len(data), 5000)]),
        block_bytes=8192))
    assert got == want
    types = [t for t, _ in port_sel.message.parse_events(got)]
    assert types.count("Progress") >= 2 and types[-2:] == ["Stats", "End"]


@pytest.mark.parametrize("block", [64, 4096, 65536])
@pytest.mark.parametrize("chunk", [17, 1000, 1 << 20])
@pytest.mark.parametrize("source", ["csv", "jsonl", "gzip", "bzip2"])
def test_streamed_scan_equals_the_buffered_one(source, chunk, block):
    data, input_xml = INPUTS[source]
    payload = _req(QUERIES["where"], input_xml)
    want = port_sel.run_select(payload, data)
    got = b"".join(port_sel.run_select_stream(
        payload, iter([data[i:i + chunk]
                       for i in range(0, len(data), chunk)]),
        block_bytes=block))
    assert got == want


# -- the servers ----------------------------------------------------------

MASTER = "select-test-key:" + base64.b64encode(bytes(range(32))).decode()
BIG = _csv(_rows(40_000, seed=3))          # ~1.1 MB
FLUSH = 64 * 1024                          # the chunked route past this


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_COMPRESSION_ENABLE", "on")
    mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
    for mod in (ref_ho, port_ho):
        mp.setattr(mod, "SELECT_FLUSH_BYTES", FLUSH)
    root = tmp_path_factory.mktemp("select")
    try:
        with servers(root, mp) as (ref, port):
            # the SSE keys and nonces from each package's pinned stream
            mp.setattr(os, "urandom", Draws(19))
            p = Pair(ref, port, root)
            p.same("PUT", "/sel", status=200)
            data = INPUTS["csv"][0]
            p.same("PUT", "/sel/plain.dat", body=data, status=200)
            p.same("PUT", "/sel/sse.dat", body=data, status=200,
                   headers={"x-amz-server-side-encryption": "AES256"})
            p.same("PUT", "/sel/packed.csv", body=data, status=200)
            p.same("PUT", "/sel/big.csv", body=BIG, status=200)
            p.same("PUT", "/sel/big.dat", body=BIG, status=200)
            yield p
    finally:
        mp.undo()


def _select(pair, key, query, input_xml=CSV_USE, output="<CSV/>"):
    return pair.same("POST", f"/sel/{key}", "select&select-type=2",
                     _req(query, input_xml, output))


@pytest.mark.parametrize("query", ["where", "aggregate", "limit"])
@pytest.mark.parametrize("key", ["plain.dat", "sse.dat", "packed.csv"])
def test_servers_answer_a_select_alike(pair, key, query):
    """A plain, an SSE-S3 and a compressed object: the answer is the
    scan of the plain bytes."""
    got = _select(pair, key, QUERIES[query])
    assert got.status == 200
    assert got.headers.get("Content-Length") == str(len(got.body))
    data, input_xml = INPUTS["csv"]
    assert got.body == port_sel.run_select(
        _req(QUERIES[query], input_xml), data)


def _select_counts(registry) -> dict:
    return {name: v for (name, _), v in registry.GLOBAL._counters.items()
            if name.startswith("mt_select_")}


def test_select_counters_equal_the_references(pair):
    """``mt_select_*``: a request, and the bytes scanned, processed and
    returned, counted as the reference counts them."""
    before = [_select_counts(m) for m in (ref_metrics, port_metrics)]
    got = _select(pair, "packed.csv", QUERIES["where"])
    after = [_select_counts(m) for m in (ref_metrics, port_metrics)]
    deltas = [{k: v - b.get(k, 0) for k, v in a.items()}
              for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]
    assert deltas[1]["mt_select_requests_total"] == 1
    assert deltas[1]["mt_select_scanned_bytes_total"] == \
        len(INPUTS["csv"][0])
    assert 0 < deltas[1]["mt_select_returned_bytes_total"] < len(got.body)


@pytest.mark.parametrize("key", ["big.csv", "big.dat"])
def test_a_long_answer_streams_chunked_alike(pair, key):
    got = _select(pair, key, "SELECT * FROM S3Object s", output="<JSON/>")
    assert got.status == 200 and len(got.body) > FLUSH
    assert got.headers.get("Transfer-Encoding") == "chunked"
    assert got.body == port_sel.run_select(
        _req("SELECT * FROM S3Object s", CSV_USE, "<JSON/>"), BIG)


def test_refusals_over_http_alike(pair):
    for payload in (b"<bad", _req("SELEC x", CSV_USE),
                    _req("SELECT * FROM S3Object", "<Avro/>")):
        got = pair.same("POST", "/sel/plain.dat", "select&select-type=2",
                        payload)
        assert got.status == 400
    pair.same("POST", "/sel/nosuch.csv", "select&select-type=2",
              _req("SELECT * FROM S3Object", CSV_USE), status=404)
    # select without its type is no S3 call
    pair.same("POST", "/sel/plain.dat", "select",
              _req("SELECT * FROM S3Object", CSV_USE), status=405)


def test_a_select_under_memory_pressure_answers_503(pair):
    """The scan's charge is refused before any data is read."""
    for gov in (ref_memgov.GOVERNOR, port_memgov.GOVERNOR):
        gov.configure(1 << 20)
    try:
        got = pair.same("POST", "/sel/plain.dat", "select&select-type=2",
                        _req("SELECT * FROM S3Object", CSV_USE),
                        status=503, err="SlowDown")
        assert got.headers.get("Retry-After")
    finally:
        for gov in (ref_memgov.GOVERNOR, port_memgov.GOVERNOR):
            gov.configure(0)
    assert port_memgov.GOVERNOR.inuse_bytes("select") == 0
    assert _select(pair, "plain.dat", QUERIES["limit"]).status == 200

"""The port's request plane against ``minio_tpu``'s, on both packages'
servers (``_torch_control.servers``): the ``api`` knobs derive the same
limits, live; a full request pool sheds with the same 503 and
Retry-After while the health, metrics and admin paths answer, and a live
``requests_max`` swaps the pool under a request in flight; the memory
governor sheds a PUT (``commit``) and a CompleteMultipartUpload
(``multipart``) alike and leaves no object; a stalled body answers 408
on the buffered route and on the streamed one, where the read-ahead
thread reads it, with no pooled buffer left out and nothing staged.  In
the layer, the commit charge is released after a failed commit and
after a client that hangs up mid-body.  ``stop()`` lets an in-flight GET
finish, as the reference's does."""

import socket
import threading
import time

import pytest

from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.utils import memgov as ref_mg
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.utils import bufpool
from minio_tpu_torch.utils import memgov as port_mg

from ._torch_control import AK, BATCH, PER, SETS, SK, THRESHOLD, client, \
    servers
from ._torch_versions import body

API_DEFAULTS = {"requests_max": "0", "requests_queue": "0",
                "requests_deadline": "10s", "body_deadline": "2m",
                "body_min_rate": "1048576", "mem_limit": "0",
                "mem_retry_after": "1s", "read_header_timeout": "30s",
                "shutdown_drain_s": "5s", "select_block_bytes": "1048576",
                "cors_allow_origin": "*"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("limits")
    try:
        with servers(root, mp) as (ref, port):
            for srv in (ref, port):
                client(srv).make_bucket("lim")
            yield ref, port, root
            for srv in (ref, port):
                set_api(srv, API_DEFAULTS)
    finally:
        mp.undo()


def admin(srv) -> AdminClient:
    return AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)


def set_api(srv, values: dict) -> None:
    adm = admin(srv)
    for k, v in values.items():
        adm.set_config_kv("api", k, v)


def _limits(srv, mg) -> tuple:
    return (srv._req_max, srv.requests_queue_max, srv.requests_deadline_s,
            srv.read_header_timeout_s, srv.body_deadline_s,
            srv.body_min_rate_bps, srv.shutdown_drain_s,
            [srv.body_budget_s(n) for n in (0, 1, 10 << 20)],
            mg.GOVERNOR.limit_bytes, mg.GOVERNOR.retry_after_s,
            srv.select_block_bytes)


@pytest.mark.parametrize("values", [
    {},
    {"requests_max": "3", "requests_queue": "5", "requests_deadline": "2s",
     "body_deadline": "30s", "body_min_rate": "0", "mem_limit": "64MiB",
     "mem_retry_after": "4s", "read_header_timeout": "7s",
     "shutdown_drain_s": "0", "select_block_bytes": "1000"},
    {"requests_max": "x", "requests_queue": "y", "body_min_rate": "z",
     "mem_limit": "bad", "select_block_bytes": "x"},
], ids=["defaults", "set", "bad"])
def test_the_api_knobs_derive_the_same_limits(pair, values):
    ref, port, _ = pair
    try:
        for srv in (ref, port):
            set_api(srv, values)
        assert _limits(port, port_mg) == _limits(ref, ref_mg)
        assert admin(port).get_config_kv("api") == \
            {k: v for k, v in admin(ref).get_config_kv("api").items()
             if k in API_DEFAULTS}
    finally:
        for srv in (ref, port):
            set_api(srv, API_DEFAULTS)


def test_a_zero_header_timeout_means_none(pair):
    """``read_header_timeout 0`` leaves the socket blocking: a body that
    arrives after its headers is read, and a stalled one still meets its
    deadline.  (The reference's zero socket timeout makes the socket
    non-blocking: it drops such a request unanswered, Queue 3 item
    26.)"""
    _, port, _ = pair
    try:
        set_api(port, {"read_header_timeout": "0", "body_deadline": "1s",
                       "body_min_rate": "0"})
        data = body(50_000, 9)
        s = stalled_put(port, "zero", data, 100)
        time.sleep(0.3)
        s.sendall(data[100:])
        assert read_answer(s).startswith(b"HTTP/1.1 200")
        assert client(port).get_object("lim", "zero").body == data
        s = stalled_put(port, "zero-slow", data, 1000)
        assert read_answer(s).startswith(b"HTTP/1.1 408")
    finally:
        set_api(port, API_DEFAULTS)


def stalled_put(srv, key: str, data: bytes, sent: int,
                query: str = "") -> socket.socket:
    """A signed PUT of ``data`` that sends only its first ``sent``
    bytes (the rest with ``sock.sendall(data[sent:])``)."""
    target = f"/lim/{key}" + (f"?{query}" if query else "")
    url = f"http://127.0.0.1:{srv.port}{target}"
    hdrs = sigv4.sign_request(sigv4.Credentials(AK, SK), "PUT", url,
                              {"Connection": "close"}, data, "us-east-1")
    head = f"PUT {target} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs.items()) + \
        f"Content-Length: {len(data)}\r\n\r\n"
    s = socket.create_connection(("127.0.0.1", srv.port))
    s.sendall(head.encode() + data[:sent])
    return s


def read_answer(s: socket.socket, timeout: float = 10.0) -> bytes:
    s.settimeout(timeout)
    out = b""
    try:
        while True:
            x = s.recv(65536)
            if not x:
                break
            out += x
    except (ConnectionError, socket.timeout):
        pass
    s.close()
    return out


def test_a_full_pool_sheds_alike_and_the_control_paths_answer(pair):
    ref, port, _ = pair
    out = []
    for srv in (ref, port):
        set_api(srv, {"requests_max": "1", "requests_queue": "1",
                      "requests_deadline": "1s"})
        held_body = body(10_000, 4)
        hold = stalled_put(srv, "held", held_body, 100)
        time.sleep(0.3)
        res = []

        def one(i, srv=srv, res=res):
            r = client(srv).request("PUT", f"/lim/q{i}", body=b"y" * 500,
                                    expect=())
            res.append((r.status, r.headers.get("Retry-After"),
                        r.xml().findtext("Code")))
        ts = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        c = client(srv)
        ctl = [c.request("GET", "/minio/health/live", sign=False,
                         expect=()).status,
               c.request("GET", "/minio-tpu/metrics", sign=False,
                         expect=()).status,
               c.request("GET", "/minio-tpu/admin/v1/config/api",
                         expect=()).status]
        for t in ts:
            t.join(30)
        # a live requests_max swaps the pool under the held request,
        # which then finishes and releases the pool it took
        set_api(srv, {"requests_max": "4"})
        hold.sendall(held_body[100:])
        held = read_answer(hold).split(b"\r\n")[0]
        after = client(srv).request("PUT", "/lim/after", body=b"z",
                                    expect=()).status
        set_api(srv, API_DEFAULTS)
        out.append((sorted(res), ctl, held, after))
    assert out[0] == out[1]
    shed, ctl, held, after = out[1]
    assert shed == [(503, "1", "SlowDown")] * 3
    assert ctl == [200, 200, 200]
    assert held == b"HTTP/1.1 200 OK" and after == 200


def _shed_count(reg, kind):
    return reg.snapshot().get(("mt_mem_shed_total", (("kind", kind),)), 0)


def test_the_governor_sheds_a_put_alike(pair):
    ref, port, root = pair
    data = body(300_000, 1)
    out = []
    for srv, reg, mg in ((ref, ref_metrics.GLOBAL, ref_mg),
                         (port, port_metrics.GLOBAL, port_mg)):
        before = _shed_count(reg, "commit")
        set_api(srv, {"mem_limit": "200000", "mem_retry_after": "3s"})
        c = client(srv)
        r = c.request("PUT", "/lim/big", body=data, expect=())
        rows = [(r.status, r.headers.get("Retry-After"),
                 r.xml().findtext("Code")),
                c.head_object("lim", "big", expect=()).status,
                _shed_count(reg, "commit") - before,
                mg.GOVERNOR.transient_bytes()]
        set_api(srv, {"mem_limit": "0", "mem_retry_after": "1s"})
        rows.append(c.put_object("lim", "big", data).status)
        out.append(rows)
    assert out[0] == out[1] == [(503, "3", "SlowDown"), 404, 1, 0, 200]


def test_the_governor_charges_the_largest_part_alike(pair):
    ref, port, _ = pair
    out = []
    for srv, mg in ((ref, ref_mg), (port, port_mg)):
        c = client(srv)
        uid = c.create_multipart_upload("lim", "mp")
        parts = [(i + 1, c.upload_part("lim", "mp", uid, i + 1,
                                       body(n, i), chunked=False))
                 for i, n in enumerate((70_000, 120_000, 30_000))]
        set_api(srv, {"mem_limit": "100000"})
        r = c.complete_multipart_upload("lim", "mp", uid, parts) \
            if False else c.request(
                "POST", "/lim/mp", f"uploadId={uid}", (
                    "<CompleteMultipartUpload>" + "".join(
                        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\""
                        "</ETag></Part>" for n, e in parts)
                    + "</CompleteMultipartUpload>").encode(), expect=())
        rows = [(r.status, r.headers.get("Retry-After"),
                 r.xml().findtext("Code")),
                len(c.list_parts("lim", "mp", uid)),
                mg.GOVERNOR.stats()["shed"].get("multipart", 0) > 0]
        set_api(srv, {"mem_limit": "130000"})
        rows.append(c.complete_multipart_upload("lim", "mp", uid,
                                                parts).status)
        rows.append(mg.GOVERNOR.transient_bytes())
        set_api(srv, {"mem_limit": "0"})
        out.append(rows)
    assert out[0] == out[1] == [(503, "1", "SlowDown"), 3, True, 200, 0]


@pytest.mark.parametrize("route", ["buffered", "streamed", "part"])
def test_a_stalled_body_answers_408_alike(pair, route):
    """Streamed (a PUT or an UploadPart): the first batch is read on the
    request's thread, the rest by the read-ahead thread, which meets the
    deadline; no object, no part and no staging file are left."""
    ref, port, root = pair
    cl = 50_000 if route == "buffered" else THRESHOLD + 2 * BATCH
    sent = 20_000 if route == "buffered" else BATCH + 100_000
    key = f"slow-{route}"
    out = []
    for srv in (ref, port):
        c = client(srv)
        query = ""
        if route == "part":
            uid = c.create_multipart_upload("lim", key)
            query = f"partNumber=1&uploadId={uid}"
        set_api(srv, {"body_deadline": "1s", "body_min_rate": "0"})
        t0 = time.monotonic()
        s = stalled_put(srv, key, body(cl, 5), sent, query)
        answer = read_answer(s)
        took = time.monotonic() - t0
        set_api(srv, {"body_deadline": "2m", "body_min_rate": "1048576"})
        code = answer.split(b"<Code>")[1].split(b"</Code>")[0] \
            if b"<Code>" in answer else b""
        left = c.list_parts("lim", key, uid) if route == "part" else \
            c.head_object("lim", key, expect=()).status
        out.append((answer.split(b"\r\n")[0], code, 0.9 < took < 5, left))
    assert out[0] == out[1] == [
        (b"HTTP/1.1 408 Request Timeout", b"RequestTimeout", True,
         [] if route == "part" else 404)][0]
    deadline = time.monotonic() + 10
    while bufpool.GLOBAL.checked_out and time.monotonic() < deadline:
        time.sleep(0.05)
    assert bufpool.GLOBAL.checked_out == 0
    for i in range(SETS * PER):
        assert list((root / "port" / f"d{i}" / ".mt.sys" / "tmp").iterdir()) \
            == []


def test_a_commit_charge_is_released_however_the_put_ends(tmp_path,
                                                           monkeypatch):
    """On the writer plane: a committed PUT, a commit every drive
    refuses, and a body whose client hangs up all leave nothing charged;
    the first two were charged their framed bytes."""
    from minio_tpu_torch.objectlayer.interface import WriteQuorumError
    from minio_tpu_torch.storage import errors as serrors

    from ._torch_versions import close, port_layer
    gov = port_mg.MemoryGovernor()
    monkeypatch.setattr(port_mg, "GOVERNOR", gov)
    er = port_layer(tmp_path)
    try:
        er.make_bucket("lim")
        data = body(300_000, 2)
        er.put_object("lim", "ok", data)
        framed = gov.stats()["peak_bytes"]
        assert framed > len(data) and gov.transient_bytes() == 0

        def refuse(*a, **kw):
            raise serrors.FaultyDisk("drive refuses")
        for d in er.disks:
            monkeypatch.setattr(d, "write_packed", refuse)
        with pytest.raises(WriteQuorumError):
            er.put_object("lim", "failed", data)
        assert gov.transient_bytes() == 0
        assert gov.stats()["peak_bytes"] == framed

        class HangsUp:
            def __init__(self):
                self.sent = 0

            def read(self, n):
                if self.sent:
                    raise ConnectionResetError("client went away")
                self.sent = n
                return data[:n]
        monkeypatch.setattr(port_mg.GOVERNOR, "limit_bytes", 0)
        with pytest.raises(ConnectionResetError):
            er.put_object("lim", "gone", HangsUp())
        assert gov.transient_bytes() == 0
        assert bufpool.GLOBAL.checked_out == 0
    finally:
        close(er)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stop_drains_an_in_flight_get(tmp_path, monkeypatch, pkg):
    data = body(6 << 20, 3)
    with servers(tmp_path, monkeypatch) as (ref, port):
        srv = ref if pkg == "ref" else port
        client(srv).make_bucket("lim")
        client(srv).put_object("lim", "big", data)
        url = f"http://127.0.0.1:{srv.port}/lim/big"
        hdrs = sigv4.sign_request(sigv4.Credentials(AK, SK), "GET", url, {},
                                  b"", "us-east-1")
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 65536)
        s.sendall(("GET /lim/big HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode())
        first = s.recv(65536)
        idle = socket.create_connection(("127.0.0.1", srv.port))
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        time.sleep(0.5)
        assert stopper.is_alive()           # draining the GET
        assert idle.recv(1) == b""          # the idle one is cut at once
        rest = read_answer(s, 30)
        stopper.join(30)
        assert not stopper.is_alive()
        answer = first + rest
        assert answer.startswith(b"HTTP/1.1 200 OK")
        assert answer.endswith(data[-1000:])
        assert len(answer.split(b"\r\n\r\n", 1)[1]) == len(data)

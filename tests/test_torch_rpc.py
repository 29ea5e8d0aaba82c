"""The port's internode RPC plane (``parallel/rpc.py`` and its msgpack
codec) against ``minio_tpu``'s: tokens under a pinned clock, the codec on
generated RPC documents, the framed stream's bytes both ways, the
circuit breaker and the adaptive deadline driven through the same
seeded sequences, and calls across the two packages' clients and
servers."""

import io
import struct

import msgpack
import numpy as np
import pytest

from minio_tpu.parallel import rpc as ref_rpc
from minio_tpu_torch.parallel import rpc as port_rpc
from minio_tpu_torch.storage import msgpack_codec

from ._torch_cluster import Clients, cluster_state_left, free_ports, served

T0 = 1_760_000_000.0


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


@pytest.fixture
def clients():
    c = Clients()
    yield c
    c.close()


# -- tokens ----------------------------------------------------------------

@pytest.mark.parametrize("age,tamper", [
    (0, ""), (1, ""), (-30, ""), (899, ""), (900, ""), (901, ""),
    (-901, ""), (5, "mac"), (5, "ts"), (5, "path"), (5, "secret"),
    (0, "nodot"), (0, "garbage")])
def test_tokens_mint_and_check_alike(age, tamper):
    path, secret = "/rpc/storage/read_all", "s3cret"
    tok = port_rpc.mint_token(secret, path, now=T0)
    assert tok == ref_rpc.mint_token(secret, path, now=T0)
    check_path, check_secret = path, secret
    if tamper == "mac":
        tok = tok[:-1] + ("0" if tok[-1] != "0" else "1")
    elif tamper == "ts":
        ts, mac = tok.split(".")
        tok = f"{int(ts) + 1}.{mac}"
    elif tamper == "path":
        check_path = "/rpc/storage/write_all"
    elif tamper == "secret":
        check_secret = "other"
    elif tamper == "nodot":
        tok = tok.replace(".", "")
    elif tamper == "garbage":
        tok = "x.y"
    got = [m.check_token(check_secret, check_path, tok, now=T0 + age)
           for m in (port_rpc, ref_rpc)]
    assert got[0] == got[1]
    assert got[0] == (tamper == "" and abs(age) <= port_rpc.TOKEN_WINDOW_S)


# -- msgpack ---------------------------------------------------------------

def _doc(rng, depth: int = 0):
    kind = rng.integers(0, 11 if depth < 3 else 7)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:      # every int width, both signs
        bits = int(rng.choice([4, 7, 8, 15, 16, 31, 32, 63]))
        v = int(rng.integers(0, 2 ** min(bits, 62)))
        return -v if rng.integers(0, 2) and bits < 63 else v
    if kind == 3:
        return float(rng.standard_normal() * 10 ** int(rng.integers(-5, 9)))
    if kind == 4:
        n = int(rng.choice([0, 5, 31, 32, 255, 256, 70000]))
        return "".join(chr(0x61 + int(c) % 26) for c in
                       rng.integers(0, 26, n)) + ("é" if n % 2 else "")
    if kind in (5, 6):
        n = int(rng.choice([0, 1, 255, 256, 65536]))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind in (7, 8):
        return [_doc(rng, depth + 1) for _ in range(int(rng.choice(
            [0, 3, 15, 16, 17])))]
    return {f"k{i}": _doc(rng, depth + 1)
            for i in range(int(rng.choice([0, 2, 15, 16, 17])))}


@pytest.mark.parametrize("seed", range(12))
def test_codec_equals_msgpack_on_rpc_documents(seed):
    rng = np.random.default_rng(seed)
    doc = {"ok": bool(seed % 2), "result": _doc(rng),
           "kwargs": {f"a{i}": _doc(rng) for i in range(4)},
           "neg": -int(rng.integers(1, 2 ** 40)), "f": 0.5 - seed}
    want = msgpack.packb(doc, use_bin_type=True)
    assert msgpack_codec.packb(doc) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want, raw=False)
    assert msgpack_codec.unpackb(want) == doc


# -- framing ---------------------------------------------------------------

class _Conn:
    """What a client's ``_send_stream`` writes."""

    def __init__(self):
        self.wire = bytearray()
        self.headers = []

    def putrequest(self, method, path, **kw):
        self.headers.append((method, path))

    def putheader(self, k, v):
        self.headers.append((k, v))

    def endheaders(self):
        pass

    def send(self, b):
        self.wire += bytes(b)


def _send(mod, chunks, trailer):
    body = mod.StreamBody(lambda: iter(chunks), trailer)
    conn = _Conn()
    err = None
    try:
        mod.RPCClient._send_stream(None, conn, "/raw/x", {"A": "1"}, body)
    except Exception as e:  # noqa: BLE001 — the gate's abort
        err = type(e).__name__
    return bytes(conn.wire), conn.headers, body.sent, body.frames, err


def _boom():
    raise ValueError("BadDigest")


@pytest.mark.parametrize("case", ["plain", "trailer", "abort", "empty"])
def test_framed_stream_bytes_and_reading_alike(case):
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (5, 0, 4096, 1)]
    if case == "empty":
        chunks = []
    trailer = {"trailer": lambda: msgpack.packb({"etag": "x"}),
               "abort": _boom}.get(case)
    port, ref = _send(port_rpc, chunks, trailer), _send(ref_rpc, chunks,
                                                       trailer)
    assert port == ref
    wire = port[0]
    for mod in (port_rpc, ref_rpc):
        fr = mod.FrameReader(io.BytesIO(wire), trailer=trailer is not None)
        if case == "abort":
            assert list(fr) == [c for c in chunks if c]
            with pytest.raises(mod.StreamAborted):
                fr.read_trailer()
            assert fr.aborted and fr.in_sync()
            continue
        assert list(fr) == [c for c in chunks if c]
        if trailer is not None:
            assert msgpack.unpackb(fr.read_trailer()) == {"etag": "x"}
        assert fr.in_sync() and fr.frames == len([c for c in chunks if c])


@pytest.mark.parametrize("wire,exc", [
    (struct.pack(">I", 3) + b"ab", "ConnectionError"),
    (struct.pack(">I", port_rpc.MAX_FRAME_BYTES + 1), "ConnectionError"),
    (struct.pack(">I", 2) + b"ab" + struct.pack(">I", 0xFFFFFFFF),
     "StreamAborted")])
def test_bad_streams_are_refused_alike(wire, exc):
    for mod in (port_rpc, ref_rpc):
        fr = mod.FrameReader(io.BytesIO(wire))
        with pytest.raises(Exception) as ei:
            list(fr)
        assert type(ei.value).__name__ == exc


# -- breaker and deadline ----------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(4))
def test_breaker_states_alike_under_a_pinned_clock(seed):
    rng = np.random.default_rng(seed)
    fail_max, cooldown = int(rng.integers(1, 5)), float(rng.uniform(0.5, 4))
    clocks = [Clock(), Clock()]
    bks = [mod.CircuitBreaker(fail_max, cooldown, clock=c, label="p")
           for mod, c in zip((port_rpc, ref_rpc), clocks)]
    opens0 = [port_rpc.BREAKER_OPEN_COUNT, ref_rpc.BREAKER_OPEN_COUNT]
    trace = [[], []]
    for op in rng.integers(0, 5, 300):
        step = float(rng.uniform(0, cooldown))
        for i, b in enumerate(bks):
            if op == 0:
                out = b.allow()
            elif op == 1:
                out = b.record_failure()
            elif op == 2:
                out = b.record_success()
            elif op == 3:
                out = b.ready()
            else:
                clocks[i].t += step
                out = None
            trace[i].append((out, b.state, b.opens))
    assert trace[0] == trace[1]
    assert port_rpc.BREAKER_OPEN_COUNT - opens0[0] == \
        ref_rpc.BREAKER_OPEN_COUNT - opens0[1] == bks[0].opens
    assert {"endpoint": "p", "state": bks[0].state,
            "opens": bks[0].opens} in port_rpc.breaker_states()


@pytest.mark.parametrize("seed", range(3))
def test_dynamic_timeout_alike(seed):
    rng = np.random.default_rng(seed)
    window = int(rng.integers(2, 8))
    dts = [mod.DynamicTimeout(initial=30.0, minimum=1.0, maximum=120.0,
                              window=window) for mod in (port_rpc, ref_rpc)]
    for _ in range(200):
        ok, d = rng.integers(0, 4), float(rng.exponential(0.5))
        for dt in dts:
            dt.log_success(d) if ok else dt.log_failure()
        assert dts[0].timeout() == dts[1].timeout()


def test_each_service_keeps_its_own_deadline_floor():
    c = port_rpc.RPCClient("http://127.0.0.1:1", "s")
    for _ in range(64):
        c._dyn_for("storage").log_success(0.01)
        c._dyn_for("lock").log_success(0.01)
    assert c._dyn_for("storage").timeout() >= 10.0
    assert 1.0 <= c._dyn_for("lock").timeout() < 10.0


# -- calls across the packages ---------------------------------------------

def _echo():
    def boom():
        raise ValueError("nope")
    return {"hi": lambda x: x * 2, "boom": boom,
            "doc": lambda d: {"got": d, "n": -len(d)}}


@pytest.mark.parametrize("cpkg,spkg", [("port", "ref"), ("ref", "port"),
                                       ("port", "port")])
def test_calls_and_errors_cross_the_packages(clients, cpkg, spkg):
    with served(spkg, "s3cret", echo=_echo()) as srv:
        c = clients(cpkg, srv.endpoint, "s3cret")
        assert c.call("echo", "hi", x=21) == 42
        assert c.call("sys", "ping") == "pong"
        doc = {"b": b"\x00\xff", "f": 1.25, "neg": -7, "nested": {"a": [1]}}
        assert c.call("echo", "doc", d=doc) == {"got": doc, "n": -4}
        errs = []
        for cl, method in ((c, "boom"), (c, "missing"),
                           (clients(cpkg, srv.endpoint, "wrong"), "hi")):
            with pytest.raises(Exception) as ei:
                cl.call("echo", method, **({"x": 1} if method == "hi"
                                           else {}))
            errs.append((ei.value.error_type, ei.value.message))
        assert errs == [("ValueError", "nope"),
                        ("NoSuchMethod", "/rpc/echo/missing"),
                        ("AuthError", "bad token")]


def test_pooled_connection_is_reused_and_replayed_after_a_restart(clients):
    port = free_ports(1)[0]
    srv = port_rpc.RPCServer("p00l", port=port)
    srv.register("echo", _echo())
    srv.start()
    try:
        c = clients("port", srv.endpoint, "p00l")
        assert c.call("echo", "hi", x=1) == 2
        conn = c._pool[0]
        for i in range(5):
            assert c.call("echo", "hi", x=i) == 2 * i
        assert c._pool == [conn]
    finally:
        srv.stop()
    srv2 = port_rpc.RPCServer("p00l", port=port)
    srv2.register("echo", _echo())
    srv2.start()
    try:
        # the pooled connection is stale: an idempotent call replays
        assert c.call("echo", "hi", _idempotent=True, x=8) == 16
        assert c.is_online() and c.breaker.state == "closed"
    finally:
        srv2.stop()


def test_a_dead_peer_opens_the_breaker_and_fails_fast(clients):
    with served("port", "k") as srv:
        endpoint = srv.endpoint
    c = clients("port", endpoint, "k")
    with pytest.raises(port_rpc.RPCError) as ei:
        c.call("sys", "ping", _idempotent=True)
    assert ei.value.error_type == "ConnectionError"
    assert c.breaker.state == "open" and not c.is_online()
    with pytest.raises(port_rpc.RPCError) as ei:
        c.call("sys", "ping")
    assert ei.value.error_type == "PeerOffline"

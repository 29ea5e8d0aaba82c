"""The broker wire clients (``minio_tpu/events/wire.py``): each protocol
spoken on a plain socket, with no client library, as the reference's
targets speak it (pkg/event/target/{amqp,kafka,redis,nats,nsq,mqtt,
elasticsearch}.go ride SDKs; the protocols are plain framing):

* ``AMQPWireClient``: AMQP 0-9-1 publisher, the protocol header, PLAIN
  auth (Start/Start-Ok, Tune/Tune-Ok, Open/Open-Ok), a channel, exchange
  declare, Basic.Publish with a content header and body frames split at
  the negotiated frame size;
* ``KafkaWireClient``: Produce v0 with a v0 MessageSet (CRC32-framed);
* ``RedisWireClient``: RESP2 commands, AUTH when a password is set;
* ``NATSWireClient``: INFO/CONNECT (user and password), PUB, and a
  PING/PONG that confirms the publish;
* ``NSQWireClient``: nsqd TCP V2, PUB frames, heartbeats answered;
* ``MQTTWireClient``: 3.1.1 CONNECT/CONNACK, PUBLISH at QoS 0, 1 or 2
  with its acknowledgements, DISCONNECT;
* ``ESWireClient``: Elasticsearch REST over ``http.client`` (HTTPS when
  the URL says so): index create, document index and delete.

A malformed or hostile reply raises ``WireError``, never another
exception, and every length read from the wire is bounded.  One client
is one connection, with Nagle's algorithm off (``connect``); the targets
(``brokers.py``) open one per record, as the reference's do.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
import zlib
from urllib.parse import quote, urlsplit


class WireError(Exception):
    pass


def connect(host: str, port: int, timeout: float) -> socket.socket:
    """A TCP connection with Nagle's algorithm off, as Go leaves every
    connection of MinIO's broker clients.  A client that writes twice
    before it reads (AMQP's method, header and body frames; NATS's PUB
    then PING) otherwise waits out the broker's delayed ACK, ~40 ms each
    time (ROADMAP Queue 3 record 58; the reference leaves it on)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


# -- AMQP 0-9-1 ------------------------------------------------------------

_FRAME_METHOD = 1
_FRAME_HEADER = 2
_FRAME_BODY = 3
_FRAME_END = 0xCE


def _shortstr(s: str) -> bytes:
    b = s.encode()
    if len(b) > 255:
        raise WireError("shortstr too long")
    return bytes([len(b)]) + b


def _longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


class AMQPWireClient:
    """Publisher-only AMQP 0-9-1 connection (one channel)."""

    def __init__(self, host: str, port: int, user: str = "guest",
                 password: str = "guest", vhost: str = "/",
                 timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self._buf = b""
        self._handshake(user, password, vhost)

    # frame IO
    def _send_frame(self, ftype: int, channel: int,
                    payload: bytes) -> None:
        self.sock.sendall(struct.pack(">BHI", ftype, channel,
                                      len(payload))
                          + payload + bytes([_FRAME_END]))

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by broker")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_frame(self) -> tuple[int, int, bytes]:
        ftype, channel, size = struct.unpack(">BHI",
                                             self._recv_exact(7))
        payload = self._recv_exact(size)
        end = self._recv_exact(1)
        if end[0] != _FRAME_END:
            raise WireError("bad frame end")
        return ftype, channel, payload

    def _expect_method(self, class_id: int, method_id: int) -> bytes:
        ftype, _, payload = self._recv_frame()
        if ftype != _FRAME_METHOD:
            raise WireError(f"expected method frame, got type {ftype}")
        cid, mid = struct.unpack(">HH", payload[:4])
        if (cid, mid) != (class_id, method_id):
            raise WireError(
                f"expected method ({class_id},{method_id}), "
                f"got ({cid},{mid})")
        return payload[4:]

    def _send_method(self, channel: int, class_id: int, method_id: int,
                     args: bytes = b"") -> None:
        self._send_frame(_FRAME_METHOD, channel,
                         struct.pack(">HH", class_id, method_id) + args)

    # connection negotiation (amqp091 §2.2.4 connection class)
    def _handshake(self, user: str, password: str, vhost: str) -> None:
        self.sock.sendall(b"AMQP\x00\x00\x09\x01")
        self._expect_method(10, 10)                     # Start
        sasl = f"\x00{user}\x00{password}".encode()
        self._send_method(0, 10, 11,                    # Start-Ok
                          _longstr(b"")                 # client props
                          + _shortstr("PLAIN")
                          + _longstr(sasl)
                          + _shortstr("en_US"))
        tune = self._expect_method(10, 30)              # Tune
        chmax, framemax, _hb = struct.unpack(">HIH", tune[:8])
        self._send_method(0, 10, 31,                    # Tune-Ok
                          struct.pack(">HIH", chmax or 1,
                                      framemax or 131072, 0))
        self.frame_max = framemax or 131072
        self._send_method(0, 10, 40,                    # Open
                          _shortstr(vhost) + _shortstr("") + b"\x00")
        self._expect_method(10, 41)                     # Open-Ok
        self._send_method(1, 20, 10, _shortstr(""))     # Channel Open
        self._expect_method(20, 11)                     # Open-Ok

    def declare_exchange(self, name: str, ex_type: str = "direct",
                         durable: bool = False) -> None:
        if not name:
            return                  # default exchange pre-exists
        bits = 0x02 if durable else 0x00
        self._send_method(1, 40, 10,                    # Declare
                          struct.pack(">H", 0) + _shortstr(name)
                          + _shortstr(ex_type) + bytes([bits])
                          + _longstr(b""))              # args table
        self._expect_method(40, 11)                     # Declare-Ok

    def publish(self, exchange: str, routing_key: str,
                body: bytes, content_type: str = "application/json"
                ) -> None:
        self._send_method(1, 60, 40,                    # Basic.Publish
                          struct.pack(">H", 0) + _shortstr(exchange)
                          + _shortstr(routing_key) + b"\x00")
        # content header: class 60, weight 0, body size, flag bit 15 =
        # content-type property present
        hdr = struct.pack(">HHQH", 60, 0, len(body), 0x8000) \
            + _shortstr(content_type)
        self._send_frame(_FRAME_HEADER, 1, hdr)
        maxbody = self.frame_max - 8
        for off in range(0, len(body), maxbody):
            self._send_frame(_FRAME_BODY, 1, body[off:off + maxbody])

    def close(self) -> None:
        try:
            # Connection.Close (10,50): code, text, class, method
            self._send_method(0, 10, 50,
                              struct.pack(">H", 200) + _shortstr("bye")
                              + struct.pack(">HH", 0, 0))
            self._expect_method(10, 51)                 # Close-Ok
        except Exception:  # noqa: BLE001 — best-effort goodbye
            pass
        finally:
            self.sock.close()


# -- Kafka (Produce v0) ----------------------------------------------------

def _kstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _kbytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _message_v0(key: bytes | None, value: bytes) -> bytes:
    content = b"\x00\x00" + _kbytes(key) + _kbytes(value)  # magic+attrs
    crc = zlib.crc32(content) & 0xFFFFFFFF
    msg = struct.pack(">I", crc) + content
    return struct.pack(">q", 0) + struct.pack(">i", len(msg)) + msg


class KafkaWireClient:
    """Producer-only Kafka client: Produce v0 to partition 0."""

    def __init__(self, host: str, port: int, client_id: str = "minio-tpu",
                 timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self.client_id = client_id
        self._corr = 0

    def _roundtrip(self, api_key: int, api_version: int,
                   body: bytes) -> bytes:
        self._corr += 1
        req = (struct.pack(">hhi", api_key, api_version, self._corr)
               + _kstr(self.client_id) + body)
        self.sock.sendall(struct.pack(">i", len(req)) + req)
        raw = b""
        while len(raw) < 4:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by broker")
            raw += chunk
        size = struct.unpack(">i", raw[:4])[0]
        while len(raw) < 4 + size:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("short response")
            raw += chunk
        payload = raw[4:4 + size]
        corr = struct.unpack(">i", payload[:4])[0]
        if corr != self._corr:
            raise WireError("correlation id mismatch")
        return payload[4:]

    def produce(self, topic: str, key: bytes | None,
                value: bytes, acks: int = 1,
                timeout_ms: int = 5000) -> int:
        msgset = _message_v0(key, value)
        body = (struct.pack(">hi", acks, timeout_ms)
                + struct.pack(">i", 1) + _kstr(topic)
                + struct.pack(">i", 1) + struct.pack(">i", 0)
                + struct.pack(">i", len(msgset)) + msgset)
        resp = self._roundtrip(0, 0, body)
        ntopics = struct.unpack(">i", resp[:4])[0]
        off = 4
        for _ in range(ntopics):
            tlen = struct.unpack(">h", resp[off:off + 2])[0]
            off += 2 + tlen
            nparts = struct.unpack(">i", resp[off:off + 4])[0]
            off += 4
            for _ in range(nparts):
                _pid, err, offset = struct.unpack(
                    ">ihq", resp[off:off + 14])
                off += 14
                if err != 0:
                    raise WireError(f"produce error code {err}")
                return offset
        raise WireError("empty produce response")

    def close(self) -> None:
        self.sock.close()


# -- Redis (RESP2) ----------------------------------------------------------

class RedisWireClient:
    """RESP2 command client (HSET/HDEL/RPUSH — the redis.go surface).

    Requests are arrays of bulk strings; replies are parsed for all
    five RESP types so -ERR surfaces as WireError (RESP2 spec; the
    reference rides go-redis, pkg/event/target/redis.go:1).
    """

    def __init__(self, host: str, port: int, password: str = "",
                 timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self._buf = b""
        if password:
            self.command("AUTH", password)

    def _recv_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by redis")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by redis")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    _MAX_BULK = 64 << 20       # fuzz contract: bounded, WireError only
    _MAX_ARRAY = 1 << 20
    _MAX_DEPTH = 32

    def _read_reply(self, depth: int = 0):
        if depth > self._MAX_DEPTH:
            raise WireError("RESP nesting too deep")
        line = self._recv_line()
        t, rest = line[:1], line[1:]
        try:
            if t == b"+":
                return rest.decode(errors="replace")
            if t == b"-":
                raise WireError(
                    f"redis error: {rest.decode(errors='replace')}")
            if t == b":":
                return int(rest)
            if t == b"$":
                n = int(rest)
                if n < 0:
                    return None
                if n > self._MAX_BULK:
                    raise WireError(f"bulk string too large: {n}")
                data = self._recv_exact(n)
                self._recv_exact(2)                 # trailing \r\n
                return data
            if t == b"*":
                n = int(rest)
                if n < 0:
                    return None
                if n > self._MAX_ARRAY:
                    raise WireError(f"array too large: {n}")
                return [self._read_reply(depth + 1) for _ in range(n)]
        except ValueError as e:    # malformed int field from the wire
            raise WireError(f"malformed RESP reply: {e}") from e
        raise WireError(f"bad RESP type byte {t!r}")

    def command(self, *args):
        parts = [f"*{len(args)}\r\n".encode()]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            parts.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
        self.sock.sendall(b"".join(parts))
        return self._read_reply()

    def close(self) -> None:
        try:
            self.sock.sendall(b"*1\r\n$4\r\nQUIT\r\n")
        except OSError:
            pass
        self.sock.close()


# -- NATS (text protocol) ---------------------------------------------------

class NATSWireClient:
    """Publisher-only NATS core client: INFO/CONNECT handshake, PUB,
    and a PING/PONG flush so delivery is confirmed before returning
    (NATS client protocol docs; reference rides nats.go,
    pkg/event/target/nats.go:1)."""

    def __init__(self, host: str, port: int, user: str = "",
                 password: str = "", timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self._buf = b""
        info = self._recv_line()
        if not info.startswith(b"INFO "):
            raise WireError(f"expected INFO, got {info[:40]!r}")
        opts = {"verbose": False, "pedantic": False,
                "name": "minio-tpu", "lang": "python", "version": "1",
                "protocol": 0}
        if user:
            opts["user"] = user
            opts["pass"] = password
        self.sock.sendall(b"CONNECT " + json.dumps(opts).encode()
                          + b"\r\n")
        self._flush()

    def _recv_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by nats")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by nats")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _flush(self) -> None:
        self.sock.sendall(b"PING\r\n")
        while True:
            line = self._recv_line()
            if line == b"PONG":
                return
            if line.startswith(b"-ERR"):
                raise WireError(
                    f"nats: {line.decode(errors='replace')}")
            if line.startswith(b"PING"):
                self.sock.sendall(b"PONG\r\n")
            # +OK / INFO updates are skipped

    def publish(self, subject: str, payload: bytes) -> None:
        self.sock.sendall(f"PUB {subject} {len(payload)}\r\n".encode()
                          + payload + b"\r\n")
        self._flush()                               # confirms acceptance

    def close(self) -> None:
        self.sock.close()


# -- NSQ (TCP V2) -----------------------------------------------------------

_NSQ_FRAME_RESPONSE = 0
_NSQ_FRAME_ERROR = 1


class NSQWireClient:
    """Producer-only nsqd client: '  V2' magic then PUB frames
    (nsq.io TCP protocol spec; reference rides go-nsq,
    pkg/event/target/nsq.go:1)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self._buf = b""
        self.sock.sendall(b"  V2")

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by nsqd")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_frame(self) -> tuple[int, bytes]:
        size = struct.unpack(">i", self._recv_exact(4))[0]
        if not 4 <= size <= 16 << 20:    # frame = type + data; sane cap
            raise WireError(f"bad nsqd frame size {size}")
        data = self._recv_exact(size)
        ftype = struct.unpack(">i", data[:4])[0]
        return ftype, data[4:]

    def publish(self, topic: str, body: bytes) -> None:
        self.sock.sendall(f"PUB {topic}\n".encode()
                          + struct.pack(">I", len(body)) + body)
        while True:
            ftype, data = self._read_frame()
            if ftype == _NSQ_FRAME_ERROR:
                raise WireError(
                    f"nsqd error: {data.decode(errors='replace')}")
            if ftype == _NSQ_FRAME_RESPONSE:
                if data == b"_heartbeat_":
                    self.sock.sendall(b"NOP\n")
                    continue
                if data != b"OK":
                    raise WireError(f"unexpected nsqd response {data!r}")
                return

    def close(self) -> None:
        try:
            self.sock.sendall(b"CLS\n")
        except OSError:
            pass
        self.sock.close()


# -- MQTT 3.1.1 -------------------------------------------------------------

def _mqtt_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        d, n = n & 0x7F, n >> 7
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MQTTWireClient:
    """Publisher-only MQTT 3.1.1 client: CONNECT/CONNACK, PUBLISH at
    QoS 0-2 with the full acknowledgement ladder, DISCONNECT
    (MQTT 3.1.1 OASIS spec §3; reference rides paho,
    pkg/event/target/mqtt.go:1)."""

    def __init__(self, host: str, port: int, client_id: str = "minio-tpu",
                 user: str = "", password: str = "",
                 timeout: float = 5.0):
        self.sock = connect(host, port, timeout)
        self._buf = b""
        self._pid = 0
        flags = 0x02                                # clean session
        payload = _mqtt_str(client_id)
        if user:
            flags |= 0x80
            payload += _mqtt_str(user)
            if password:
                flags |= 0x40
                payload += _mqtt_str(password)
        var = (_mqtt_str("MQTT") + bytes([0x04, flags])
               + struct.pack(">H", 30))             # keepalive 30s
        self._send_packet(0x10, var + payload)
        ptype, body = self._read_packet()
        if ptype != 0x20 or len(body) != 2:
            raise WireError("expected CONNACK")
        if body[1] != 0:
            raise WireError(f"MQTT connect refused: code {body[1]}")

    def _send_packet(self, hdr: int, body: bytes) -> None:
        self.sock.sendall(bytes([hdr]) + _mqtt_varint(len(body)) + body)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise WireError("connection closed by mqtt broker")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_packet(self) -> tuple[int, bytes]:
        hdr = self._recv_exact(1)[0]
        mult, length = 1, 0
        while True:
            d = self._recv_exact(1)[0]
            length += (d & 0x7F) * mult
            if not d & 0x80:
                break
            mult *= 128
            if mult > 128 ** 3:
                raise WireError("malformed remaining length")
        return hdr & 0xF0, self._recv_exact(length)

    def publish(self, topic: str, payload: bytes, qos: int = 0) -> None:
        var = _mqtt_str(topic)
        if qos:
            self._pid = (self._pid % 0xFFFF) + 1
            var += struct.pack(">H", self._pid)
        self._send_packet(0x30 | (qos << 1), var + payload)
        if qos == 1:
            ptype, body = self._read_packet()
            if ptype != 0x40 or struct.unpack(">H", body[:2])[0] != \
                    self._pid:
                raise WireError("expected PUBACK")
        elif qos == 2:
            ptype, body = self._read_packet()
            if ptype != 0x50 or struct.unpack(">H", body[:2])[0] != \
                    self._pid:
                raise WireError("expected PUBREC")
            self._send_packet(0x62, struct.pack(">H", self._pid))
            ptype, body = self._read_packet()
            if ptype != 0x70:
                raise WireError("expected PUBCOMP")

    def close(self) -> None:
        try:
            self._send_packet(0xE0, b"")
        except OSError:
            pass
        self.sock.close()


# -- Elasticsearch (plain HTTP) ---------------------------------------------

class ESWireClient:
    """Minimal Elasticsearch document client over plain HTTP — index
    create, doc index (explicit or auto id), doc delete.  The reference
    rides the official client, but the API is just REST
    (pkg/event/target/elasticsearch.go:1)."""

    def __init__(self, url: str, timeout: float = 5.0):
        u = urlsplit(url)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if u.scheme == "https" else 9200)
        self._cls = http.client.HTTPSConnection \
            if u.scheme == "https" else http.client.HTTPConnection
        self.timeout = timeout

    def _request(self, method: str, path: str, body: bytes = b"",
                 ok=(200, 201)) -> tuple[int, bytes]:
        conn = self._cls(self._host, self._port, timeout=self.timeout)
        try:
            hdrs = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body or None, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            if ok and resp.status not in ok:
                raise WireError(
                    f"elasticsearch {method} {path}: {resp.status} "
                    f"{data[:200]!r}")
            return resp.status, data
        except OSError as e:
            raise WireError(f"elasticsearch unreachable: {e}") from e
        finally:
            conn.close()

    def ensure_index(self, index: str) -> None:
        status, _ = self._request("HEAD", f"/{index}", ok=())
        if status == 200:
            return
        status, data = self._request("PUT", f"/{index}", b"{}", ok=())
        if status not in (200, 201) and b"already_exists" not in data:
            raise WireError(f"create index {index}: {status}")

    def index_doc(self, index: str, doc_id, body: bytes) -> None:
        if doc_id is None:
            self._request("POST", f"/{index}/_doc", body)
        else:
            self._request("PUT", f"/{index}/_doc/{quote(doc_id, safe='')}",
                          body)

    def delete_doc(self, index: str, doc_id: str) -> None:
        status, _ = self._request(
            "DELETE", f"/{index}/_doc/{quote(doc_id, safe='')}", ok=())
        if status not in (200, 404):
            raise WireError(f"delete {doc_id}: {status}")

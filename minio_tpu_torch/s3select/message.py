"""AWS event-stream framing for SelectObjectContent responses
(``minio_tpu/s3select/message.py``).

pkg/s3select/message.go (newRecordsMessage, newStatsMessage,
newEndMessage and the prelude/CRC layout).  Wire format per message:

    4B total length (BE) | 4B headers length (BE) | 4B CRC32(prelude)
    headers | payload | 4B CRC32(everything before)

Header encoding: 1B name length, name, 1B value type (7 = string),
2B value length (BE), value.
"""

from __future__ import annotations

import struct
import zlib


def _header(name: str, value: str) -> bytes:
    nb, vb = name.encode(), value.encode()
    return bytes([len(nb)]) + nb + b"\x07" + struct.pack(">H", len(vb)) + vb


def _message(headers: list[tuple[str, str]], payload: bytes) -> bytes:
    hdr = b"".join(_header(n, v) for n, v in headers)
    total = 12 + len(hdr) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))


def records_event(payload: bytes) -> bytes:
    return _message([
        (":message-type", "event"),
        (":event-type", "Records"),
        (":content-type", "application/octet-stream"),
    ], payload)


def continuation_event() -> bytes:
    return _message([
        (":message-type", "event"),
        (":event-type", "Cont"),
    ], b"")


def progress_event(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f"<Progress><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Progress>")
    return _message([
        (":message-type", "event"),
        (":event-type", "Progress"),
        (":content-type", "text/xml"),
    ], xml.encode())


def stats_event(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f"<Stats><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Stats>")
    return _message([
        (":message-type", "event"),
        (":event-type", "Stats"),
        (":content-type", "text/xml"),
    ], xml.encode())


def end_event() -> bytes:
    return _message([
        (":message-type", "event"),
        (":event-type", "End"),
    ], b"")


def error_message(code: str, description: str) -> bytes:
    return _message([
        (":message-type", "error"),
        (":error-code", code),
        (":error-message", description),
    ], b"")


def parse_events(stream: bytes) -> list[tuple[str, bytes]]:
    """Decode a framed stream into [(event_type, payload)] — used by the
    client/tests (mint's response parsing analog).  Validates CRCs."""
    out = []
    i = 0
    while i < len(stream):
        if i + 12 > len(stream):
            raise ValueError("truncated prelude")
        total, hlen = struct.unpack(">II", stream[i:i + 8])
        crc = struct.unpack(">I", stream[i + 8:i + 12])[0]
        if zlib.crc32(stream[i:i + 8]) != crc:
            raise ValueError("prelude CRC mismatch")
        if i + total > len(stream):
            raise ValueError("truncated message")
        msg = stream[i:i + total]
        if zlib.crc32(msg[:-4]) != struct.unpack(">I", msg[-4:])[0]:
            raise ValueError("message CRC mismatch")
        headers = {}
        j = 12
        while j < 12 + hlen:
            nl = msg[j]
            name = msg[j + 1:j + 1 + nl].decode()
            j += 1 + nl
            vtype = msg[j]
            j += 1
            if vtype != 7:
                raise ValueError(f"unsupported header type {vtype}")
            vl = struct.unpack(">H", msg[j:j + 2])[0]
            headers[name] = msg[j + 2:j + 2 + vl].decode()
            j += 2 + vl
        payload = msg[12 + hlen:-4]
        out.append((headers.get(":event-type",
                                headers.get(":error-code", "?")), payload))
        i += total
    return out

"""Host cost of the S3 front's streaming-PUT body reader, without a socket.

    python3 scripts/s3_decode_cost.py [--mib 256] [--batch-mib 60]

Frames a seeded body as an aws-chunked upload (64 KiB chunks, every
chunk signed), then reads it back through each front's reader stack from
memory, in reads of one stream batch as the object layer's PUT takes
them: ``minio_tpu``'s (chunk headers read a byte at a time, Content-MD5
hashed by a second reader) and ``minio_tpu_torch``'s (one C readline per
header, one join per read; Content-MD5 left to the object layer's own
MD5).  Prints seconds per reader and, for scale, one MD5 and one
SHA-256 of the body.  A host measurement: it says nothing of the card.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import io
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from minio_tpu.s3 import server as ref_server  # noqa: E402
from minio_tpu.s3 import sigv4 as ref_sigv4  # noqa: E402
from minio_tpu_torch.s3 import server as port_server  # noqa: E402
from minio_tpu_torch.s3 import sigv4 as port_sigv4  # noqa: E402


def read_all(reader, batch: int) -> int:
    total = 0
    while True:
        c = reader.read(batch)
        if not c:
            return total
        total += len(c)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--batch-mib", type=int, default=60)
    args = ap.parse_args()
    body = np.random.default_rng(8).integers(
        0, 256, args.mib << 20, dtype=np.uint8).tobytes()
    batch = args.batch_mib << 20
    now = datetime.datetime.now(datetime.timezone.utc)
    creds = port_sigv4.Credentials("key", "secret")
    hdrs, framed = port_sigv4.sign_request_streaming(
        creds, "PUT", "http://127.0.0.1:9000/b/k", {}, body, 64 * 1024,
        timestamp=now)
    _, key, seed, amz_date, scope = port_sigv4.verify_request_streaming(
        lambda ak: "secret", "PUT", "/b/k", {}, hdrs, now=now)
    md5 = hashlib.md5(body).digest()

    def ref_reader():
        raw = io.BufferedReader(io.BytesIO(framed))
        chunked = ref_sigv4.ChunkedStreamReader(
            ref_server._BodyReader(raw, len(framed)), key, seed, amz_date,
            scope)
        return ref_server._MD5Reader(chunked, md5)

    def port_reader():
        raw = io.BufferedReader(io.BytesIO(framed))
        return port_sigv4.ChunkedStreamReader(
            port_server._BodyReader(raw, len(framed)), key, seed, amz_date,
            scope)

    print(f"host: {platform.node()} {platform.processor() or ''} "
          f"{os.cpu_count()} CPUs, python {platform.python_version()}; "
          f"{args.mib} MiB body, {len(framed)} framed bytes, reads of "
          f"{args.batch_mib} MiB")
    for label, make in (("minio_tpu reader + Content-MD5", ref_reader),
                        ("minio_tpu_torch reader", port_reader)):
        t0 = time.perf_counter()
        n = read_all(make(), batch)
        assert n == len(body)
        print(f"{label}: {time.perf_counter() - t0:.3f} s")
    for name in ("md5", "sha256"):
        t0 = time.perf_counter()
        hashlib.new(name, body).digest()
        print(f"{name} of the body: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

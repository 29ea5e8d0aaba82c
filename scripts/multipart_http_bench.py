"""Where a multipart upload's time goes over HTTP: the same 512 MiB upload
(32 parts of 16 MiB, minio-go's part size) to the port's server on one
card, its client in three arrangements, in turns:

  * ``threads``: 4 client threads in the server's process (as
    ``chip_smoke.py`` sends it);
  * ``procs``: 4 client processes, each sending every fourth part;
  * ``serial``: 1 client thread, one part at a time.

For each run it prints the wall seconds and the server's stage seconds
per part, means over the parts (``ErasureObjects.part_stats``: waiting on
the body, MD5, encode + frame, waiting on the drive writes, the
promote), with the card's name and power limit.

    python3 scripts/multipart_http_bench.py [--repeat 2]

Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PART, PARTS, WORKERS = 16 << 20, 32, 4
KEY, SECRET = "bench-key", "bench-secret"


def _send_parts(endpoint: str, path: str, upload_id: str, part: int,
                numbers: list[int]) -> list[tuple[int, str, float]]:
    """A client process's share: the parts ``numbers`` (of ``part``
    bytes) of the body in the file ``path``; returns (part, ETag,
    seconds) each."""
    from minio_tpu_torch.s3.client import S3Client
    client = S3Client(endpoint, KEY, SECRET)
    out = []
    with open(path, "rb") as f:
        for n in numbers:
            f.seek((n - 1) * part)
            data = f.read(part)
            t0 = time.perf_counter()
            etag = client.upload_part("bench", "mp", upload_id, n, data)
            out.append((n, etag, time.perf_counter() - t0))
    return out


def run_once(mode: str, srv, client, body: bytes, path: str, pool) -> dict:
    er = srv.layer.get_hashed_set("mp")
    er.part_stats.clear()
    t0 = time.perf_counter()
    if mode == "procs":
        uid = client.create_multipart_upload("bench", "mp")
        shares = [list(range(w + 1, PARTS + 1, WORKERS))
                  for w in range(WORKERS)]
        results = pool.starmap(_send_parts, [
            (srv.endpoint, path, uid, PART, s) for s in shares])
        sent = sorted(r for share in results for r in share)
        parts = [(n, e) for n, e, _ in sent]
        part_s = [t for _, _, t in sent]
    else:
        uid, parts, part_s = client.upload_parts(
            "bench", "mp", body, PART, WORKERS if mode == "threads" else 1)
    upload_s = time.perf_counter() - t0
    client.complete_multipart_upload("bench", "mp", uid, parts)
    stats = list(er.part_stats)
    if len(stats) != PARTS:
        raise RuntimeError(f"{len(stats)} part readings, expected {PARTS}")
    return {"mode": mode, "upload_s": upload_s,
            "gib_s": len(body) / upload_s / 2**30,
            "part_p50_s": float(np.median(part_s)),
            "server_part_mean_s": {
                k: float(np.mean([st[k] for st in stats]))
                for k in stats[0] if k != "bytes"}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    card = card_name_and_power_limit()
    _build.build()
    root = tempfile.mkdtemp(prefix="mp-bench-")
    body = np.random.default_rng(9).integers(
        0, 256, PART * PARTS, dtype=np.uint8).tobytes()
    path = os.path.join(root, "body")
    with open(path, "wb") as f:
        f.write(body)
    srv = build_server([f"{root}/d{i}" for i in range(16)], "127.0.0.1:0",
                       KEY, SECRET, 10 * 1024 * 1024, device="cuda")
    srv.start()
    ctx = multiprocessing.get_context("spawn")
    runs = []
    try:
        client = S3Client(srv.endpoint, KEY, SECRET)
        client.make_bucket("bench")
        with ctx.Pool(WORKERS) as pool:
            order = ["threads", "procs", "serial"]
            for r in range(args.repeat):
                for mode in (order if r % 2 == 0 else order[::-1]):
                    out = run_once(mode, srv, client, body, path, pool)
                    got = client.get_object("bench", "mp").body
                    if got != body:
                        raise RuntimeError(f"{mode}: the body differs")
                    runs.append(out)
                    print(json.dumps(out), flush=True)
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where an SSE-S3 GET spends its time, beside a plain GET, on the card.

    python3 scripts/sse_get_split.py [--repeat 3]

Builds the 32-drive server of ``chip_smoke.py``'s phases 9 and 14 (two
sets of 12 + 4, 10 MiB blocks) on the card, PUTs one 16 MiB body plain
and once SSE-S3 over HTTP, then times, each ``--repeat`` times: the two
PUTs and GETs over HTTP, the object layer's read of each stored object
(no HTTP), opening the SSE object's key, and DARE over the whole 16 MiB
in memory.  Prints the card's name and power limit and one JSON line of
seconds.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from minio_tpu_torch.crypto import sse as csse  # noqa: E402
from minio_tpu_torch.device import card_name_and_power_limit  # noqa: E402
from minio_tpu_torch.ops import _build  # noqa: E402
from minio_tpu_torch.s3.client import S3Client  # noqa: E402
from minio_tpu_torch.server_main import build_server  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.environ["MT_CRAWL_INTERVAL_S"] = str(24 * 3600)
    card = card_name_and_power_limit()
    _build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    root = tempfile.mkdtemp(prefix="sse-split-")
    srv = build_server([f"{root}/d{i}" for i in range(32)], "127.0.0.1:0",
                       cs.S3_KEY, cs.S3_SECRET, cs.BLOCK, device="cuda")
    srv.start()
    out: dict = {}

    def timed(name, fn):
        ts = []
        for _ in range(args.repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = ts

    try:
        c = S3Client(srv.endpoint, cs.S3_KEY, cs.S3_SECRET)
        c.make_bucket("split")
        body = cs.rand_bytes((cs.SSE_OBJ,), gen).cpu().numpy().tobytes()
        lay = srv.layer
        timed("put_plain", lambda: c.put_object("split", "plain", body))
        timed("put_sse", lambda: c.put_object("split", "sse", body,
                                              headers=cs.SSE_S3))
        timed("get_plain", lambda: c.get_object("split", "plain"))
        timed("get_sse", lambda: c.get_object("split", "sse"))
        for key in ("plain", "sse"):
            timed(f"layer_read_{key}", lambda k=key: b"".join(
                lay.get_object_reader("split", k)[1]))
        meta = lay.get_object_info("split", "sse").user_defined
        stored = b"".join(lay.get_object_reader("split", "sse")[1])
        timed("open_key", lambda: csse.ObjectEncryption.open(
            meta, "split", "sse", {}, srv.kms))
        enc = csse.ObjectEncryption.open(meta, "split", "sse", {}, srv.kms)
        check = enc.decrypt(stored) == body
        timed("dare_decrypt_16mib", lambda: enc.decrypt(stored))
        timed("dare_encrypt_16mib", lambda: enc.encrypt(body))
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    if not check:
        print("SSE object did not decrypt to its body", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

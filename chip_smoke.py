"""Drive minio_tpu_torch on one CUDA card, phase by phase, and check it.

    python3 chip_smoke.py

1. Device: the card's name and power limit; build both kernels (one nvcc
   per source, started together) and print the build time.
2. Kernel A (csrc/gf8_apply.cu) against its plain version on the card, at
   the path's shape (6 stripes of 12 x 873,814 bytes, encode rows and the
   decode rows of 4 lost data shards) and at ragged shapes; exact.
3. Kernel B (csrc/hh256.cu) against its plain version on the card, at the
   path's shape (96 rows x 873,814 bytes) and at ragged lengths, and both
   against the published HighwayHash test vectors; exact.
4. The path: a 16-drive erasure set (12 data + 4 parity, 10 MiB blocks)
   under a temporary directory.  PUT seeded objects (0 B to 256 MiB), GET
   each whole and as a range, wipe the drives holding four data shards of
   the 256 MiB object, GET it degraded, heal it, and check the healed part
   files byte for byte.  Launch counts are reset before the path and read
   after each of PUT, GET and heal: both kernels must have run in each,
   and no plain version anywhere in the path.
5. One JSON line describing each kernel, the card line, and the result
   line.

Any mismatch raises, and the script exits nonzero without the result
line; it also exits nonzero when torch sees no card.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
K, M = 12, 4
BLOCK = 10 * 1024 * 1024
N_PATH = -(-BLOCK // K)            # 873,814: shard width at 10 MiB blocks
B_PATH = 6                         # stripes per 64 MiB stream batch


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rand_bytes(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def phase_kernel_a(gen) -> dict:
    from minio_tpu_torch.ops import gf8, rs_kernels
    enc = gf8.rs_matrix(K, K + M)[K:]
    present = list(range(M, K + M))                  # data 0..3 lost
    dec = rs_kernels.decode_rows(gf8.rs_matrix(K, K + M), K, present,
                                 list(range(M)))
    data = rand_bytes((B_PATH, K, N_PATH), gen)
    for name, rows in (("encode", enc), ("decode", dec)):
        got = rs_kernels.apply_matrix(rows, data)
        want = rs_kernels.gf_apply_ref(rows, data)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kernel A {name} at path shape")
    ragged = 0
    for k, m in ((K, M), (4, 2)):
        mat = gf8.rs_matrix(k, k + m)[k:]
        for n in (1, 31, 300, 4097):
            for b in (1, 64):
                x = rand_bytes((b, k, n), gen)
                check(torch.equal(rs_kernels.apply_matrix(mat, x),
                                  rs_kernels.gf_apply_ref(mat, x)),
                      f"kernel A at B={b} k={k} m={m} n={n}")
                ragged += 1
    ms = cuda_ms(lambda: rs_kernels.apply_matrix(enc, data), 20)
    plain_ms = cuda_ms(lambda: rs_kernels.gf_apply_ref(enc, data), 3)
    nbytes = (K + M) * N_PATH * B_PATH
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel A: exact at the path shape (encode, decode) and {ragged} "
          f"ragged shapes; B={B_PATH} k={K} r={M} n={N_PATH}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} bytes)")
    return {"name": "gf8_apply", "route": "cuda",
            "source": "minio_tpu_torch/csrc/gf8_apply.cu",
            "replaces": "minio_tpu/ops/rs_pallas.py:95",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": [B_PATH, K, M, N_PATH]}


HH_TEST_KEY = bytes(range(32))          # 0x0706050403020100 ... LE words
HH64_VECTORS = {0: 0x907A56DE22C26E53, 1: 0x7EAB43AAC7CDDD78,
                2: 0xB8D0569AB0B53D62}
HH256_VECTOR_0 = (0xDD44482AC2C874F5, 0xD946017313C7351F,
                  0xB3AEBECCB98714FF, 0x41DA233145751DF4)


def phase_kernel_b(gen) -> dict:
    from minio_tpu_torch.ops import hh
    for n, want in HH64_VECTORS.items():
        row = torch.arange(n, dtype=torch.uint8, device="cuda").reshape(1, n)
        for fn in (hh.hh64_batch, lambda b, k: hh.hh256_batch_ref(b, k, 8)):
            got = fn(row, HH_TEST_KEY).cpu().numpy().tobytes()
            check(int.from_bytes(got, "little") == want,
                  f"HighwayHash64 vector n={n}")
    empty = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")
    for fn in (hh.hh256_batch, hh.hh256_batch_ref):
        got = fn(empty, HH_TEST_KEY).cpu().numpy().tobytes()
        check(tuple(np.frombuffer(got, "<u8")) == HH256_VECTOR_0,
              "HighwayHash256 vector n=0")
    lengths = (0, 1, 31, 32, 33, 2047, 2048, 2049, 64 * 32 + 5)
    for n in lengths:
        x = rand_bytes((300, n), gen)
        check(torch.equal(hh.hh256_batch(x), hh.hh256_batch_ref(x)),
              f"kernel B at 300 rows x {n}")
    rows = B_PATH * (K + M)                             # 96 rows per batch
    x = rand_bytes((rows, N_PATH), gen)
    got = hh.hh256_batch(x)
    plain = []                     # one run: the chain takes ~30 s here
    plain_ms = cuda_ms(lambda: plain.append(hh.hh256_batch_ref(x)), 1)
    check(torch.equal(got, plain[0]), f"kernel B at {rows} rows x {N_PATH}")
    ms = cuda_ms(lambda: hh.hh256_batch(x), 5)
    nbytes = rows * N_PATH + rows * 32
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    packets = N_PATH // 32
    print(f"kernel B: published vectors and {len(lengths)} ragged lengths x "
          f"300 rows exact; {rows} rows x {N_PATH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms (one run), bound {bound_ms:.4f} ms "
          f"(bytes); chain of {packets} packets per row: "
          f"{ms * 1e6 / packets:.1f} ns per packet")
    return {"name": "hh256", "route": "cuda",
            "source": "minio_tpu_torch/csrc/hh256.cu",
            "replaces": "minio_tpu/ops/hh_pallas.py:163",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": [rows, N_PATH], "chain_packets": packets}


def phase_encode_layout(gen) -> None:
    """The path's strided encode layout against the same encode on the
    CPU (plain version), for a body one byte past a block."""
    from minio_tpu_torch.ops.codec import Erasure
    body = rand_bytes((BLOCK + 1,), gen)
    got = Erasure(K, M, BLOCK, device="cuda").encode_object(body)
    want = Erasure(K, M, BLOCK, device="cpu").encode_object(body.cpu())
    check(torch.equal(got.cpu(), want), "encode_object cuda vs cpu")


def snapshot():
    from minio_tpu_torch.ops import hh, rs_kernels
    return {"gf8_apply": (rs_kernels.COUNTS.launches, rs_kernels.COUNTS.plain),
            "hh256": (hh.COUNTS.launches, hh.COUNTS.plain)}


def delta(a, b):
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in a}


def phase_path(gen, card: str) -> dict:
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import hh, rs_kernels
    from minio_tpu_torch.storage.xl_storage import XLStorage
    sizes = {"empty": 0, "inline": 100 * 1024, "1MiB": 1 << 20,
             "block+1": BLOCK + 1, "256MiB": 256 << 20}
    bodies = {name: rand_bytes((size,), gen).cpu().numpy().tobytes()
              for name, size in sizes.items()}
    root = tempfile.mkdtemp(prefix="chip-smoke-drives-")
    try:
        drives = []
        for i in range(K + M):
            os.makedirs(f"{root}/d{i}")
            drives.append(XLStorage(f"{root}/d{i}"))
        er = ErasureObjects(drives, parity=M, device="cuda")
        er.make_bucket("smoke")
        rs_kernels.COUNTS.reset()
        hh.COUNTS.reset()
        s0 = snapshot()

        t0 = time.perf_counter()
        for name, body in bodies.items():
            info = er.put_object("smoke", name, body)
            check(info.etag == hashlib.md5(body).hexdigest(), f"etag {name}")
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        s_put = snapshot()

        big = bodies["256MiB"]
        for name, body in bodies.items():
            _, got = er.get_object("smoke", name)
            digest = hashlib.sha256(got).digest()
            check(digest == hashlib.sha256(body).digest(), f"GET {name}")
            if len(body) > 2:
                lo, ln = len(body) // 3, max(1, len(body) // 5)
                _, got = er.get_object("smoke", name, lo, ln)
                check(got == body[lo:lo + ln], f"range GET {name}")
        fi, _ = er._read_quorum_fileinfo("smoke", "256MiB")
        victims = [d for d, shard in enumerate(fi.erasure.distribution)
                   if shard <= M]                       # data shards 1..4
        check(len(victims) == M, "victims")
        part = f"256MiB/{fi.data_dir}/part.1"
        saved = {d: open(f"{root}/d{d}/smoke/{part}", "rb").read()
                 for d in victims}
        for d in victims:
            shutil.rmtree(f"{root}/d{d}/smoke/256MiB")
        a_before = rs_kernels.COUNTS.launches
        t0 = time.perf_counter()
        _, got = er.get_object("smoke", "256MiB")
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        check(got == big, "degraded GET 256MiB")
        check(rs_kernels.COUNTS.launches > a_before,
              "degraded GET launched no Kernel A")
        s_get = snapshot()

        t0 = time.perf_counter()
        res = er.heal_object("smoke", "256MiB")
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        s_heal = snapshot()
        check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
        for d in victims:
            check(open(f"{root}/d{d}/smoke/{part}", "rb").read() == saved[d],
                  f"healed part.1 on drive {d} differs")
        # the healed drives must serve: wipe four others and GET again
        others = [d for d in range(K + M) if d not in victims][:M]
        for d in others:
            shutil.rmtree(f"{root}/d{d}/smoke/256MiB")
        _, got = er.get_object("smoke", "256MiB")
        check(got == big, "GET through healed drives")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    phases = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
              "heal": delta(s_get, s_heal)}
    for phase, counts in phases.items():
        for kernel, (launches, plain) in counts.items():
            check(launches > 0, f"{kernel} not launched during {phase}")
    total = delta(s0, snapshot())
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"{kernel} plain version ran {plain} times")
    put_bytes = sum(len(b) for b in bodies.values())
    print(f"path on {card}: PUT {put_bytes / put_s / 2**30:.3f} GiB/s "
          f"({put_bytes} bytes in {put_s:.3f} s), degraded GET of 256 MiB "
          f"{len(big) / get_s / 2**30:.3f} GiB/s ({get_s:.3f} s), heal of 4 "
          f"shards {heal_s:.3f} s")
    print("launches per phase (kernel, plain): " + json.dumps(phases))
    put_breakdown(er, big)
    er.close()
    return {k: v[0] for k, v in total.items()}


def put_breakdown(er, body: bytes) -> None:
    """Two stages of PUT timed alone on one 60 MiB stream batch: the host
    MD5 and encode + frame (host-to-device copy, Kernels A and B,
    device-to-host copy).  The rest of PUT's wall time is drive I/O and
    Python."""
    batch = body[:er._batch_bytes()]
    er._encode_and_frame(batch)                     # warm
    t0 = time.perf_counter()
    hashlib.md5(batch).hexdigest()
    md5_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    er._encode_and_frame(batch)
    enc_s = time.perf_counter() - t0
    print(f"PUT stages for one {len(batch)}-byte batch: MD5 "
          f"{md5_s * 1e3:.1f} ms, encode + frame incl. copies "
          f"{enc_s * 1e3:.1f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    kernels = [phase_kernel_a(gen), phase_kernel_b(gen)]
    phase_encode_layout(gen)
    launches = phase_path(gen, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

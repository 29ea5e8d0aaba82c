"""Drive minio_tpu_torch on one CUDA card, phase by phase, and check it.

    python3 chip_smoke.py

1. Device: the card's name and power limit; build the three kernels (one
   nvcc per source, started together) and print the build time.
2. Kernel A (csrc/gf8_apply.cu) against its plain version on the card, at
   the path's shape (6 stripes of 12 x 873,814 bytes, encode rows and the
   decode rows of 4 lost data shards), in place on the degraded GET's
   strided rebuild views, at r = 1, 5 and 8 (two passes), at k + r = 256
   and at ragged shapes; exact.  Timed at the path shape beside its plan.
3. Kernel B (csrc/hh256.cu) against its plain version on the card, at the
   path's shape (96 rows x 873,814 bytes) and at ragged lengths, and both
   against the published HighwayHash test vectors; exact.  Timed at 1, 16
   and 96 rows x 873,814 bytes, in ns per packet of a row's chain.
4. Kernel C (csrc/rs_fused.cu) against its plain version on the card, at
   the path's shape (6 stripes, 12 + 4, 873,814 bytes, parity hashed),
   against Kernel A then Kernel B at that shape, at ragged shapes in both
   hash_parity modes (one with two hashing warps), and in place inside a
   frame tensor; exact.  Timed
   with and without the hash (n_real=0).
   Kernels B and C report their bound as the larger of the byte bound and
   the chain bound (one row's packet updates in series), which is the
   chain.
5. The path: a 16-drive erasure set (12 data + 4 parity, 10 MiB blocks)
   under a temporary directory.  PUT seeded objects (0 B to 256 MiB; the
   512 KiB one is packed into the drives' segment files), GET each whole
   and as a range, wipe the drives holding four data shards of the
   256 MiB object, GET it degraded, heal it, and check the healed part
   files byte for byte; then wipe the packed object from four drives,
   heal it into their segments, check each new extent against the one
   the drive held before, and GET it through the healed drives.  Then a
   burst: 8 threads each PUT 32 objects of 512 KiB (packed, group
   commits) and every body reads back; objects/s, GiB/s, group commits
   and fsyncs per object.  Launch counts are reset before the path and
   read after each of PUT, GET, heal, packed heal and burst: Kernels A
   and B must have run in each, and no plain version anywhere in the
   path.  Last, one 60 MiB batch's stages timed alone: MD5, encode +
   frame on the card, the copy into a pinned pooled buffer, and the
   256 MiB PUT's pipeline wall time per batch.
6. The mesh path: the same set built on a one-device mesh (the mesh data
   plane), driven the same way with the same bodies (without the burst).
   Its shards (part files, packed extents, inline data) must equal the
   first set's drive by drive; its PUT must launch Kernel C once per
   full-block batch and once per short last block, and Kernels A and B
   not at all; its degraded GET and heals launch Kernels A and B; no
   plain version runs.
7. The S3 front: ``build_server`` (what ``python -m minio_tpu_torch
   server`` runs) on 16 temporary drives on the card at 127.0.0.1:0, the
   same 12 + 4 set with 10 MiB blocks, driven over HTTP with the port's
   ``S3Client``: make a bucket, PUT the six bodies (the 256 MiB one
   aws-chunked with Content-MD5, so it takes the streaming route; the
   others header-signed with their SHA-256), each ETag against the body's
   MD5, GET each whole and one range, HEAD one, ListObjectsV2 with a
   delimiter, wipe the drives of four data shards of the 256 MiB object
   and GET it degraded byte for byte, DELETE it, then a burst of 8
   client threads x 32 PUTs of 512 KiB, all read back.  Launch counts are
   reset before the phase and read after PUT, GET, degraded GET and the
   burst: Kernels A and B in each but the healthy GETs, which verify
   (Kernel B) and rebuild nothing; no plain version.  One line sets the HTTP
   figures beside phase 5's in-process ones from the same run.
8. Multipart uploads and versioning over HTTP, on a fresh set built by
   ``build_server`` (the same 12 + 4 set, 10 MiB blocks, on the card): a
   512 MiB seeded object as 32 parts of 16 MiB (minio-go's part size)
   from 4 client threads (its worker count), aws-chunked with
   Content-MD5; ListParts, then CompleteMultipartUpload, whose ETag must
   be md5(part MD5s)-32 as the client computes it; a whole GET (MD5) and
   a range across a part and a block boundary; wipe the drives of four
   data shards and GET degraded; heal in the layer, check the healed part
   files byte for byte and GET through the healed drives; a 3-part upload
   aborted, no staging dir left on any drive.  Then a versioned bucket:
   an inline, a part-file and a multipart version of one key and a
   delete marker; each version by id, 405 with ``x-amz-delete-marker``
   on the latest, ListObjectVersions in order, the middle version
   deleted, one drive wiped and ``heal_object(version_id=<oldest>)``.
   Last, in-process on the one-device mesh set, a 3 x 5 MiB + 1 MiB
   upload, whose parts launch Kernel C.  Launches are read per step:
   Kernels A and B in the multipart PUT, degraded GET and heal (B alone
   in the healthy GET), C in the mesh parts; no plain version.
9. The sets path: ``build_server`` on 32 temporary drives, which it
   lays out as MinIO does, 2 sets x 16 (12 + 4 each, 10 MiB blocks, on
   the card), every drive holding format.json (one deployment id, a
   2 x 16 grid) and behind a health proxy.  Over HTTP: ``/minio/health/
   cluster``; 64 objects of 16 MiB from 8 client threads, 12 more to set 0
   alone from 4 threads, then 12 to each set at once from 4 threads each
   (deleted again), the 256 MiB body aws-chunked, a 3-part upload and the
   8 x 32 burst of 512 KiB (packed); every object's xl.meta on the drives
   of the set its name hashes to, each set a quarter of the 16 MiB objects
   at least; every object read back from 8 threads and ListObjectsV2 in
   pages of 25.  Then in each set a drive holding a data shard of the
   set's first 16 MiB object is removed, and a degraded GET of that object
   marks it offline (two launches of Kernel A each, the full and the short
   stripe), four more of set 0 taken away (11 of 16 online:
   503, and 412 under maintenance) and back (200); the two removed drives
   return empty, are formatted with their own identity by
   ``DriveMonitor.poll_once`` and their sets healed: every shard equal to
   its digest from before, each sweep on its own set, no other drive
   written.  Last, a drive of another deployment in place of one of set
   1 stays offline and unwritten.  Launches per step: A and B in PUT,
   burst, degraded GET and heal, B in the GET; no plain version.  It
   reads set 0's D2H wait per batch alone and with set 1 as busy beside
   it (the same threads and PUTs per set; one CUDA stream for every set),
   the peak thread count, and the pooled buffers checked out after the
   phase (0).
10. The control plane, on phase 9's server before it stops: set
   ``pipeline depth`` to 0 and back to 2 with the admin client, one
   16 MiB PUT under each (no writer-plane op at 0, the writer plane at
   2); two 16 MiB versions of a key in a versioned bucket (the key
   chosen to land in the set of the foreign drive, which holds one of its
   data shards), a drive holding another data shard of the key emptied
   of it, ``POST heal/<bucket>`` through the admin client: both
   versions' part files back on that drive byte for byte, Kernels A and
   B launched; both versions read back, each GET rebuilding the foreign
   drive's shard through Kernel A; the heal sweep, then
   ``heal-status`` equal to its stats and ``storageinfo`` (31 drives ok,
   the foreign one offline).  The scrape of ``/minio-tpu/metrics``
   against the one before the phase: ``mt_s3_requests_api_total`` per
   API equal to the requests the phase made, ``mt_tpu_ops_total`` per op
   (4 encodes, the matmuls of the heal and of the GETs, each read from a
   scrape taken between the two) reconciled with Kernel A's launches
   (two per 16 MiB encode, one per matmul) and each op's
   ``mt_tpu_kernel_seconds`` count equal to its op total, the heal
   counters equal to the sweep's stats, the overlap efficiency and every
   drive's writer stats present; the scrape's latency over 32 drives.
   Last, ``service?action=stop`` stops the server.
11. One JSON line of readings, one describing each kernel, the card line,
   and the result line.

Any mismatch raises, and the script exits nonzero without the result
line; it also exits nonzero when torch sees no card.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
# The HighwayHash update's loop-carried dependency chain, from the SASS of
# csrc/rs_fused.cu: v1 += mul0 + packet (IADD3, IADD3.X), the zipper of v1
# into v0 (two dependent PRMTs, then IADD3, IADD3.X), the zipper of v0
# into v1 (two PRMTs, IADD3, IADD3.X): 10 dependent integer instructions
# per packet, each at least 4 cycles on Hopper.
CHAIN_CYCLES_PER_UPDATE = 10 * 4
QUEUE_AHEAD_CYCLES = 40_000_000   # ~20 ms of sleep at the SM clock
K, M = 12, 4
BLOCK = 10 * 1024 * 1024
N_PATH = -(-BLOCK // K)            # 873,814: shard width at 10 MiB blocks
B_PATH = 6                         # stripes per 64 MiB stream batch


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream.  A
    sleep kernel holds the stream while the host queues the calls, so a
    kernel shorter than its Python wrapper is timed back to back, not at
    the host's pace."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rand_bytes(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def bounds(nbytes: int, clock_mhz: float) -> dict:
    """The bound fields of a hashing kernel: bytes moved over the card's
    memory rate, the chain bound, and the larger of the two."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = chain_bound_ms(clock_mhz)
    return {"bound_ms": max(byte_ms, chain_ms),
            "bound_by": "chain" if chain_ms >= byte_ms else "bytes",
            "byte_bound_ms": byte_ms, "chain_bound_ms": chain_ms}


def chain_bound_ms(clock_mhz: float) -> float:
    """The least time one row's HighwayHash-256 at the path's shard width
    can take: its packet, remainder and 10 permute updates in series, each
    the update's dependency chain long, at the card's maximum SM clock."""
    updates = N_PATH // 32 + (1 if N_PATH % 32 else 0) + 10
    ms = updates * CHAIN_CYCLES_PER_UPDATE / (clock_mhz * 1e3)
    print(f"chain bound: {updates} updates per row x "
          f"{CHAIN_CYCLES_PER_UPDATE} cycles at {clock_mhz:.0f} MHz = "
          f"{ms:.4f} ms")
    return ms


def check_apply(rows, x, what: str, out=None) -> None:
    """Kernel A against its plain version on the same inputs, exact; with
    ``out``, in place."""
    from minio_tpu_torch.ops import rs_kernels
    got = rs_kernels.apply_matrix(rows, x, out=out)
    want = rs_kernels.gf_apply_ref(rows, x.contiguous())
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel A {what}")


def phase_kernel_a(gen) -> dict:
    from minio_tpu_torch.ops import gf8, rs_kernels
    enc = gf8.rs_matrix(K, K + M)[K:]
    present = list(range(M, K + M))                  # data 0..3 lost
    dec = rs_kernels.decode_rows(gf8.rs_matrix(K, K + M), K, present,
                                 list(range(M)))
    data = rand_bytes((B_PATH, K, N_PATH), gen)
    for name, rows in (("encode", enc), ("decode", dec)):
        check_apply(rows, data, f"{name} at the path shape")
    # the degraded GET's rebuild: survivors (k, L) and the rebuilt rows
    # (4, L) as (stripes, rows, shard) views, batch stride one shard,
    # written in place inside a larger tensor whose margins must not move
    span = B_PATH * N_PATH
    surv = rand_bytes((K, span), gen)
    buf = rand_bytes((M, span + 32), gen)
    before = buf.clone()

    def view(t):
        return t.unflatten(1, (B_PATH, N_PATH)).transpose(0, 1)
    check_apply(dec, view(surv), "rebuild view at the degraded-GET shape",
                out=view(buf[:, 19:19 + span]))
    check(torch.equal(buf[:, :19], before[:, :19])
          and torch.equal(buf[:, 19 + span:], before[:, 19 + span:]),
          "kernel A wrote outside the rebuild view")
    shapes = 3
    for r in (1, 5, 8):                              # one to two passes
        check_apply(gf8.rs_matrix(K, K + r)[K:],
                    rand_bytes((3, K, 100_003), gen), f"r={r}")
        shapes += 1
    for k in (4, 128, 252):                          # k + r = 256
        check_apply(gf8.rs_matrix(k, 256)[k:], rand_bytes((2, k, 1000), gen),
                    f"k={k} r={256 - k}")
        shapes += 1
    for k, m in ((K, M), (4, 2)):
        mat = gf8.rs_matrix(k, k + m)[k:]
        for n in (1, 15, 16, 17, 31, 300, 4097):
            for b in (1, 64):
                check_apply(mat, rand_bytes((b, k, n), gen),
                            f"B={b} k={k} m={m} n={n}")
                shapes += 1
    ms = cuda_ms(lambda: rs_kernels.apply_matrix(enc, data), 50)
    plain_ms = cuda_ms(lambda: rs_kernels.gf_apply_ref(enc, data), 3)
    nbytes = (K + M) * N_PATH * B_PATH
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    plan = rs_kernels.plan(B_PATH, K, M, N_PATH)
    # what limits it: eight output rows are two passes of the product over
    # the same staged input (twice the product, 1.25 times the bytes), and
    # a device copy of the input shows the memory rate the card gives
    enc8 = gf8.rs_matrix(K, K + 8)[K:]
    ms_r8 = cuda_ms(lambda: rs_kernels.apply_matrix(enc8, data), 50)
    copy = torch.empty_like(data)
    copy_ms = cuda_ms(lambda: copy.copy_(data), 50)
    print(f"kernel A: exact at {shapes} shapes (the path's encode and "
          f"decode, the rebuild view in place, r = 1, 5, 8, k + r = 256, "
          f"ragged); B={B_PATH} k={K} r={M} n={N_PATH}: plan {plan}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} bytes), {bound_ms / ms:.1%} of the bound; r=8 "
          f"{ms_r8:.4f} ms; a device copy of the input {copy_ms:.4f} ms "
          f"({2 * data.numel() / copy_ms / 1e9:.3f} TB/s)")
    return {"name": "gf8_apply", "route": "cuda",
            "source": "minio_tpu_torch/csrc/gf8_apply.cu",
            "replaces": "minio_tpu/ops/rs_pallas.py:95",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "share_of_bound": bound_ms / ms, "plan": plan,
            "ms_r8": ms_r8, "copy_ms": copy_ms,
            "shape": [B_PATH, K, M, N_PATH]}


HH_TEST_KEY = bytes(range(32))          # 0x0706050403020100 ... LE words
HH64_VECTORS = {0: 0x907A56DE22C26E53, 1: 0x7EAB43AAC7CDDD78,
                2: 0xB8D0569AB0B53D62}
HH256_VECTOR_0 = (0xDD44482AC2C874F5, 0xD946017313C7351F,
                  0xB3AEBECCB98714FF, 0x41DA233145751DF4)


def phase_kernel_b(gen, clock_mhz: float, card: str) -> dict:
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
    cuda_ms(lambda: hh.hh256_batch(x), 1)                 # warm
    by_rows = {r: cuda_ms(lambda: hh.hh256_batch(x[:r]), 5)
               for r in (1, K + M, rows)}
    ms = by_rows[rows]
    packets = N_PATH // 32
    b = bounds(rows * N_PATH + rows * 32, clock_mhz)
    times = ", ".join(f"{r} rows {t:.4f} ms ({t * 1e6 / packets:.1f} ns per "
                      "packet)" for r, t in by_rows.items())
    print(f"kernel B: published vectors and {len(lengths)} ragged lengths x "
          f"300 rows exact, and {rows} rows x {N_PATH}; plan "
          f"{hh.plan(rows, N_PATH)}; x {N_PATH}: {times}; plain "
          f"{plain_ms:.1f} ms (one run, {rows} rows); byte bound "
          f"{b['byte_bound_ms']:.4f} ms, chain bound "
          f"{b['chain_bound_ms']:.4f} ms ({packets} packets per row); {card}")
    return {"name": "hh256", "route": "cuda",
            "source": "minio_tpu_torch/csrc/hh256.cu",
            "replaces": "minio_tpu/ops/hh_pallas.py:163",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "shape": [rows, N_PATH],
            "chain_packets": packets,
            "ms_by_rows": {str(r): t for r, t in by_rows.items()},
            "ns_per_packet_by_rows": {str(r): t * 1e6 / packets
                                      for r, t in by_rows.items()}}


def phase_encode_layout(gen) -> None:
    """The path's strided encode layout against the same encode on the
    CPU (plain version), for a body one byte past a block."""
    from minio_tpu_torch.ops.codec import Erasure
    body = rand_bytes((BLOCK + 1,), gen)
    got = Erasure(K, M, BLOCK, device="cuda").encode_object(body)
    want = Erasure(K, M, BLOCK, device="cpu").encode_object(body.cpu())
    check(torch.equal(got.cpu(), want), "encode_object cuda vs cpu")


def phase_kernel_c(gen, clock_mhz: float, card: str) -> dict:
    from minio_tpu_torch.ops import gf8, hh, rs_fused, rs_kernels
    ragged = 0
    # (20, 4): more than 16 hashed rows, a second hashing warp
    for k, m in ((K, M), (4, 2), (5, 1), (3, 2), (20, 4)):
        mat = gf8.rs_matrix(k, k + m)[k:]
        for n in (1, 31, 32, 33, 2047, 2048, 2049, 4097):
            for b in (1, 7):
                x = rand_bytes((b, k, n), gen)
                for hp in (True, False):
                    got = rs_fused.encode_hash_device(mat, x, hash_parity=hp)
                    want = rs_fused.encode_hash_ref(mat, x, hash_parity=hp)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"kernel C at B={b} k={k} m={m} n={n} "
                          f"hash_parity={hp}")
                    ragged += 1
    enc = gf8.rs_matrix(K, K + M)[K:]
    # in place inside a frame tensor: 3 frames of 32-byte digest slots and
    # 5,001-byte payloads on 16 rows; only the parity payloads may change
    ss, nf = 5001, 3
    frames = rand_bytes((K + M, nf * (32 + ss)), gen)
    before = frames.clone()
    view = frames.unflatten(1, (nf, 32 + ss)).transpose(0, 1)
    _, dig = rs_fused.encode_hash_device(enc, view[:, :K, 32:],
                                         out_parity=view[:, K:, 32:])
    par, want = rs_fused.encode_hash_ref(enc, view[:, :K, 32:].contiguous())
    check(torch.equal(view[:, K:, 32:], par) and torch.equal(dig, want),
          "kernel C strided into a frame tensor")
    view[:, K:, 32:] = before.unflatten(1, (nf, 32 + ss)).transpose(
        0, 1)[:, K:, 32:]
    check(torch.equal(frames, before),
          "kernel C wrote outside the parity payloads")

    data = rand_bytes((B_PATH, K, N_PATH), gen)
    got = rs_fused.encode_hash_device(enc, data)
    plain = []                     # one run: the plain chain takes ~30 s
    plain_ms = cuda_ms(lambda: plain.append(rs_fused.encode_hash_ref(enc,
                                                                     data)), 1)
    check(all(torch.equal(g, w) for g, w in zip(got, plain[0])),
          "kernel C at the path shape")
    par_a = rs_kernels.apply_matrix(enc, data)
    dig_b = hh.hh256_batch(torch.cat([data, par_a], dim=1))
    check(torch.equal(got[0], par_a) and torch.equal(got[1], dig_b),
          "kernel C against Kernel A then Kernel B at the path shape")
    ms = cuda_ms(lambda: rs_fused.encode_hash_device(enc, data), 10)
    # the same launch with an empty hashed width: loads, product and
    # stores only, the hashing warp idle
    nohash_ms = cuda_ms(
        lambda: rs_fused.encode_hash_device(enc, data, n_real=0), 10)
    rows = K + M
    nbytes = B_PATH * rows * N_PATH + B_PATH * rows * 32
    b = bounds(nbytes, clock_mhz)
    packets = N_PATH // 32
    print(f"kernel C: exact against its plain version at {ragged} ragged "
          f"shapes, in place in a frame tensor, and at the path shape, and "
          f"against Kernel A then Kernel B there; plan "
          f"{rs_fused.plan(B_PATH, K, M, N_PATH)}; B={B_PATH} k={K} r={M} "
          f"n={N_PATH}: kernel {ms:.4f} ms ({ms * 1e6 / packets:.1f} ns per "
          f"packet), without the hash {nohash_ms:.4f} ms "
          f"({nohash_ms * 1e6 / packets:.1f} ns per packet), plain "
          f"{plain_ms:.1f} ms (one run), byte bound "
          f"{b['byte_bound_ms']:.4f} ms ({nbytes} bytes), chain bound "
          f"{b['chain_bound_ms']:.4f} ms; {card}")
    return {"name": "rs_fused", "route": "cuda",
            "source": "minio_tpu_torch/csrc/rs_fused.cu",
            "replaces": "minio_tpu/ops/rs_fused.py:171",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "nohash_ms": nohash_ms,
            "ns_per_packet": ms * 1e6 / packets,
            "nohash_ns_per_packet": nohash_ms * 1e6 / packets,
            "shape": [B_PATH, K, M, N_PATH], "chain_packets": packets}


KERNELS = ("gf8_apply", "hh256", "rs_fused")


def snapshot():
    from minio_tpu_torch.ops import hh, rs_fused, rs_kernels
    counts = {"gf8_apply": rs_kernels.COUNTS, "hh256": hh.COUNTS,
              "rs_fused": rs_fused.COUNTS}
    return {k: (c.launches, c.plain) for k, c in counts.items()}


def reset_counts():
    from minio_tpu_torch.ops import hh, rs_fused, rs_kernels
    for c in (rs_kernels.COUNTS, hh.COUNTS, rs_fused.COUNTS):
        c.reset()


def delta(a, b):
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in a}


PACKED = "512KiB"                  # in the packed band (128 KiB, 1 MiB)
BURST_THREADS, BURST_EACH, BURST_SIZE = 8, 32, 512 * 1024


def make_bodies(gen) -> dict:
    sizes = {"empty": 0, "inline": 100 * 1024, PACKED: 512 * 1024,
             "1MiB": 1 << 20, "block+1": BLOCK + 1, "256MiB": 256 << 20}
    return {name: rand_bytes((size,), gen).cpu().numpy().tobytes()
            for name, size in sizes.items()}


def shard_bytes(disk, name: str) -> bytes:
    """A drive's framed shard of the object, read through its XLStorage:
    the packed extent, the part file or the inline data."""
    fi = disk.read_version("smoke", name)
    if fi.seg is not None:
        return disk.read_segment(fi.seg["sid"], fi.seg["off"],
                                 fi.seg["len"])
    if fi.inline_data is not None:
        return fi.inline_data
    return disk.read_all("smoke", f"{name}/{fi.data_dir}/part.1")


def shard_digests(er, name: str) -> dict:
    """{drive: (layout, sha256 of its shard)}."""
    out = {}
    for d, disk in enumerate(er.disks):
        fi = disk.read_version("smoke", name)
        layout = ("packed" if fi.seg is not None else
                  "inline" if fi.inline_data is not None else "part")
        out[d] = (layout, hashlib.sha256(shard_bytes(disk, name)).digest())
    return out


def victims_of(er, name: str) -> list[int]:
    """The drives holding data shards 1..4 of the object."""
    fi, _ = er._read_quorum_fileinfo("smoke", name)
    victims = [d for d, shard in enumerate(fi.erasure.distribution)
               if shard <= M]
    check(len(victims) == M, "victims")
    return victims


def wipe(root: str, name: str, drives) -> None:
    for d in drives:
        shutil.rmtree(f"{root}/d{d}/smoke/{name}")


def packed_heal(er, root: str, body: bytes) -> float:
    """Wipe the packed object from the drives of four data shards, heal it
    into their own segments, check each new extent against the one the
    drive held, GET through the healed drives; returns the heal's
    seconds."""
    from minio_tpu_torch.ops import rs_kernels
    victims = victims_of(er, PACKED)
    saved = {d: shard_bytes(er.disks[d], PACKED) for d in victims}
    check(all(er.disks[d].read_version("smoke", PACKED).seg is not None
              for d in range(K + M)), f"{PACKED} is not packed")
    wipe(root, PACKED, victims)
    a_before = rs_kernels.COUNTS.launches
    t0 = time.perf_counter()
    res = er.heal_object("smoke", PACKED)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    check(rs_kernels.COUNTS.launches > a_before,
          "packed heal launched no Kernel A")
    check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
    for d in victims:
        fi = er.disks[d].read_version("smoke", PACKED)
        check(fi.seg is not None and shard_bytes(er.disks[d], PACKED)
              == saved[d], f"healed extent on drive {d} differs")
    wipe(root, PACKED, [d for d in range(K + M) if d not in victims][:M])
    _, got = er.get_object("smoke", PACKED)
    check(got == body, f"GET {PACKED} through healed drives")
    return heal_s


def fsync_ms(root: str, count: int = 50) -> float:
    """Median milliseconds of one 4 KiB write + fsync to a file under
    ``root`` (the drives' disk): what one group-commit round waits on."""
    path = os.path.join(root, "fsync-probe")
    times = []
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for _ in range(count):
            os.write(fd, b"x" * 4096)
            t0 = time.perf_counter()
            os.fsync(fd)
            times.append(time.perf_counter() - t0)
    finally:
        os.close(fd)
        os.remove(path)
    return float(np.median(times)) * 1e3


def new_set(root: str, mesh=None):
    """A fresh 16-drive set (12 data + 4 parity, 10 MiB blocks) on the
    card, its drives under ``root``, with the bucket ``smoke``."""
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.storage.xl_storage import XLStorage
    drives = []
    for i in range(K + M):
        os.makedirs(f"{root}/d{i}")
        drives.append(XLStorage(f"{root}/d{i}"))
    er = ErasureObjects(drives, parity=M, device="cuda", mesh=mesh)
    er.make_bucket("smoke")
    return er


def burst_bodies() -> list:
    """The burst's BURST_THREADS x BURST_EACH seeded bodies."""
    n = BURST_THREADS * BURST_EACH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    blob = rand_bytes((n * BURST_SIZE,), gen).cpu().numpy().tobytes()
    return [blob[i * BURST_SIZE:(i + 1) * BURST_SIZE] for i in range(n)]


def put_burst(er, bodies: list) -> float:
    """PUT ``bodies`` as ``burst/<i>`` from BURST_THREADS threads at once;
    returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def put_many(t):
        for i in range(t, len(bodies), BURST_THREADS):
            er.put_object("smoke", f"burst/{i}", bodies[i])

    with ThreadPoolExecutor(BURST_THREADS) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_many, range(BURST_THREADS)))
        return time.perf_counter() - t0


def read_back(er, bodies: list) -> None:
    for i, body in enumerate(bodies):
        _, got = er.get_object("smoke", f"burst/{i}")
        check(got == body, f"burst object {i} reads back")


def burst(er, root: str, card: str) -> dict:
    """BURST_THREADS threads each PUT BURST_EACH packed objects of
    BURST_SIZE bytes at once; every body must read back."""
    from minio_tpu_torch.storage import commit
    bodies = burst_bodies()
    n = len(bodies)
    commit.COUNTS.reset()
    wall = put_burst(er, bodies)
    c = commit.COUNTS
    out = {"objects": n, "object_bytes": BURST_SIZE, "threads":
           BURST_THREADS, "wall_s": wall, "objects_per_s": n / wall,
           "gib_per_s": n * BURST_SIZE / wall / 2**30,
           "group_commits": c.batches, "grouped": c.grouped,
           "largest_group": c.largest, "ops": c.ops,
           "fsyncs_per_object": c.fsyncs / n,
           "deferred_fsyncs_per_object": c.deferred / n,
           "ops_per_group": c.ops / max(1, c.batches),
           "fsync_4KiB_median_ms": fsync_ms(root)}
    read_back(er, bodies)
    print(f"burst on {card}: {n} objects of {BURST_SIZE} B from "
          f"{BURST_THREADS} threads in {wall:.3f} s: "
          f"{out['objects_per_s']:.1f} objects/s, {out['gib_per_s']:.4f} "
          f"GiB/s; {c.batches} group commits ({c.grouped} of more than one "
          f"op, largest {c.largest}, {out['ops_per_group']:.2f} ops each), "
          f"{out['fsyncs_per_object']:.2f} fsyncs per object (an eager "
          f"commit would issue {out['deferred_fsyncs_per_object']:.2f}); "
          f"every body read back; one 4 KiB write + fsync on the drives' "
          f"disk takes {out['fsync_4KiB_median_ms']:.3f} ms (median)")
    return out


def drive_set(label: str, bodies: dict, card: str, mesh=None,
              with_burst: bool = False):
    """PUT, GET, degraded GET, heal and GET through the healed drives of
    the 256 MiB object, the packed heal, and (``with_burst``) the packed
    burst, on a fresh 16-drive set; returns the launch counts per phase,
    the shard digests after PUT, the readings and the set (still open,
    drives removed)."""
    from minio_tpu_torch.ops import rs_kernels
    root = tempfile.mkdtemp(prefix="chip-smoke-drives-")
    readings = {}
    try:
        er = new_set(root, mesh)
        reset_counts()
        s0 = snapshot()

        t0 = time.perf_counter()
        for name, body in bodies.items():
            t1 = time.perf_counter()
            info = er.put_object("smoke", name, body)
            readings[f"put_{name}_s"] = time.perf_counter() - t1
            check(info.etag == hashlib.md5(body).hexdigest(), f"etag {name}")
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        s_put = snapshot()
        readings["pipeline_256MiB"] = dict(er.pipe_stats)
        shards = {name: shard_digests(er, name) for name in bodies}

        big = bodies["256MiB"]
        for name, body in bodies.items():
            t1 = time.perf_counter()
            _, got = er.get_object("smoke", name)
            readings[f"get_{name}_s"] = time.perf_counter() - t1
            digest = hashlib.sha256(got).digest()
            check(digest == hashlib.sha256(body).digest(), f"GET {name}")
            if len(body) > 2:
                lo, ln = len(body) // 3, max(1, len(body) // 5)
                _, got = er.get_object("smoke", name, lo, ln)
                check(got == body[lo:lo + ln], f"range GET {name}")
        fi, _ = er._read_quorum_fileinfo("smoke", "256MiB")
        victims = victims_of(er, "256MiB")
        part = f"256MiB/{fi.data_dir}/part.1"
        saved = {d: open(f"{root}/d{d}/smoke/{part}", "rb").read()
                 for d in victims}
        wipe(root, "256MiB", victims)
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
        wipe(root, "256MiB",
             [d for d in range(K + M) if d not in victims][:M])
        _, got = er.get_object("smoke", "256MiB")
        check(got == big, "GET through healed drives")
        s_heal_get = snapshot()

        packed_heal_s = packed_heal(er, root, bodies[PACKED])
        s_packed = snapshot()
        phases = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
                  "heal": delta(s_get, s_heal),
                  "packed_heal": delta(s_heal_get, s_packed)}
        if with_burst:
            readings["burst"] = burst(er, root, card)
            phases["burst"] = delta(s_packed, snapshot())
        s_end = snapshot()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    total = delta(s0, s_end)
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"{label}: {kernel} plain version ran {plain} "
              "times")
    put_bytes = sum(len(b) for b in bodies.values())
    readings.update(put_bytes=put_bytes, put_s=put_s, degraded_get_s=get_s,
                    heal_s=heal_s, packed_heal_s=packed_heal_s)
    print(f"{label} on {card}: PUT {put_bytes / put_s / 2**30:.3f} GiB/s "
          f"({put_bytes} bytes in {put_s:.3f} s), degraded GET of 256 MiB "
          f"{len(big) / get_s / 2**30:.3f} GiB/s ({get_s:.3f} s), heal of 4 "
          f"shards {heal_s:.3f} s, heal of 4 packed shards of {PACKED} "
          f"{packed_heal_s:.3f} s")
    print(f"{label} launches per phase (kernel, plain): "
          + json.dumps(phases))
    return phases, total, shards, readings, er


def phase_path(bodies: dict, card: str):
    phases, total, shards, readings, er = drive_set("path", bodies, card,
                                                    with_burst=True)
    for phase, counts in phases.items():
        for kernel in ("gf8_apply", "hh256"):
            check(counts[kernel][0] > 0,
                  f"{kernel} not launched during {phase}")
    check(all(layout == "packed" for layout, _ in shards[PACKED].values()),
          f"{PACKED} not packed on every drive")
    readings["breakdown"] = put_breakdown("path", er, bodies["256MiB"],
                                          readings, card)
    er.close()
    return {k: v[0] for k, v in total.items()}, shards, readings


def fused_launches(bodies: dict, batch: int, stream_bytes: int) -> int:
    """Kernel C launches a mesh PUT of ``bodies`` needs: per encode call
    (the whole body up to ``stream_bytes``, else each stream batch), one
    for its full blocks and one for a short last block."""
    count = 0
    for body in bodies.values():
        step = len(body) if len(body) <= stream_bytes else batch
        for off in range(0, len(body), max(1, step)):
            nfull, tail = divmod(min(step, len(body) - off), BLOCK)
            count += (nfull > 0) + (tail > 0)
    return count


def phase_mesh_path(bodies: dict, card: str, ref_shards: dict):
    from minio_tpu_torch.objectlayer import erasure_object
    from minio_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh([torch.device("cuda", 0)])
    phases, total, shards, readings, er = drive_set("mesh path", bodies,
                                                    card, mesh=mesh)
    for name in bodies:
        check(shards[name] == ref_shards[name],
              f"mesh set shards of {name} differ from the first set's")
    want = fused_launches(bodies, er._batch_bytes(),
                          erasure_object.STREAM_BATCH_BYTES)
    check(phases["put"]["rs_fused"][0] == want,
          f"mesh PUT launched Kernel C {phases['put']['rs_fused'][0]} "
          f"times, expected {want}")
    for kernel in ("gf8_apply", "hh256"):
        check(phases["put"][kernel][0] == 0,
              f"{kernel} launched during the mesh PUT")
        for phase in ("get", "heal", "packed_heal"):
            check(phases[phase][kernel][0] > 0,
                  f"{kernel} not launched during the mesh {phase}")
    print(f"mesh path: shards of {len(ref_shards)} objects (part files, "
          f"packed extents, inline data) equal to the first set's on every "
          f"drive; Kernel C launched {want} times during PUT")
    readings["breakdown"] = put_breakdown("mesh path", er, bodies["256MiB"],
                                          readings, card)
    er.close()
    return {k: v[0] for k, v in total.items()}, readings


def put_breakdown(label: str, er, body: bytes, readings: dict,
                  card: str) -> dict:
    """One 60 MiB stream batch's PUT stages timed alone: the host MD5,
    encode + frame on the card (host-to-device copy and the kernels), the
    device-to-host copy into a pinned pooled buffer; and the 256 MiB
    PUT's pipeline wall time per batch, its MD5 and encode + frame
    stages overlapped with the drive writes."""
    from minio_tpu_torch.utils import bufpool
    batch = body[:er._batch_bytes()]
    for _ in range(2):                               # warm, pool filled
        _, release = er._encode_framed_pooled(batch)
        release()
    t0 = time.perf_counter()
    hashlib.md5(batch).hexdigest()
    md5_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    framed = er._frame(batch)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, release = er._to_host(framed)
    copy_s = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    framed.cpu().numpy()
    pageable_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, release = er._encode_framed_pooled(batch)
    pooled_s = time.perf_counter() - t0
    release()
    pipe = readings["pipeline_256MiB"]
    out = {"batch_bytes": len(batch), "md5_ms": md5_s * 1e3,
           "frame_ms": frame_s * 1e3, "d2h_pinned_ms": copy_s * 1e3,
           "d2h_pageable_ms": pageable_s * 1e3,
           "encode_frame_pooled_ms": pooled_s * 1e3,
           "pipeline_wall_ms_per_batch": pipe["wall_s"] * 1e3
           / pipe["batches"],
           "pipeline_md5_ms_per_batch": pipe["md5_s"] * 1e3
           / pipe["batches"],
           "pipeline_encode_ms_per_batch": pipe["encode_s"] * 1e3
           / pipe["batches"], "pipeline_batches": pipe["batches"],
           "pool_hits": bufpool.GLOBAL.hits}
    print(f"{label} PUT stages for one {len(batch)}-byte batch on {card}: "
          f"MD5 {out['md5_ms']:.1f} ms; encode + frame into a pinned pooled "
          f"buffer {out['encode_frame_pooled_ms']:.1f} ms (on the card incl. "
          f"the host-to-device copy {out['frame_ms']:.1f} ms, device-to-host "
          f"into pinned memory {out['d2h_pinned_ms']:.1f} ms, into fresh "
          f"pageable memory {out['d2h_pageable_ms']:.1f} ms); the 256 MiB "
          f"PUT's pipeline: {pipe['batches']} batches, "
          f"{out['pipeline_wall_ms_per_batch']:.1f} ms wall per batch, MD5 "
          f"{out['pipeline_md5_ms_per_batch']:.1f} ms and encode + frame "
          f"{out['pipeline_encode_ms_per_batch']:.1f} ms per batch beside "
          "the drive writes")
    return out


S3_KEY, S3_SECRET = "smoke-key", "smoke-secret"


def http_burst(endpoint: str, bodies: list) -> float:
    """PUT ``bodies`` as ``burst/<i>`` over HTTP from BURST_THREADS
    client threads at once; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def put_many(t):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for i in range(t, len(bodies), BURST_THREADS):
            r = client.put_object("smoke", f"burst/{i}", bodies[i])
            etag = hashlib.md5(bodies[i]).hexdigest()
            check(r.headers["ETag"] == f'"{etag}"', f"HTTP burst ETag {i}")

    with ThreadPoolExecutor(BURST_THREADS) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_many, range(BURST_THREADS)))
        return time.perf_counter() - t0


def phase_s3(bodies: dict, card: str, inproc: dict):
    """The S3 front over HTTP on a fresh 16-drive set; returns the launch
    counts and the readings."""
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    root = tempfile.mkdtemp(prefix="chip-smoke-s3-")
    srv = build_server([f"{root}/d{i}" for i in range(K + M)],
                       "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                       device="cuda")
    er, = srv.layer.sets
    check((er.data_blocks, er.parity, er.device.type) == (K, M, "cuda"),
          f"the server's set is {er.data_blocks} + {er.parity} on "
          f"{er.device}")
    srv.start()
    readings = {}
    try:
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        client.make_bucket("smoke")
        reset_counts()
        s0 = snapshot()
        for name, body in bodies.items():
            url = f"{srv.endpoint}/smoke/{name}"
            creds = sigv4.Credentials(S3_KEY, S3_SECRET)
            if name == "256MiB":
                # aws-chunked with Content-MD5: the streaming route
                hdrs, wire = sigv4.sign_request_streaming(
                    creds, "PUT", url, {"Content-MD5": base64.b64encode(
                        hashlib.md5(body).digest()).decode()}, body)
            else:
                hdrs, wire = sigv4.sign_request(creds, "PUT", url, {},
                                                body), body
            t0 = time.perf_counter()
            r = client.send("PUT", url, wire, hdrs)
            readings[f"put_{name}_s"] = time.perf_counter() - t0
            check(r.headers["ETag"] == f'"{hashlib.md5(body).hexdigest()}"',
                  f"HTTP PUT ETag {name}")
            if name == "256MiB":
                readings["pipeline_256MiB"] = dict(er.pipe_stats)
        torch.cuda.synchronize()
        s_put = snapshot()
        for name, body in bodies.items():
            t0 = time.perf_counter()
            got = client.get_object("smoke", name).body
            readings[f"get_{name}_s"] = time.perf_counter() - t0
            check(got == body, f"HTTP GET {name}")
            if len(body) > 2:
                lo, ln = len(body) // 3, max(1, len(body) // 5)
                r = client.get_object("smoke", name, (lo, lo + ln - 1))
                check(r.status == 206 and r.body == body[lo:lo + ln],
                      f"HTTP range GET {name}")
        s_get = snapshot()
        head = client.head_object("smoke", "block+1")
        check(int(head.headers["Content-Length"]) == BLOCK + 1, "HTTP HEAD")
        page = client.list_objects("smoke", delimiter="/")
        check(sorted(o["key"] for o in page["objects"]) == sorted(bodies)
              and page["prefixes"] == [], f"ListObjectsV2: {page}")
        big = bodies["256MiB"]
        wipe(root, "256MiB", victims_of(er, "256MiB"))
        t0 = time.perf_counter()
        got = client.get_object("smoke", "256MiB").body
        readings["degraded_get_s"] = time.perf_counter() - t0
        check(got == big, "HTTP degraded GET 256MiB")
        s_deg = snapshot()
        client.delete_object("smoke", "256MiB")
        check(client.list_objects("smoke", prefix="256")["objects"] == [],
              "HTTP DELETE 256MiB")
        s_del = snapshot()
        burst = burst_bodies()
        wall = http_burst(srv.endpoint, burst)
        for i, body in enumerate(burst):
            check(client.get_object("smoke", f"burst/{i}").body == body,
                  f"HTTP burst object {i} reads back")
        s_end = snapshot()
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    phases = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
              "degraded_get": delta(s_get, s_deg),
              "burst": delta(s_del, s_end)}
    total = delta(s0, s_end)
    n = len(burst)
    readings.update(
        put_256MiB_gib_s=len(big) / readings["put_256MiB_s"] / 2**30,
        get_256MiB_gib_s=len(big) / readings["get_256MiB_s"] / 2**30,
        burst_wall_s=wall, burst_objects_per_s=n / wall)
    inproc_put = len(big) / inproc["put_256MiB_s"] / 2**30
    inproc_get = len(big) / inproc["get_256MiB_s"] / 2**30
    readings["in_process"] = {
        "put_256MiB_gib_s": inproc_put, "get_256MiB_gib_s": inproc_get,
        "degraded_get_s": inproc["degraded_get_s"],
        "burst_objects_per_s": inproc["burst"]["objects_per_s"]}
    print(f"S3 front on {card}: 256 MiB PUT (aws-chunked, Content-MD5) "
          f"{readings['put_256MiB_gib_s']:.3f} GiB/s "
          f"({readings['put_256MiB_s']:.3f} s; in-process "
          f"{inproc_put:.3f} GiB/s, {inproc['put_256MiB_s']:.3f} s), GET "
          f"{readings['get_256MiB_gib_s']:.3f} GiB/s "
          f"({readings['get_256MiB_s']:.3f} s; in-process "
          f"{inproc_get:.3f} GiB/s, {inproc['get_256MiB_s']:.3f} s), "
          f"degraded GET {readings['degraded_get_s']:.3f} s (in-process "
          f"{inproc['degraded_get_s']:.3f} s), burst of {n} x {BURST_SIZE} B "
          f"from {BURST_THREADS} client threads "
          f"{readings['burst_objects_per_s']:.1f} objects/s (in-process "
          f"{inproc['burst']['objects_per_s']:.1f} objects/s)")
    pipes = {"HTTP": readings["pipeline_256MiB"],
             "in-process": inproc["pipeline_256MiB"]}
    print("256 MiB PUT pipeline per batch on " + card + ": " + "; ".join(
        f"{label} {p['wall_s'] * 1e3 / p['batches']:.1f} ms wall, waiting "
        f"on the body {p['body_wait_s'] * 1e3 / p['batches']:.1f} ms, MD5 "
        f"{p['md5_s'] * 1e3 / p['batches']:.1f} ms, encode + frame "
        f"{p['encode_s'] * 1e3 / p['batches']:.1f} ms"
        for label, p in pipes.items()))
    print("S3 path launches per phase (kernel, plain): "
          + json.dumps(phases))
    # a healthy GET verifies (Kernel B) and rebuilds nothing: Kernel A
    # runs in the degraded GET, as in phase 5's GET phase
    for phase, kernels in (("put", ("gf8_apply", "hh256")),
                           ("get", ("hh256",)),
                           ("degraded_get", ("gf8_apply", "hh256")),
                           ("burst", ("gf8_apply", "hh256"))):
        for kernel in kernels:
            check(phases[phase][kernel][0] > 0,
                  f"{kernel} not launched during the S3 {phase}")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"S3 path: {kernel} plain version ran {plain} "
              "times")
    return {k: v[0] for k, v in total.items()}, readings


MP_PART, MP_PARTS, MP_WORKERS = 16 << 20, 32, 4    # minio-go's defaults


def part_files(root: str, bucket: str, key: str, drives) -> dict:
    """{(drive, file name): bytes} of the object's part files."""
    import glob
    out = {}
    for d in drives:
        for path in sorted(glob.glob(f"{root}/d{d}/{bucket}/{key}/*/part.*")):
            with open(path, "rb") as f:
                out[(d, os.path.basename(path))] = f.read()
    return out


def phase_multipart(card: str, gen) -> tuple:
    """Multipart and versioning over HTTP on a fresh set, then the mesh
    set's multipart upload; returns the launches and the readings."""
    import glob
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client, multipart_etag
    from minio_tpu_torch.server_main import build_server
    root = tempfile.mkdtemp(prefix="chip-smoke-mp-")
    srv = build_server([f"{root}/d{i}" for i in range(K + M)],
                       "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                       device="cuda")
    er, = srv.layer.sets
    srv.start()
    readings, steps = {}, {}
    body = rand_bytes((MP_PART * MP_PARTS,), gen).cpu().numpy().tobytes()
    md5 = hashlib.md5(body).hexdigest()
    try:
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        client.make_bucket("smoke")
        # what the client spends signing one part (aws-chunked), alone
        t0 = time.perf_counter()
        sigv4.sign_request_streaming(
            sigv4.Credentials(S3_KEY, S3_SECRET), "PUT",
            f"{srv.endpoint}/smoke/mp?partNumber=1&uploadId=x", {},
            body[:MP_PART])
        sign_s = time.perf_counter() - t0
        reset_counts()
        s0 = snapshot()
        # 1-2: the upload, ListParts, complete
        t0 = time.perf_counter()
        uid, parts, part_s = client.upload_parts("smoke", "mp", body,
                                                 MP_PART, MP_WORKERS)
        upload_s = time.perf_counter() - t0
        stages = {k: float(np.mean([st[k] for st in er.part_stats]))
                  for k in er.part_stats[0]}
        want_etags = [hashlib.md5(body[o:o + MP_PART]).hexdigest()
                      for o in range(0, len(body), MP_PART)]
        listed = client.list_parts("smoke", "mp", uid)
        check([(p["part_number"], p["etag"], p["size"]) for p in listed]
              == [(i + 1, e, MP_PART) for i, e in enumerate(want_etags)],
              "ListParts")
        t0 = time.perf_counter()
        r = client.complete_multipart_upload("smoke", "mp", uid, parts)
        complete_s = time.perf_counter() - t0
        etag = r.xml().findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}ETag").strip('"')
        check(etag == multipart_etag(want_etags) and etag.endswith("-32"),
              f"multipart ETag {etag}")
        torch.cuda.synchronize()
        s_put = snapshot()
        # 3: GET and a range across a part and a block boundary
        t0 = time.perf_counter()
        got = client.get_object("smoke", "mp").body
        get_s = time.perf_counter() - t0
        check(hashlib.md5(got).hexdigest() == md5, "multipart GET MD5")
        # from 3 MiB before part 2 to 1 MiB into its second block
        lo, hi = MP_PART - 3 * BLOCK // 10, MP_PART + BLOCK + BLOCK // 10
        r = client.get_object("smoke", "mp", (lo, hi))
        check(r.status == 206 and r.body == body[lo:hi + 1],
              "multipart range across a part and a block boundary")
        s_get = snapshot()
        # 4: degraded GET
        victims = victims_of(er, "mp")
        saved = part_files(root, "smoke", "mp", victims)
        check(len(saved) == M * MP_PARTS, f"{len(saved)} part files")
        wipe(root, "mp", victims)
        t0 = time.perf_counter()
        got = client.get_object("smoke", "mp").body
        degraded_s = time.perf_counter() - t0
        check(hashlib.md5(got).hexdigest() == md5, "multipart degraded GET")
        s_deg = snapshot()
        # 5: heal, the healed part files, GET through the healed drives
        t0 = time.perf_counter()
        res = er.heal_object("smoke", "mp")
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
        check(part_files(root, "smoke", "mp", victims) == saved,
              "healed part files differ from the removed ones")
        del saved
        wipe(root, "mp", [d for d in range(K + M) if d not in victims][:M])
        got = client.get_object("smoke", "mp").body
        check(hashlib.md5(got).hexdigest() == md5,
              "multipart GET through the healed drives")
        del got
        s_heal = snapshot()
        # 6: an aborted upload leaves no staging dir; its parts go one
        # at a time, the time of a part without concurrent ones
        uid2, _, serial_s = client.upload_parts(
            "smoke", "gone", body[:3 * MP_PART], MP_PART, 1)
        client.abort_multipart_upload("smoke", "gone", uid2)
        check(client.list_multipart_uploads("smoke") == []
              and not glob.glob(f"{root}/d*/.mt.sys/multipart/*"),
              "staging left after abort")
        s_abort = snapshot()
        # 7: a versioned bucket
        readings["versioning"] = versioning_steps(client, er, root, body)
        s_ver = snapshot()
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    # 8: the mesh set's multipart upload (Kernel C)
    mesh_parts, mesh_reading = mesh_multipart(body)
    s_mesh = snapshot()
    steps = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
             "degraded_get": delta(s_get, s_deg),
             "heal": delta(s_deg, s_heal), "abort": delta(s_heal, s_abort),
             "versioning": delta(s_abort, s_ver),
             "mesh_put": mesh_parts, "mesh": delta(s_ver, s_mesh)}
    total = delta(s0, s_mesh)
    for step, kernels in (("put", ("gf8_apply", "hh256")),
                          ("get", ("hh256",)),
                          ("degraded_get", ("gf8_apply", "hh256")),
                          ("heal", ("gf8_apply", "hh256")),
                          ("versioning", ("gf8_apply", "hh256")),
                          ("mesh_put", ("rs_fused",))):
        for kernel in kernels:
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched during the multipart {step}")
    for kernel in ("gf8_apply", "hh256"):
        check(steps["mesh_put"][kernel][0] == 0,
              f"{kernel} launched during the mesh set's part PUTs")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"multipart path: {kernel} plain version ran "
              f"{plain} times")
    gib = len(body) / 2**30
    ps = sorted(part_s)
    readings.update(
        upload_s=upload_s, upload_gib_s=gib / upload_s,
        part_p50_s=ps[len(ps) // 2], part_max_s=ps[-1],
        part_stages_mean_s=stages, serial_part_mean_s=float(
            np.mean(serial_s)), client_sign_part_s=sign_s,
        complete_s=complete_s, get_s=get_s, get_gib_s=gib / get_s,
        degraded_get_s=degraded_s, heal_s=heal_s, mesh=mesh_reading,
        launches={k: {n: v[0] for n, v in d.items()}
                  for k, d in steps.items()})
    print(f"multipart on {card}: {len(body) >> 20} MiB as {MP_PARTS} x "
          f"{MP_PART >> 20} MiB parts from "
          f"{MP_WORKERS} client threads (aws-chunked, Content-MD5) in "
          f"{upload_s:.3f} s ({gib / upload_s:.3f} GiB/s), per part p50 "
          f"{readings['part_p50_s']:.3f} s, max {ps[-1]:.3f} s; complete "
          f"{complete_s:.3f} s; GET {get_s:.3f} s ({gib / get_s:.3f} GiB/s), "
          f"degraded GET {degraded_s:.3f} s, heal of 4 drives x "
          f"{MP_PARTS} parts {heal_s:.3f} s; ETag {etag}")
    print(f"a 16 MiB part on {card}: in the server, means over the 32 "
          f"parts (s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    stages.items() if k != "bytes")
          + f"; one part alone (1 client thread) "
          f"{readings['serial_part_mean_s']:.3f} s; the client's "
          f"aws-chunked signing of one part {sign_s:.3f} s")
    print("multipart launches per step (kernel, plain): "
          + json.dumps(steps))
    return {k: v[0] for k, v in total.items()}, readings


def versioning_steps(client, er, root: str, body: bytes) -> dict:
    """Phase 8's versioned bucket; returns its readings."""
    client.make_bucket("ver")
    client.set_bucket_versioning("ver", True)
    check(client.get_bucket_versioning("ver") == "Enabled", "versioning")
    t0 = time.perf_counter()
    bodies = [body[:100 * 1024], body[:2 * BLOCK + 5]]
    vids = [client.put_object("ver", "k", b).headers["x-amz-version-id"]
            for b in bodies]
    uid, parts, _ = client.upload_parts("ver", "k", body[:2 * MP_PART],
                                        MP_PART, 2)
    r = client.complete_multipart_upload("ver", "k", uid, parts)
    vids.append(r.headers["x-amz-version-id"])
    bodies.append(body[:2 * MP_PART])
    marker = client.delete_object("ver", "k").headers
    check(marker.get("x-amz-delete-marker") == "true", "delete marker")
    for vid, b in zip(vids, bodies):
        check(client.get_object("ver", "k", version_id=vid).body == b,
              f"version {vid} reads back")
    r = client.get_object("ver", "k", expect=(405,))
    check(r.headers.get("x-amz-delete-marker") == "true",
          "GET of the delete marker")
    listed = client.list_object_versions("ver")
    check([(v["version_id"], v["delete_marker"], v["is_latest"])
           for v in listed] == [(marker["x-amz-version-id"], True, True)]
          + [(v, False, False) for v in reversed(vids)],
          f"ListObjectVersions {listed}")
    client.delete_object("ver", "k", version_id=vids[1])
    fi, _ = er._read_quorum_fileinfo("ver", "k", vids[0])
    drive = fi.erasure.distribution.index(1)
    shutil.rmtree(f"{root}/d{drive}/ver/k")
    res = er.heal_object("ver", "k", version_id=vids[0])
    check(len(res.healed_disks) == 1 and er.disks[drive].read_version(
        "ver", "k", vids[0]).version_id == vids[0],
        f"heal of the oldest version: {res}")
    check(client.get_object("ver", "k", version_id=vids[0]).body
          == bodies[0], "the healed version reads back")
    return {"versions": len(vids), "seconds": time.perf_counter() - t0}


def mesh_multipart(body: bytes) -> tuple:
    """In process on the one-device mesh set: a 3 x 5 MiB + 1 MiB upload;
    returns the launches of its part PUTs and the readings."""
    from minio_tpu_torch.parallel.mesh import make_mesh
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-mp-")
    try:
        er = new_set(root, mesh=make_mesh([torch.device("cuda", 0)]))
        mib = 1 << 20
        sizes = [5 * mib] * 3 + [mib]
        uid = er.new_multipart_upload("smoke", "mmp")
        s0 = snapshot()
        parts, chunks, off = [], {}, 0
        for n, size in enumerate(sizes, 1):
            chunks[n] = body[off:off + size]
            parts.append((n, er.put_object_part("smoke", "mmp", uid, n,
                                                chunks[n]).etag))
            off += len(chunks[n])
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
        # one for a part's full blocks, one for its short last block
        want = fused_launches(chunks, er._batch_bytes(), er._batch_bytes())
        check(launches["rs_fused"][0] == want,
              f"mesh parts launched Kernel C {launches['rs_fused'][0]} "
              f"times, expected {want}")
        er.complete_multipart_upload("smoke", "mmp", uid, parts)
        check(er.get_object("smoke", "mmp")[1] == body[:off],
              "mesh multipart GET")
        er.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, {"parts": len(sizes), "bytes": off}


SETS_BUCKET, SETS_OBJ, SETS_OBJS, SETS_THREADS = "sets", 16 << 20, 64, 8
SETS_D2H = 12         # 16 MiB PUTs per set in each D2H wait reading


class ThreadPeak:
    """The most threads alive at once, sampled every 20 ms."""

    def __init__(self):
        import threading
        self.peak = threading.active_count()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="smoke-thread-peak")
        self._t.start()

    def _run(self):
        import threading
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, threading.active_count())

    def stop(self) -> int:
        self._stop.set()
        self._t.join()
        return self.peak


def wait_heal_kicks() -> None:
    """Join the heal sweeps that returning drives started."""
    import threading
    for t in threading.enumerate():
        if t.name == "mt-drive-heal-kick":
            t.join(300)


def drive_shards(disk, bucket: str, keys) -> dict:
    """{key: sha256 of the drive's framed shard}: inline data, the packed
    extent, or every part file."""
    out = {}
    for key in keys:
        fi = disk.read_version(bucket, key)
        if fi.inline_data is not None:
            data = fi.inline_data
        elif fi.seg is not None:
            data = disk.read_segment(fi.seg["sid"], fi.seg["off"],
                                     fi.seg["len"])
        else:
            data = b"".join(disk.read_all(
                bucket, f"{key}/{fi.data_dir}/part.{p.number}")
                for p in fi.parts)
        out[key] = hashlib.sha256(data).digest()
    return out


def tree_stat(root: str) -> dict:
    """{path: (size, mtime_ns)} of every file under a drive."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            st = os.stat(p)
            out[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns)
    return out


def put_lanes(endpoint: str, bucket: str, lanes: list) -> float:
    """PUT each lane's (key, body) items in order over HTTP, one client
    thread per lane; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def worker(items):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for key, body in items:
            r = client.put_object(bucket, key, body)
            check(r.headers["ETag"] == f'"{hashlib.md5(body).hexdigest()}"',
                  f"sets PUT ETag {key}")

    with ThreadPoolExecutor(len(lanes)) as pool:
        t0 = time.perf_counter()
        list(pool.map(worker, lanes))
        return time.perf_counter() - t0


def put_many(endpoint: str, bucket: str, items: list, threads: int) -> float:
    """PUT (key, body) items over HTTP from ``threads`` client threads."""
    return put_lanes(endpoint, bucket,
                     [items[t::threads] for t in range(threads)])


def keys_in_set(layer, prefix: str, s: int, count: int) -> list:
    """The first ``count`` names ``prefix``NNN that hash to set ``s``."""
    return [k for k in (f"{prefix}{i:03d}" for i in range(1000))
            if layer.get_hashed_set_index(k) == s][:count]


def get_many(endpoint: str, bucket: str, items: list, threads: int) -> float:
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def worker(t):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for key, body in items[t::threads]:
            check(client.get_object(bucket, key).body == body,
                  f"sets GET {key}")

    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(worker, range(threads)))
        return time.perf_counter() - t0


def d2h_ms(er) -> float:
    waits = list(er.d2h_waits)
    return float(np.mean(waits)) * 1e3 if waits else float("nan")


def phase_sets(bodies: dict, card: str, gen, single: dict):
    """Two sets of 16 drives behind ``build_server`` over HTTP: placement,
    reads, listing, drive health and heal-on-return; returns the launches
    and the readings."""
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client, multipart_etag
    from minio_tpu_torch.server_main import build_server
    from minio_tpu_torch.storage.format import FormatErasure
    from minio_tpu_torch.utils import bufpool
    n = 2 * (K + M)
    root = tempfile.mkdtemp(prefix="chip-smoke-sets-")
    phase_t0 = time.perf_counter()
    laps: dict = {}

    def lap(step: str) -> None:
        laps[step] = time.perf_counter() - phase_t0 - sum(laps.values())

    peak = ThreadPeak()
    srv = build_server([f"{root}/d{i}" for i in range(n)], "127.0.0.1:0",
                       S3_KEY, S3_SECRET, BLOCK, device="cuda")
    layer = srv.layer
    readings, steps = {}, {}
    big = bodies["256MiB"]
    blob = rand_bytes((SETS_OBJS * SETS_OBJ,), gen).cpu().numpy().tobytes()
    objs = [(f"obj/{i:02d}", blob[i * SETS_OBJ:(i + 1) * SETS_OBJ])
            for i in range(SETS_OBJS)]
    try:
        check((layer.set_count, layer.set_drive_count) == (2, K + M),
              f"{layer.set_count} sets of {layer.set_drive_count}")
        for s in layer.sets:
            check((s.data_blocks, s.parity, s.device.type) == (K, M, "cuda"),
                  f"a set is {s.data_blocks} + {s.parity} on {s.device}")
        fmts = [FormatErasure.from_json(open(
            f"{root}/d{i}/.mt.sys/format.json", "rb").read())
            for i in range(n)]
        grid = fmts[0].sets
        check(len({f.id for f in fmts}) == 1 and fmts[0].id ==
              layer.deployment_id, "one deployment id on every drive")
        check(len(grid) == 2 and all(len(r) == K + M for r in grid)
              and [f.this for f in fmts] == [u for r in grid for u in r],
              "a 2 x 16 grid, each drive its own place")
        srv.start()
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        r = client.request("GET", "/minio/health/cluster", sign=False)
        check(r.status == 200 and r.headers["X-Minio-Write-Quorum"] == str(K),
              f"health at start: {r.status} {r.headers}")
        client.make_bucket(SETS_BUCKET)
        lap("setup")
        reset_counts()
        s0 = snapshot()
        # writes: 16 MiB objects over both sets, then over set 0 alone
        for s in layer.sets:
            s.d2h_waits.clear()
        put_s = put_many(srv.endpoint, SETS_BUCKET, objs, SETS_THREADS)
        # set 0's D2H wait alone, then with set 1 as busy beside it: 12
        # PUTs of 16 MiB per set from 4 client threads per set
        lanes = SETS_THREADS // 2

        def d2h_items(prefix, s):
            return [(k, objs[i][1]) for i, k in
                    enumerate(keys_in_set(layer, prefix, s, SETS_D2H))]
        alone = d2h_items("alone/", 0)
        beside = d2h_items("beside/", 0) + d2h_items("beside/", 1)
        for s in layer.sets:
            s.d2h_waits.clear()
        alone_s = put_many(srv.endpoint, SETS_BUCKET, alone, lanes)
        check(len(layer.sets[1].d2h_waits) == 0, "set 1 busy while alone")
        alone_ms = d2h_ms(layer.sets[0])
        alone_n = len(layer.sets[0].d2h_waits)
        for s in layer.sets:
            s.d2h_waits.clear()
        put_lanes(srv.endpoint, SETS_BUCKET,
                  [beside[:SETS_D2H][t::lanes] for t in range(lanes)]
                  + [beside[SETS_D2H:][t::lanes] for t in range(lanes)])
        both = [d2h_ms(s) for s in layer.sets]
        both_n = [len(s.d2h_waits) for s in layer.sets]
        for key, _ in beside:
            client.delete_object(SETS_BUCKET, key)
        url = f"{srv.endpoint}/{SETS_BUCKET}/big"
        hdrs, wire = sigv4.sign_request_streaming(
            sigv4.Credentials(S3_KEY, S3_SECRET), "PUT", url,
            {"Content-MD5": base64.b64encode(
                hashlib.md5(big).digest()).decode()}, big)
        t0 = time.perf_counter()
        client.send("PUT", url, wire, hdrs)
        big_put_s = time.perf_counter() - t0
        del wire
        mp_body = blob[:2 * MP_PART + 1234567]
        uid, parts, _ = client.upload_parts(SETS_BUCKET, "mp", mp_body,
                                            MP_PART, 3)
        r = client.complete_multipart_upload(SETS_BUCKET, "mp", uid, parts)
        etag = r.xml().findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}ETag").strip('"')
        check(etag == multipart_etag([e for _, e in parts]), "sets mp ETag")
        torch.cuda.synchronize()
        s_put = snapshot()
        lap("put")
        burst = [(f"burst/{i:03d}", b) for i, b in enumerate(burst_bodies())]
        burst_s = put_many(srv.endpoint, SETS_BUCKET, burst, BURST_THREADS)
        s_burst = snapshot()
        lap("burst")
        everything = objs + alone + [("big", big), ("mp", mp_body)] + burst
        names = sorted(k for k, _ in everything)
        readings["objects_per_set"] = [
            sum(layer.get_hashed_set_index(k) == i for k, _ in objs)
            for i in range(2)]
        check(min(readings["objects_per_set"]) >= SETS_OBJS // 4,
              f"16 MiB objects per set {readings['objects_per_set']}")
        for key in names:
            s = layer.get_hashed_set_index(key)
            where = [d // (K + M) for d in range(n) if os.path.exists(
                f"{root}/d{d}/{SETS_BUCKET}/{key}/xl.meta")]
            check(where == [s] * (K + M), f"{key} on the drives of set "
                  f"{sorted(set(where))}, placed in set {s}")
        lap("placement")
        # reads: every object, then ListObjectsV2 in pages of 25
        get_s = get_many(srv.endpoint, SETS_BUCKET, everything,
                         SETS_THREADS)
        t0 = time.perf_counter()
        check(client.get_object(SETS_BUCKET, "big").body == big, "GET big")
        big_get_s = time.perf_counter() - t0
        lap("get")
        listed, token, pages = [], "", 0
        while True:
            page = client.list_objects(SETS_BUCKET, max_keys=25,
                                       continuation_token=token)
            listed += [o["key"] for o in page["objects"]]
            pages += 1
            if not page["is_truncated"]:
                break
            token = page["next_token"]
        check(listed == names, "ListObjectsV2 in pages of 25")
        lap("list")
        s_get = snapshot()
        del everything
        # health: in each set a drive goes that holds a data shard of the
        # set's first 16 MiB object (a GET reads the k data shards, so only
        # such a drive makes it rebuild); a degraded GET of that object
        # marks the drive offline.  Not one of the drives taken away below.
        away, foreign = [4, 5, 6, 7], K + M + 5
        deg_keys, victims = [], []
        for s in range(2):
            key = next(k for k, _ in objs
                       if layer.get_hashed_set_index(k) == s)
            fi, _ = layer.sets[s]._read_quorum_fileinfo(SETS_BUCKET, key)
            v = next(s * (K + M) + d for d, shard in
                     enumerate(fi.erasure.distribution) if shard <= K
                     and s * (K + M) + d not in away + [foreign])
            deg_keys.append(key)
            victims.append(v)
        hds = [layer.sets[v // (K + M)].disks[v % (K + M)] for v in victims]
        per_set_keys = [[k for k in names
                         if layer.get_hashed_set_index(k) == s]
                        for s in range(2)]
        before = [drive_shards(hd, SETS_BUCKET, per_set_keys[s])
                  for s, hd in enumerate(hds)]
        lap("digests")
        for v in victims:
            shutil.rmtree(f"{root}/d{v}")
        t0 = time.perf_counter()
        for key in deg_keys:
            check(client.get_object(SETS_BUCKET, key).body ==
                  dict(objs)[key], f"degraded GET {key}")
        degraded_s = (time.perf_counter() - t0) / 2
        check(all(hd.offline for hd in hds), "wiped drives not offline")
        s_deg = snapshot()
        lap("degraded_get")
        healed = {0: [], 1: []}         # objects each set's sweeps healed
        for i, s in enumerate(layer.sets):
            def counted(b, key, *a, _heal=s.heal_object, _i=i, **kw):
                healed[_i].append(key)
                return _heal(b, key, *a, **kw)
            s.heal_object = counted
        # four more drives of set 0 away: 11 of 16 online, below the
        # write quorum of 12
        for d in away:
            os.rename(f"{root}/d{d}", f"{root}/away{d}")
            hd = layer.sets[0].disks[d]
            try:
                hd.stat_vol(SETS_BUCKET)
            except OSError:
                pass
            check(hd.offline, f"drive {d} not offline")
        r = client.request("GET", "/minio/health/cluster", sign=False,
                           expect=(503,))
        check(r.headers["X-Minio-Write-Quorum"] == str(K),
              "503 below quorum")
        client.request("GET", "/minio/health/cluster", "maintenance=true",
                       sign=False, expect=(412,))
        for d in away:
            os.rename(f"{root}/away{d}", f"{root}/d{d}")
        layer.monitor.poll_once()
        wait_heal_kicks()
        check(not any(layer.sets[0].disks[d].offline for d in away),
              "returned drives still offline")
        r = client.request("GET", "/minio/health/cluster", sign=False)
        check(r.status == 200, "health after the drives returned")
        # the four returning drives share set 0's sweep: one, or one more
        # for drives that came back while it ran
        sweeps = len(healed[0]) / len(per_set_keys[0])
        check(sweeps in (1, 2) and not healed[1],
              f"{sweeps} sweeps of set 0, {len(healed[1])} objects of set "
              "1 swept, for four returning drives of set 0")
        readings["quorum_sweeps_set0"] = sweeps
        lap("quorum")
        # the two wiped drives return empty: formatted, their sets healed
        for keys in healed.values():
            keys.clear()
        others = {d: tree_stat(f"{root}/d{d}") for d in range(n)
                  if d not in victims}
        s_heal0 = snapshot()
        lap("before_heal")
        for v in victims:
            os.makedirs(f"{root}/d{v}")
        t0 = time.perf_counter()
        layer.monitor.poll_once()
        wait_heal_kicks()
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        s_heal = snapshot()
        for s in layer.sets:
            del s.heal_object
        rebuilt = 0
        for s, (v, hd) in enumerate(zip(victims, hds)):
            fmt = FormatErasure.from_json(open(
                f"{root}/d{v}/.mt.sys/format.json", "rb").read())
            check(fmt.this == grid[s][v % (K + M)] == hd.get_disk_id()
                  and not hd.offline, f"drive {v} formatted as itself")
            check(sorted(healed[s]) == per_set_keys[s],
                  f"set {s} swept {len(healed[s])} objects")
            after = drive_shards(hd, SETS_BUCKET, per_set_keys[s])
            check(after == before[s], f"drive {v}: healed shards differ")
            rebuilt += sum(sz for sz, _ in tree_stat(f"{root}/d{v}").values())
        check(all(tree_stat(f"{root}/d{d}") == t for d, t in others.items()),
              "a drive that stayed was written by the heal")
        lap("heal")
        # a drive of another deployment in place of one of set 1
        hd = layer.sets[1].disks[foreign - (K + M)]
        shutil.rmtree(f"{root}/d{foreign}")
        try:
            hd.stat_vol(SETS_BUCKET)
        except OSError:
            pass
        check(hd.offline, "removed drive of set 1 not offline")
        os.makedirs(f"{root}/foreign/{SETS_BUCKET}/x")
        with open(f"{root}/foreign/{SETS_BUCKET}/x/data", "wb") as f:
            f.write(b"theirs")
        os.makedirs(f"{root}/foreign/.mt.sys")
        with open(f"{root}/foreign/.mt.sys/format.json", "w") as f:
            f.write(FormatErasure(id="0ther-dep1oyment", this="their-drive",
                                  sets=[["their-drive"]]).to_json())
        os.rename(f"{root}/foreign", f"{root}/d{foreign}")
        theirs = tree_stat(f"{root}/d{foreign}")
        layer.monitor.poll_once()
        wait_heal_kicks()
        key = next(k for k, _ in objs if layer.get_hashed_set_index(k) == 1)
        check(client.get_object(SETS_BUCKET, key).body == dict(objs)[key],
              "GET beside the foreign drive")
        check(hd.offline and tree_stat(f"{root}/d{foreign}") == theirs,
              "the foreign drive was admitted or written")
        out_after = bufpool.GLOBAL.checked_out
        lap("foreign")
        control = phase_control(srv, root, card, gen)
        check(bufpool.GLOBAL.checked_out == 0, "pooled buffers checked out "
              "after phase 10")
    finally:
        srv.stop()
        threads = peak.stop()
        shutil.rmtree(root, ignore_errors=True)
    lap("stop")
    phase_s = time.perf_counter() - phase_t0
    check(out_after == 0, f"{out_after} pooled buffers checked out")
    steps = {"put": delta(s0, s_put), "burst": delta(s_put, s_burst),
             "get": delta(s_burst, s_get),
             "degraded_get": delta(s_get, s_deg),
             "heal": delta(s_heal0, s_heal)}
    total = delta(s0, s_heal)
    for step, kernels in (("put", ("gf8_apply", "hh256")),
                          ("burst", ("gf8_apply", "hh256")),
                          ("get", ("hh256",)),
                          ("degraded_get", ("gf8_apply", "hh256")),
                          ("heal", ("gf8_apply", "hh256"))):
        for kernel in kernels:
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched during the sets {step}")
    # each degraded GET rebuilds a lost data shard: one launch for the
    # full stripe, one for the short one
    check(steps["degraded_get"]["gf8_apply"][0] == 2 * len(deg_keys),
          f"Kernel A launched {steps['degraded_get']['gf8_apply'][0]} times "
          f"in {len(deg_keys)} degraded GETs")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"sets path: {kernel} plain version ran {plain} "
              "times")
    gib = SETS_OBJS * SETS_OBJ / 2**30
    read_gib = (sum(len(b) for _, b in objs) + len(alone) * SETS_OBJ
                + len(big) + len(mp_body) + len(burst) * BURST_SIZE) / 2**30
    readings.update(
        put_16MiB_s=put_s, put_16MiB_gib_s=gib / put_s,
        put_256MiB_s=big_put_s,
        put_256MiB_gib_s=len(big) / big_put_s / 2**30,
        get_s=get_s, get_gib_s=read_gib / get_s,
        get_256MiB_s=big_get_s, get_256MiB_gib_s=len(big) / big_get_s / 2**30,
        degraded_get_s=degraded_s,
        heal_sweep_s=heal_s, heal_rebuilt_bytes=rebuilt,
        heal_gib_s=rebuilt / heal_s / 2**30,
        burst_s=burst_s, burst_objects_per_s=len(burst) / burst_s,
        d2h_wait_ms_set0_alone=alone_ms, d2h_batches_set0_alone=alone_n,
        d2h_wait_ms_both_sets=both, d2h_batches_both_sets=both_n,
        put_set0_alone_s=alone_s, peak_threads=threads,
        bufpool_checked_out_after=out_after, list_pages=pages,
        phase_s=phase_s, step_s=laps,
        launches={k: {name: v[0] for name, v in d.items()}
                  for k, d in steps.items()})
    print(f"sets path on {card}: {phase_s:.1f} s; 2 sets x 16 drives; "
          f"{SETS_OBJS} x 16 MiB "
          f"from {SETS_THREADS} client threads {gib / put_s:.3f} GiB/s "
          f"({put_s:.3f} s, per set {readings['objects_per_set']}); 256 MiB "
          f"PUT {readings['put_256MiB_gib_s']:.3f} GiB/s (one set alone, "
          f"phase 7: {single['put_256MiB_gib_s']:.3f}); GET of all "
          f"{read_gib:.3f} GiB from {SETS_THREADS} threads "
          f"{read_gib / get_s:.3f} GiB/s, 256 MiB alone "
          f"{readings['get_256MiB_gib_s']:.3f} GiB/s (phase 7: "
          f"{single['get_256MiB_gib_s']:.3f}); degraded GET "
          f"of 16 MiB {degraded_s:.3f} s (phase 7, 256 MiB: "
          f"{single['degraded_get_s']:.3f} s); 4 drives of set 0 back: "
          f"{readings['quorum_sweeps_set0']:.0f} sweep(s) of it; heal "
          f"sweep of 2 returned "
          f"drives {heal_s:.3f} s, {rebuilt} B rebuilt "
          f"({readings['heal_gib_s']:.3f} GiB/s); burst "
          f"{readings['burst_objects_per_s']:.1f} objects/s (phase 7: "
          f"{single['burst_objects_per_s']:.1f}); set 0's D2H wait per "
          f"batch alone {alone_ms:.3f} ms ({alone_n} batches), with "
          f"set 1 as busy {both[0]:.3f} ms (set 1 {both[1]:.3f} ms; "
          f"{both_n} batches); peak {threads} threads; {out_after} pooled "
          "buffers out after")
    print("sets path seconds per step: " + json.dumps(laps))
    print("sets launches per step (kernel, plain): " + json.dumps(steps))
    return {k: v[0] for k, v in total.items()}, readings, control


CTL_BUCKET, CTL_OBJ = "control", 16 << 20      # phase 10


def parse_scrape(text: str) -> dict:
    """{(name, ((label, value), ...)): value} of a Prometheus scrape."""
    import re
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        head, value = ln.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        out[(name, tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                           labels))))] = float(value)
    return out


def by_label(samples: dict, name: str, label: str) -> dict:
    """{label value: sample} of one family, other labels summed over."""
    out: dict = {}
    for (n, labels), v in samples.items():
        if n == name:
            key = dict(labels)[label]
            out[key] = out.get(key, 0.0) + v
    return out


def version_shards(disk, bucket: str, key: str) -> dict:
    """{version id: sha256 of the drive's part file} for every version of
    ``key`` on one drive."""
    return {fi.version_id: hashlib.sha256(disk.read_all(
        bucket, f"{key}/{fi.data_dir}/part.1")).digest()
        for fi in disk.list_versions(bucket, key)}


def phase_control(srv, root: str, card: str, gen):
    """Phase 10 on phase 9's running server: the scrape reconciled with
    the phase's requests, the codec ops and the kernel launches; a live
    ``pipeline depth`` change; both versions of a key healed onto a drive
    through the admin route; ``storageinfo``, ``heal-status``; then
    ``service?action=stop``.  Returns the launches and the readings."""
    from collections import Counter
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import _api_name
    layer = srv.layer
    client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    made: Counter = Counter()

    def s3(method, bucket, key="", query=""):
        made[_api_name(method, bucket, key,
                       {query.split("=")[0]: ""} if query else {})] += 1

    readings: dict = {}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    before = parse_scrape(adm.metrics())
    reset_counts()
    s0 = snapshot()
    # a live pipeline change: depth 0 (serial fan-out, no writer plane),
    # then 2 (the writer plane), one 16 MiB PUT under each
    bodies = rand_bytes((3, CTL_OBJ), gen).cpu().numpy()
    put_s, plane_ops = {}, {}
    for depth in ("0", "2"):
        adm.set_config_kv("pipeline", "depth", depth)
        check(adm.get_config_kv("pipeline")["depth"] == depth and all(
            s._pipe_depth == int(depth) for s in layer.sets),
            f"pipeline depth {depth} not live")
        key = f"depth{depth}"
        er = layer.get_hashed_set(key)
        ops0 = sum(st["ops"] for st in er._write_plane.stats().values())
        t0 = time.perf_counter()
        client.put_object(SETS_BUCKET, key, bodies[int(depth) // 2].tobytes())
        s3("PUT", SETS_BUCKET, key)
        put_s[depth] = time.perf_counter() - t0
        plane_ops[depth] = sum(
            st["ops"] for st in er._write_plane.stats().values()) - ops0
        online = sum(not hd.offline for hd in er.disks)
    # one commit op per online drive of the set through the writer plane
    # at depth 2, none at 0
    check(plane_ops == {"0": 0, "2": online},
          f"writer plane ops per PUT at depth 0, 2: {plane_ops}")
    s_depth = snapshot()

    def beside_offline(name):
        dist = hash_order(f"{CTL_BUCKET}/{name}", K + M)
        return any(hd.offline and dist[i] <= K for i, hd in
                   enumerate(layer.sets[layer.get_hashed_set_index(name)]
                             .disks))
    # the key lands in the set of phase 9's foreign (offline) drive, which
    # holds one of its data shards, whatever set the deployment id gives
    # it: its GETs rebuild that shard (Kernel A, counted as matmul ops)
    key = next(n for n in ("k", *(f"k{i}" for i in range(1, 1000)))
               if beside_offline(n))
    # two versions of the key, a drive holding a data shard of the key
    # emptied of it, then the admin heal route
    client.make_bucket(CTL_BUCKET)
    s3("PUT", CTL_BUCKET)
    client.set_bucket_versioning(CTL_BUCKET, True)
    s3("PUT", CTL_BUCKET, query="versioning")
    vids = []
    for i in (1, 2):
        r = client.put_object(CTL_BUCKET, key, bodies[i].tobytes())
        s3("PUT", CTL_BUCKET, key)
        vids.append(r.headers["x-amz-version-id"])
    s_put = snapshot()
    si = layer.get_hashed_set_index(key)
    er = layer.sets[si]
    fi, _ = er._read_quorum_fileinfo(CTL_BUCKET, key)
    d = next(d for d, shard in enumerate(fi.erasure.distribution)
             if shard <= K and not er.disks[d].offline)
    disk = er.disks[d]
    want = version_shards(disk, CTL_BUCKET, key)
    check(sorted(want) == sorted(vids), "both versions on the drive")
    shutil.rmtree(f"{root}/d{si * (K + M) + d}/{CTL_BUCKET}/{key}")
    t0 = time.perf_counter()
    out = adm.heal(CTL_BUCKET)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    s_heal = snapshot()
    healed = parse_scrape(adm.metrics())
    check([(o["object"], o["version_id"]) for o in out["objects"]] ==
          [(key, v) for v in vids[::-1]] and
          all(o["healed"] == [disk.endpoint()] for o in out["objects"]),
          f"admin heal answered {out}")
    check(version_shards(disk, CTL_BUCKET, key) == want,
          "healed version shards differ from the drive's before")
    healed_bytes = sum(
        len(disk.read_all(CTL_BUCKET, f"{key}/{v.data_dir}/part.1"))
        for v in disk.list_versions(CTL_BUCKET, key))
    for i, vid in enumerate(vids):
        check(client.get_object(CTL_BUCKET, key, version_id=vid).body ==
              bodies[i + 1].tobytes(), f"GET version {i + 1}")
        s3("GET", CTL_BUCKET, key, "versionId=x")
    torch.cuda.synchronize()
    s_get = snapshot()
    # the sweep, unpaced (a live heal change), then what the admin
    # routes and the scrape say of it
    adm.set_config_kv("heal", "max_sleep", "0s")
    check(srv.healer.pace_s == 0.0, "heal max_sleep not live")
    t0 = time.perf_counter()
    srv.healer.sweep()
    sweep_s = time.perf_counter() - t0
    status = adm.heal_status()
    check(status["sweep"] == srv.healer.stats.to_dict(),
          f"heal-status {status} against {srv.healer.stats}")
    info = adm.storage_info()["disks"]
    check(len(info) == 2 * (K + M) and sum(e["state"] == "ok" for e in info)
          == 2 * (K + M) - 1, "storageinfo: 31 drives ok, the foreign one "
          "offline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = adm.metrics()
    scrape_ms = (time.perf_counter() - t0) * 1e3
    after = parse_scrape(text)
    s1 = snapshot()

    def gained(name, label, now=after, then=before):
        a, b = by_label(now, name, label), by_label(then, name, label)
        return {k: v - b.get(k, 0.0) for k, v in a.items()
                if v != b.get(k, 0.0)}
    apis = gained("mt_s3_requests_api_total", "api")
    check(apis == dict(made), f"per-API requests {apis} against {made}")
    ops = gained("mt_tpu_ops_total", "op")
    heal_ops = gained("mt_tpu_ops_total", "op", healed, before)
    get_ops = gained("mt_tpu_ops_total", "op", after, healed)
    launches = delta(s0, s1)
    a, b = launches["gf8_apply"][0], launches["hh256"][0]
    # a 16 MiB PUT: one encode, Kernel A for the full block and the short
    # one, Kernel B for their frames; the heal, and the GETs that rebuild
    # the offline drive's data shard: one matmul per Kernel A launch (full
    # and short stripe), Kernel B to verify and frame
    check(set(ops) == {"encode", "matmul"} and ops["encode"] == 4,
          f"codec ops {ops}")
    check(a == 2 * ops["encode"] + ops["matmul"],
          f"Kernel A launched {a} times for codec ops {ops}")
    put_a = delta(s0, s_put)
    check(put_a["gf8_apply"][0] == put_a["hh256"][0] == 2 * 4,
          f"PUT launches {put_a}")
    heal_l = delta(s_put, s_heal)
    check(set(heal_ops) == {"encode", "matmul"} and
          heal_l["gf8_apply"][0] == heal_ops["matmul"] > 0 and
          heal_l["hh256"][0] > 0,
          f"admin heal launches {heal_l} for codec ops {heal_ops}")
    get_l = delta(s_heal, s_get)
    check(set(get_ops) == {"matmul"} and
          get_l["gf8_apply"][0] == get_ops["matmul"] > 0 and
          delta(s_get, s1)["gf8_apply"][0] == 0,
          f"degraded GET launches {get_l} for codec ops {get_ops}")
    for (name, labels), v in after.items():
        if name == "mt_tpu_kernel_seconds_count":
            check(after[("mt_tpu_ops_total", labels)] == v,
                  f"kernel seconds count {v} for {labels}")
    st = srv.healer.stats
    for fam, field in (("mt_heal_objects_scanned_total", st.objects_scanned),
                       ("mt_heal_objects_healed_total", st.objects_healed),
                       ("mt_heal_objects_failed_total", st.objects_failed),
                       ("mt_heal_cycles_total", st.cycles)):
        check(after[(fam, ())] == field, f"{fam} {after[(fam, ())]} "
              f"against the sweep's {field}")
    effs = by_label(after, "mt_put_pipeline_overlap_efficiency", "set")
    check(effs and all(0 < e <= 1 for e in effs.values()),
          f"overlap efficiency {effs}")
    writes = by_label(after, "mt_put_pipeline_writes_total", "drive")
    check(len(writes) == 2 * (K + M) and min(writes.values()) > 0,
          "writer stats of every drive")
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"control plane: {kernel} plain version ran")
    # stop through the admin route: serve_forever ends
    adm.service_stop()
    check(srv.shutdown.wait(60), "service?action=stop did not stop")
    readings.update(
        scrape_ms=scrape_ms, scrape_bytes=len(text), put_depth0_s=put_s["0"],
        put_depth2_s=put_s["2"], writer_ops_depth0=plane_ops["0"],
        writer_ops_depth2=plane_ops["2"], overlap_efficiency=effs,
        admin_heal_s=heal_s, admin_heal_bytes=healed_bytes,
        admin_heal_gib_s=healed_bytes / heal_s / 2**30,
        sweep_s=sweep_s, sweep_versions=srv.healer.stats.objects_scanned,
        codec_ops=ops, heal_codec_ops=heal_ops, get_codec_ops=get_ops,
        key=key, key_set=si, requests=dict(made),
        phase_s=time.perf_counter() - t_phase,
        launches={"depth_puts": {k: v[0] for k, v in
                                 delta(s0, s_depth).items()},
                  "version_puts": {k: v[0] for k, v in
                                   delta(s_depth, s_put).items()},
                  "admin_heal": {k: v[0] for k, v in heal_l.items()},
                  "degraded_gets": {k: v[0] for k, v in get_l.items()}})
    print(f"control plane on {card}: scrape {scrape_ms:.2f} ms over "
          f"{2 * (K + M)} drives ({len(text)} B); 16 MiB PUT at pipeline "
          f"depth 0 {put_s['0']:.3f} s, depth 2 {put_s['2']:.3f} s; admin "
          f"heal of 2 versions {heal_s:.3f} s, {healed_bytes} B "
          f"({readings['admin_heal_gib_s']:.3f} GiB/s); sweep of "
          f"{st.objects_scanned} versions {sweep_s:.3f} s; codec ops {ops}, "
          f"Kernel A {a}, Kernel B {b} launches")
    return {k: v[0] for k, v in launches.items()}, readings


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    clock = sm_clock_mhz()
    print(f"device: {card} | max SM clock {clock:.0f} MHz | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    kernels = [phase_kernel_a(gen), phase_kernel_b(gen, clock, card),
               phase_kernel_c(gen, clock, card)]
    phase_encode_layout(gen)
    bodies = make_bodies(gen)
    path, shards, path_readings = phase_path(bodies, card)
    mesh_path, mesh_readings = phase_mesh_path(bodies, card, shards)
    s3_path, s3_readings = phase_s3(bodies, card, path_readings)
    mp_path, mp_readings = phase_multipart(card, gen)
    sets_path, sets_readings, (ctl_path, ctl_readings) = phase_sets(
        bodies, card, gen, s3_readings)
    for k in kernels:
        by_path = {"path": path[k["name"]], "mesh_path": mesh_path[k["name"]],
                   "s3_path": s3_path[k["name"]],
                   "multipart_path": mp_path[k["name"]],
                   "sets_path": sets_path[k["name"]],
                   "control_path": ctl_path[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"card": card, "path": path_readings,
                      "mesh_path": mesh_readings, "s3_path": s3_readings,
                      "multipart_path": mp_readings,
                      "sets_path": sets_readings,
                      "control_path": ctl_readings}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
7. One JSON line describing each kernel, the card line, and the result
   line.

Any mismatch raises, and the script exits nonzero without the result
line; it also exits nonzero when torch sees no card.
"""

from __future__ import annotations

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
            info = er.put_object("smoke", name, body)
            check(info.etag == hashlib.md5(body).hexdigest(), f"etag {name}")
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        s_put = snapshot()
        readings["pipeline_256MiB"] = dict(er.pipe_stats)
        shards = {name: shard_digests(er, name) for name in bodies}

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
    for k in kernels:
        k["launches"] = path[k["name"]] + mesh_path[k["name"]]
        k["launches_by_path"] = {"path": path[k["name"]],
                                 "mesh_path": mesh_path[k["name"]]}
    print(json.dumps({"card": card, "path": path_readings,
                      "mesh_path": mesh_readings}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

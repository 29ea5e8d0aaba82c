"""Keyed HighwayHash of many rows on tensors (Kernel B and its plain
version).

Counterpart of ``minio_tpu/ops/hh_kernels.py`` plus ``hh_pallas.py``.
``hh256_batch(blocks)`` gives the HighwayHash-256 (bitrot ``MAGIC_KEY`` by
default) of every row of a (B, n) or (G, R, n) uint8 tensor; rows may be
strided views, such as the payloads inside bitrot frames.  A CUDA tensor
launches ``csrc/hh256.cu``; a CPU tensor runs ``hh256_batch_ref``, the
torch form of ``hh_kernels.hh256_batch`` (packet update, ``_remainder_update``,
``_permute_update``, modular reduction).

The plain version holds every u64 of state as (hi, lo) u32 limbs in int64
tensors: torch has no unsigned 32/64-bit add, shift or compare on the CPU,
and a 32x32 product overflows signed int64, so products are built from
16-bit halves as ``hh_kernels._mul32`` does.  ``hh64_batch`` (the 64-bit
finalization) exists to hold both versions to the published HighwayHash64
test vectors.

``plan`` is the kernel's launch geometry (two threads per row, rows per
warp, warps per block, the shared-memory ring), in Python so that the CPU
tests cover it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from ..hashing.highwayhash import MAGIC_KEY, init_state
from . import _build

COUNTS = _build.Counts()
SMS = 132                   # H100 SXM streaming multiprocessors
SCHEDULERS = 4              # warp schedulers per SM: one hashing warp each
MAX_ROWS_PER_WARP = 8       # 16 lanes; 8-byte reads of 8 rows hit distinct banks
STAGES = 4                  # ring stages per row (csrc/hh256.cu kStages)
TILE = 2048                 # bytes of a row per stage, at most
SMEM_BUDGET = 200 * 1024    # shared memory one block may take
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


# -- plain version -----------------------------------------------------------

def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _mul32(a, b):
    """Full 32x32 -> 64 product of u32 limbs as (hi, lo)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & _M16) + (p10 & _M16)
    lo = (p00 & _M16) | ((mid << 16) & _M32)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _M32
    return hi, lo


@functools.lru_cache(maxsize=None)
def _zipper_perm() -> tuple[int, ...]:
    """ZipperMerge of a lane pair as a byte permutation: byte t of
    (add0 || add1) is byte perm[t] of (v0 || v1), little-endian."""
    m64 = (1 << 64) - 1
    v0 = int.from_bytes(bytes(range(1, 9)), "little")
    v1 = int.from_bytes(bytes(range(9, 17)), "little")
    add0 = ((((v0 & 0xFF000000) | (v1 & 0xFF00000000)) >> 24)
            | (((v0 & 0xFF0000000000) | (v1 & 0xFF000000000000)) >> 16)
            | (v0 & 0xFF0000) | ((v0 & 0xFF00) << 32)
            | ((v1 & 0xFF00000000000000) >> 8) | ((v0 << 56) & m64))
    add1 = ((((v1 & 0xFF000000) | (v0 & 0xFF00000000)) >> 24)
            | (v1 & 0xFF0000) | ((v1 & 0xFF0000000000) >> 16)
            | ((v1 & 0xFF00) << 24) | ((v0 & 0xFF000000000000) >> 8)
            | ((v1 & 0xFF) << 48) | (v0 & 0xFF00000000000000))
    perm = tuple(b - 1 for b in add0.to_bytes(8, "little")
                 + add1.to_bytes(8, "little"))
    assert sorted(perm) == list(range(16))
    return perm


def _zip_add(dh, dl, sh, sl, shifts, perm):
    """d += ZipperMerge(s) on lane pairs (0, 1) and (2, 3)."""
    R = sh.shape[0]
    b = torch.cat([(sl[..., None] >> shifts) & 0xFF,
                   (sh[..., None] >> shifts) & 0xFF], dim=-1)   # (R, 4, 8)
    z = b.reshape(R, 2, 16)[..., perm].reshape(R, 4, 8)
    zl = (z[..., :4] << shifts).sum(-1)
    zh = (z[..., 4:] << shifts).sum(-1)
    return _add64(dh, dl, zh, zl)


def _update(st, lh, ll, shifts, perm):
    v0h, v0l, v1h, v1l, m0h, m0l, m1h, m1l = st
    v1h, v1l = _add64(v1h, v1l, *_add64(m0h, m0l, lh, ll))
    ph, pl = _mul32(v1l, v0h)
    m0h, m0l = m0h ^ ph, m0l ^ pl
    v0h, v0l = _add64(v0h, v0l, m1h, m1l)
    ph, pl = _mul32(v0l, v1h)
    m1h, m1l = m1h ^ ph, m1l ^ pl
    v0h, v0l = _zip_add(v0h, v0l, v1h, v1l, shifts, perm)
    v1h, v1l = _zip_add(v1h, v1l, v0h, v0l, shifts, perm)
    return (v0h, v0l, v1h, v1l, m0h, m0l, m1h, m1l)


def _words(packets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 32) bytes -> (hi, lo) limbs (..., 4) of the 4 LE u64 lanes."""
    b = packets.to(torch.int64).reshape(*packets.shape[:-1], 8, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return w[..., 1::2], w[..., 0::2]


def hh256_batch_ref(blocks: torch.Tensor, key: bytes = MAGIC_KEY,
                 out_bytes: int = 32) -> torch.Tensor:
    """Plain version of Kernel B: the HighwayHash-256 of each row as
    little-endian bytes, or with ``out_bytes=8`` its HighwayHash-64."""
    COUNTS.add_plain()
    return hh_plain(blocks, key, out_bytes)


def hh_plain(blocks: torch.Tensor, key: bytes = MAGIC_KEY,
             out_bytes: int = 32) -> torch.Tensor:
    """``hh256_batch_ref`` without the count, for plain versions of other
    kernels that contain this hash."""
    lead, n = tuple(blocks.shape[:-1]), blocks.shape[-1]
    rows = blocks.reshape(math.prod(lead), n)
    R, dev = rows.shape[0], rows.device
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=dev)
    perm = torch.tensor(_zipper_perm(), device=dev)
    st = []
    for word in init_state(key):          # v0, v1, mul0, mul1
        for part in (32, 0):               # hi, lo
            t = torch.tensor([(x >> part) & _M32 for x in word],
                             dtype=torch.int64, device=dev)
            st.append(t.expand(R, 4).clone())
    st = tuple(st)
    P, rem = divmod(n, 32)
    if P:
        hi, lo = _words(rows[:, :P * 32].reshape(R, P, 32))
        for p in range(P):
            st = _update(st, hi[:, p], lo[:, p], shifts, perm)
    if rem:
        v0h, v0l, v1h, v1l, m0h, m0l, m1h, m1l = st
        v0h, v0l = _add64(v0h, v0l, torch.full_like(v0h, rem),
                          torch.full_like(v0l, rem))
        v1h = ((v1h << rem) | (v1h >> (32 - rem))) & _M32
        v1l = ((v1l << rem) | (v1l >> (32 - rem))) & _M32
        tail = rows[:, P * 32:]
        packet = torch.zeros((R, 32), dtype=torch.uint8, device=dev)
        mod4, off = rem & 3, rem & ~3
        packet[:, :off] = tail[:, :off]
        if rem & 16:
            packet[:, 28:32] = tail[:, off + mod4 - 4:off + mod4]
        elif mod4:
            packet[:, 16] = tail[:, off]
            packet[:, 17] = tail[:, off + (mod4 >> 1)]
            packet[:, 18] = tail[:, off + mod4 - 1]
        st = _update((v0h, v0l, v1h, v1l, m0h, m0l, m1h, m1l),
                     *_words(packet), shifts, perm)
    rot = [2, 3, 0, 1]
    for _ in range(10 if out_bytes == 32 else 4):
        st = _update(st, st[1][:, rot], st[0][:, rot], shifts, perm)
    v0h, v0l, v1h, v1l, m0h, m0l, m1h, m1l = st
    if out_bytes == 8:
        h = _add64(*_add64(v0h[:, 0], v0l[:, 0], v1h[:, 0], v1l[:, 0]),
                   *_add64(m0h[:, 0], m0l[:, 0], m1h[:, 0], m1l[:, 0]))
        words = torch.stack([h[1], h[0]], dim=-1)
    else:
        s10 = _add64(v0h, v0l, m0h, m0l)
        s32 = _add64(v1h, v1l, m1h, m1l)
        words = torch.stack(
            _modred(s32, s10, 1, 0) + _modred(s32, s10, 3, 2), dim=-1)
    out = (words[..., None] >> shifts) & 0xFF
    return out.to(torch.uint8).reshape(*lead, out_bytes)


def _modred(s32, s10, hi_lane: int, lo_lane: int):
    """The 256-bit modular reduction of one lane pair, as LE u32 words
    (m0 lo, m0 hi, m1 lo, m1 hi)."""
    a3h, a3l = s32[0][:, hi_lane] & 0x3FFFFFFF, s32[1][:, hi_lane]
    a2h, a2l = s32[0][:, lo_lane], s32[1][:, lo_lane]
    m1h, m1l = s10[0][:, hi_lane], s10[1][:, hi_lane]
    m0h, m0l = s10[0][:, lo_lane], s10[1][:, lo_lane]
    for s in (1, 2):
        m1h = m1h ^ (((a3h << s) | (a3l >> (32 - s))) & _M32)
        m1l = m1l ^ (((a3l << s) & _M32) | (a2h >> (32 - s)))
        m0h = m0h ^ (((a2h << s) | (a2l >> (32 - s))) & _M32)
        m0l = m0l ^ ((a2l << s) & _M32)
    return [m0l, m0h, m1l, m1h]


# -- kernel ------------------------------------------------------------------

def plan(rows: int, n: int) -> dict:
    """Launch geometry of Kernel B for ``rows`` rows of ``n`` bytes: two
    lanes per row; as few rows per warp as fill one hashing warp per
    scheduler of the card (at most ``MAX_ROWS_PER_WARP``); at most
    ``SCHEDULERS`` warps per block, so a block's warps issue on distinct
    schedulers; a ring of ``STAGES`` stages of ``tile`` bytes per row,
    rows ``pitch`` = tile + 16 bytes apart (16 mod 128, tile a multiple
    of 128).  ``smem`` is the block's shared memory as the kernel
    computes it."""
    if rows < 1 or n < 0:
        raise ValueError(f"degenerate batch ({rows}, {n})")
    rpw = min(MAX_ROWS_PER_WARP, max(1, -(-rows // (SMS * SCHEDULERS))))
    warps = min(SCHEDULERS, -(-rows // (SMS * rpw)))
    per_block = warps * rpw
    tile = min(TILE, max(128, -(-n // 128) * 128))
    while per_block * STAGES * (tile + 16) + 16 > SMEM_BUDGET:
        tile = max(128, tile // 256 * 128)
    pitch = tile + 16
    return {"rows_per_warp": rpw, "warps": warps, "threads": 32 * warps,
            "rows_per_block": per_block, "blocks": -(-rows // per_block),
            "stages": STAGES, "tile": tile, "pitch": pitch,
            "smem": warps * rpw * STAGES * pitch + 16}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("hh256").mt_hh_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(blocks: torch.Tensor, key: bytes, out: torch.Tensor) -> None:
    grouped = blocks if blocks.ndim == 3 else blocks[None]    # (G, R, n)
    G, R, n = grouped.shape
    if G * R == 0:
        return
    p = plan(G * R, n)
    fn = _kernel()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        COUNTS.add_launch()
        rc = fn(grouped.data_ptr(), grouped.stride(0), grouped.stride(1), R,
                G * R, n, *struct.unpack("<4Q", key), out.data_ptr(),
                out.shape[-1], p["rows_per_warp"], p["warps"], p["tile"],
                p["stages"], stream)
    _build.check(rc, "hh256")


def _hash(blocks: torch.Tensor, key: bytes, out_bytes: int) -> torch.Tensor:
    if not isinstance(blocks, torch.Tensor) or blocks.dtype != torch.uint8:
        raise TypeError("blocks must be a uint8 tensor")
    if blocks.ndim not in (2, 3):
        raise ValueError(f"blocks must be (B, n) or (G, R, n), got "
                         f"{tuple(blocks.shape)}")
    if len(key) != 32:
        raise ValueError("HighwayHash keys are 32 bytes")
    if blocks.device.type == "cpu":
        return hh256_batch_ref(blocks, key, out_bytes)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.shape[-1] > 1 and blocks.stride(-1) != 1:
        raise ValueError("the byte axis must be dense")
    out = torch.empty((*blocks.shape[:-1], out_bytes), dtype=torch.uint8,
                      device=blocks.device)
    _launch(blocks, key, out)
    return out


def hh256_batch(blocks: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HighwayHash-256 of every row: (..., n) uint8 -> (..., 32) uint8."""
    return _hash(blocks, key, 32)


def hh64_batch(blocks: torch.Tensor, key: bytes) -> torch.Tensor:
    """HighwayHash-64 of every row: (..., n) uint8 -> (..., 8) uint8
    (little-endian u64)."""
    return _hash(blocks, key, 8)

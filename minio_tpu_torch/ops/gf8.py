"""GF(2^8) arithmetic, Reed-Solomon matrices and shard math (host, numpy).

The port's own copy of what the erasure path needs from the field
(reference: klauspost/reedsolomon as used by cmd/erasure-coding.go):

  * field GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d),
    generator 2;
  * the systematic encode matrix: a Vandermonde matrix multiplied by the
    inverse of its top k x k square;
  * ``Split`` padding and the ShardSize / ShardFileSize / ShardFileOffset
    math of cmd/erasure-coding.go:115-143.

The matrices must equal ``minio_tpu.ops.gf8``'s for every geometry, so
drives written by either package decode in the other.
"""

from __future__ import annotations

import functools

import numpy as np

_POLY = 0x11D


class ReconstructError(ValueError):
    """Too few shards to reconstruct (reedsolomon.ErrTooFewShards)."""


def _build_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """exp (doubled to 512 so exp[log a + log b] needs no reduction),
    log (log[0] = -255 sentinel) and the full 256 x 256 product table."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    exp[510:] = exp[:2]
    log[0] = -255
    mul = np.zeros((256, 256), dtype=np.uint8)
    for i in range(1, 256):
        mul[i, 1:] = exp[log[i] + log[1:]]
    return exp, log, mul


GF_EXP, GF_LOG, GF_MUL = _build_tables()
GF_INV = np.zeros(256, dtype=np.uint8)
GF_INV[1:] = GF_EXP[255 - GF_LOG[1:]]


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(2^8) (klauspost galExp)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF matrix product (r, k) x (k, c) -> (r, c), XOR-accumulated."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    r, k = A.shape
    if B.shape[0] != k:
        raise ValueError(f"inner dimensions differ: {A.shape} x {B.shape}")
    out = np.zeros((r, B.shape[1]), dtype=np.uint8)
    for i in range(k):
        out ^= GF_MUL[A[:, i][:, None], B[i][None, :]]
    return out


def gf_mat_inv(M: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix (Gauss-Jordan); ValueError when
    singular."""
    M = np.asarray(M, dtype=np.uint8)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError(f"not square: {M.shape}")
    aug = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.nonzero(aug[col:, col])[0]
        if nz.size == 0:
            raise ValueError("singular matrix")
        pivot = col + int(nz[0])
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = GF_MUL[GF_INV[aug[col, col]], aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= GF_MUL[aug[r, col], aug[col]]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def rs_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic encode matrix (total x data): vm @ inv(vm[:k, :k]) with
    vm[r, c] = r**c.  Top k rows are the identity."""
    vm = np.array([[gf_exp(r, c) for c in range(data_shards)]
                   for r in range(total_shards)], dtype=np.uint8)
    M = gf_matmul(vm, gf_mat_inv(vm[:data_shards, :data_shards]))
    M.setflags(write=False)
    return M


@functools.lru_cache(maxsize=None)
def _companion() -> np.ndarray:
    """(256, 8, 8): the GF(2) bit matrix of multiplication by c, bits
    LSB-first (column j = bits of c * x^j)."""
    bits = (GF_MUL[:, 1 << np.arange(8)][:, None, :]
            >> np.arange(8)[None, :, None]) & 1
    return bits.astype(np.uint8)


def nibble_tables(M: np.ndarray) -> np.ndarray:
    """Split-nibble tables of the (r, k) coefficients as Kernels A and C
    read them (csrc/gf8_nibble.cuh): (k, r4, 32) uint8, data row major,
    ``[c * i for i < 16]`` then ``[c * (i << 4) for i < 16]`` for
    coefficient c, so that c * x = lo[x & 15] ^ hi[x >> 4]; output rows
    padded with zero tables to r4, a multiple of 4 (the output rows of one
    pass of the product)."""
    r, k = M.shape
    c = M.T[..., None]                                       # (k, r, 1)
    i = np.arange(16)
    out = np.zeros((k, -(-r // 4) * 4, 32), dtype=np.uint8)
    out[:, :r] = np.concatenate([GF_MUL[c, i], GF_MUL[c, i << 4]], axis=-1)
    return out


def gf2_expand(M: np.ndarray) -> np.ndarray:
    """(r, k) GF(2^8) coefficients -> (8r, 8k) GF(2) matrix, shard-major:
    out_bits[8i+b] = sum_j,b' E[8i+b, 8j+b'] in_bits[8j+b'] (mod 2)."""
    M = np.asarray(M, dtype=np.uint8)
    r, k = M.shape
    return _companion()[M].transpose(0, 2, 1, 3).reshape(8 * r, 8 * k)


# -- shard math (cmd/erasure-coding.go:115-143) -------------------------------

def ceil_frac(numerator: int, denominator: int) -> int:
    """ceilFrac (cmd/utils.go:613-628): Go semantics, zero denominator
    gives 0, division truncates toward zero."""
    if denominator == 0:
        return 0
    if denominator < 0:
        numerator, denominator = -numerator, -denominator
    ceil = abs(numerator) // denominator
    if numerator < 0:
        ceil = -ceil
    if numerator > 0 and numerator % denominator != 0:
        ceil += 1
    return ceil


def shard_size(block_size: int, data_blocks: int) -> int:
    return ceil_frac(block_size, data_blocks)


def shard_file_size(block_size: int, data_blocks: int,
                    total_length: int) -> int:
    if total_length == 0:
        return 0
    if total_length == -1:
        return -1
    num_shards, last_block = divmod(total_length, block_size)
    return num_shards * shard_size(block_size, data_blocks) \
        + ceil_frac(last_block, data_blocks)


def shard_file_offset(block_size: int, data_blocks: int, start_offset: int,
                      length: int, total_length: int) -> int:
    ssize = shard_size(block_size, data_blocks)
    sfsize = shard_file_size(block_size, data_blocks, total_length)
    till = ((start_offset + length) // block_size) * ssize + ssize
    return min(till, sfsize)


def split(data, data_shards: int) -> np.ndarray:
    """reedsolomon Split: (k, ceil(len/k)) data shards, zero-padded tail;
    ValueError on empty input (ErrShortData)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else data.astype(np.uint8, copy=False).ravel()
    if buf.size == 0:
        raise ValueError("short data")
    per_shard = ceil_frac(buf.size, data_shards)
    out = np.zeros(data_shards * per_shard, dtype=np.uint8)
    out[:buf.size] = buf
    return out.reshape(data_shards, per_shard)

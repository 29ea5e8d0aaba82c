"""Reed-Solomon GF(2^8) matrix apply on tensors (Kernel A and its plain
version), and the encode/decode/reconstruct functions built on it.

Counterpart of ``minio_tpu/ops/rs_kernels.py`` plus ``rs_pallas.py``.
``apply_matrix(M, shards)`` computes ``out[b] = M (GF) @ shards[b]`` for a
batch of stripes.  A CUDA tensor launches ``csrc/gf8_apply.cu`` with the
geometry of ``plan`` and the split-nibble tables of ``device_tables``; a CPU
tensor runs ``gf_apply_ref``, the torch form of ``rs_kernels._gf2_apply``:
bytes unpacked to 0/1 bit planes, multiplied by the expanded GF(2) matrix,
the sum's parity taken as XOR, and the planes packed back.  The plain
version multiplies in float32 because CUDA has no integer matmul and an
int8 ``@`` on the CPU wraps; every sum is at most 8k <= 2048, which
float32 holds exactly.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, gf8

COUNTS = _build.Counts()
MAX_SHARDS = 256
THREADS = 128               # threads of a block, at most (16 bytes each)
OUT_ROWS = 4                # output rows per pass (csrc/gf8_apply.cu kRT)
SM_SMEM = 233472            # shared memory of one H100 SM
BLOCK_SMEM_MAX = 232448     # of one block, opted in
BLOCK_RESERVED = 1024       # the runtime's own per block
# two blocks on an SM, so one block's staging overlaps another's product
SMEM_BUDGET = SM_SMEM // 2 - BLOCK_RESERVED


def smem_bytes(k: int, tile: int) -> int:
    """Shared memory of one block (``smem_bytes`` of csrc/gf8_apply.cu):
    one pass's split-nibble tables, ``OUT_ROWS`` output rows of ``tile``
    + 16 bytes and k staged input rows of ``tile`` + 32 bytes."""
    return k * OUT_ROWS * 32 + OUT_ROWS * (tile + 16) + k * (tile + 32)


def plan(B: int, k: int, r: int, n: int) -> dict:
    """Launch geometry of Kernel A for a (B, k, n) batch and r output
    rows: one block per ``tile`` bytes of columns and stripe, ``threads``
    threads of 16 bytes each (``tile`` = 16 x ``threads``), as few as a
    narrow row needs, shrunk until the block fits ``SMEM_BUDGET`` (two
    blocks per SM).  Above k = 169 not even 32 threads fit that; they
    take one block per SM, within ``BLOCK_SMEM_MAX`` up to k = 256.
    ``blocks_per_sm`` counts what shared memory and threads allow.
    Raises ValueError on geometry the kernel cannot take."""
    if B < 1 or n < 1:
        raise ValueError(f"degenerate batch ({B}, {n})")
    if not (1 <= k <= MAX_SHARDS and 1 <= r <= MAX_SHARDS):
        raise ValueError(f"k={k}, r={r}: the kernel takes 1 to "
                         f"{MAX_SHARDS} rows of each")
    threads = min(THREADS, -(-n // 512) * 32)
    while threads > 32 and smem_bytes(k, 16 * threads) > SMEM_BUDGET:
        threads -= 32
    tile = 16 * threads
    smem = smem_bytes(k, tile)
    return {"tile": tile, "threads": threads, "smem": smem,
            "grid": (-(-n // tile), min(B, 65535)),
            "passes": -(-r // OUT_ROWS),
            "blocks_per_sm": min(SM_SMEM // (smem + BLOCK_RESERVED),
                                 2048 // threads, 32)}


@functools.lru_cache(maxsize=256)
def _device_tables(key: bytes, r: int, k: int,
                   device: torch.device) -> torch.Tensor:
    M = np.frombuffer(key, dtype=np.uint8).reshape(r, k)
    return torch.from_numpy(gf8.nibble_tables(M)).to(device)


def device_tables(M: np.ndarray, device: torch.device) -> torch.Tensor:
    """``gf8.nibble_tables(M)`` on the device, cached by content (bounded,
    since decode matrices vary with the survivor pattern); Kernels A and C
    read them."""
    return _device_tables(M.tobytes(), *M.shape, device)


def gf_apply_ref(M: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """Plain version of Kernel A: (B, k, n) uint8 -> (B, r, n) uint8."""
    COUNTS.plain += 1
    return gf_apply_plain(M, shards)


def gf_apply_plain(M: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """``gf_apply_ref`` without the count, for plain versions of other
    kernels that contain this product."""
    B, k, n = shards.shape
    r = M.shape[0]
    E = torch.from_numpy(gf8.gf2_expand(M).astype(np.float32)).to(
        shards.device)                                       # (8r, 8k)
    shifts = torch.arange(8, dtype=torch.uint8, device=shards.device)
    bits = (shards[:, :, None, :] >> shifts[None, None, :, None]) & 1
    acc = E @ bits.reshape(B, 8 * k, n).to(torch.float32)  # (B, 8r, n)
    par = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(B, r, 8, n)
    return (par << shifts[None, None, :, None]).sum(
        dim=2, dtype=torch.uint8)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gf8_apply").mt_gf8_apply
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(M: np.ndarray, shards: torch.Tensor, out: torch.Tensor) -> None:
    B, k, n = shards.shape
    r = M.shape[0]
    dev = shards.device
    p = plan(B, k, r, n)
    fn = _kernel()
    tabs = device_tables(M, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        COUNTS.launches += 1
        rc = fn(shards.data_ptr(), shards.stride(0), shards.stride(1),
                out.data_ptr(), out.stride(0), out.stride(1),
                tabs.data_ptr(), B, k, r, n, p["tile"], p["threads"],
                p["smem"], stream)
    _build.check(rc, "gf8_apply")


def apply_matrix(M, shards: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """out[b] = M (GF) @ shards[b].

    M: (r, k) uint8 GF coefficients (host).  shards: (B, k, n) or (k, n)
    uint8; the byte axis must be dense, the batch and row axes may have
    any stride.  ``out`` (optional): a (B, r, n) / (r, n) uint8 tensor on
    the same device, byte axis dense, written in place.  Returns the
    result on the shards' device."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    if M.ndim != 2 or not (1 <= M.shape[0] <= MAX_SHARDS
                           and 1 <= M.shape[1] <= MAX_SHARDS):
        raise ValueError(f"bad coefficient matrix shape {M.shape}")
    if not isinstance(shards, torch.Tensor) or shards.dtype != torch.uint8:
        raise TypeError("shards must be a uint8 tensor")
    squeeze = shards.ndim == 2
    if squeeze:
        shards = shards[None]
        out = None if out is None else out[None]
    if shards.ndim != 3 or shards.shape[1] != M.shape[1]:
        raise ValueError(f"shards {tuple(shards.shape)} do not match "
                         f"matrix {M.shape}")
    B, k, n = shards.shape
    r = M.shape[0]
    if out is None:
        out = torch.empty((B, r, n), dtype=torch.uint8, device=shards.device)
    elif (out.dtype != torch.uint8 or tuple(out.shape) != (B, r, n)
          or out.device != shards.device):
        raise ValueError(f"out must be uint8 {(B, r, n)} on {shards.device}")
    if shards.device.type == "cpu":
        out.copy_(gf_apply_ref(M, shards))
    elif shards.device.type == "cuda":
        if n > 1 and (shards.stride(2) != 1 or out.stride(2) != 1):
            raise ValueError("the byte axis must be dense")
        if B and n:
            _launch(M, shards, out)
    else:
        raise ValueError(f"unsupported device {shards.device}")
    return out[0] if squeeze else out


def encode_parity(data_shards: torch.Tensor, parity: int,
                  matrix: np.ndarray | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, k, n) or (k, n) data -> (B, m, n) / (m, n) parity."""
    k = data_shards.shape[-2]
    if matrix is None:
        matrix = gf8.rs_matrix(k, k + parity)
    return apply_matrix(np.asarray(matrix)[k:], data_shards, out)


def decode_rows(matrix: np.ndarray, data_blocks: int,
                present: list[int], wanted: list[int]) -> np.ndarray:
    """(len(wanted), k) GF rows mapping the k survivors ``present``
    (sorted shard indices) to the ``wanted`` shards, data or parity."""
    if len(present) != data_blocks:
        raise ValueError(f"need exactly {data_blocks} survivors")
    matrix = np.asarray(matrix)
    dec = gf8.gf_mat_inv(matrix[present])
    rows = [dec[w] if w < data_blocks
            else gf8.gf_matmul(matrix[w][None, :], dec)[0] for w in wanted]
    return np.stack(rows).astype(np.uint8)


def reconstruct(shards: list, data_blocks: int, parity_blocks: int,
                data_only: bool = False,
                matrix: np.ndarray | None = None,
                apply=None) -> list:
    """Rebuild the missing (None or empty) shards of one stripe.

    ``shards``: k+m entries, present ones equal-length 1-D uint8 tensors
    on one device.  Returns a new list with the missing data shards (and
    parity shards unless ``data_only``) filled in.  ``apply(rows,
    shards)`` is the GF product (default ``apply_matrix``)."""
    total = data_blocks + parity_blocks
    if len(shards) != total:
        raise ValueError("wrong shard count")
    present = [i for i, s in enumerate(shards)
               if s is not None and len(s) > 0]
    if len(present) < data_blocks:
        raise gf8.ReconstructError(
            f"need {data_blocks} shards, have {len(present)}")
    if matrix is None:
        matrix = gf8.rs_matrix(data_blocks, total)
    limit = data_blocks if data_only else total
    missing = [i for i in range(limit)
               if shards[i] is None or len(shards[i]) == 0]
    out = list(shards)
    if not missing:
        return out
    use = present[:data_blocks]
    rows = decode_rows(matrix, data_blocks, use, missing)
    rebuilt = (apply or apply_matrix)(
        rows, torch.stack([shards[i] for i in use]))
    for j, i in enumerate(missing):
        out[i] = rebuilt[j]
    return out


def reconstruct_batch(shards: torch.Tensor, present: list[int],
                      wanted: list[int], data_blocks: int,
                      parity_blocks: int,
                      matrix: np.ndarray | None = None) -> torch.Tensor:
    """(B, k, n) survivors (rows ordered as ``present``), the same missing
    pattern in every stripe -> (B, len(wanted), n), one launch."""
    if matrix is None:
        matrix = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)
    rows = decode_rows(matrix, data_blocks, list(present), list(wanted))
    return apply_matrix(rows, shards)

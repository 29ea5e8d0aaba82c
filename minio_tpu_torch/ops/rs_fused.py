"""Reed-Solomon encode and HighwayHash-256 in one pass (Kernel C and its
plain version).

Counterpart of ``minio_tpu/ops/rs_fused.py``.  ``encode_hash_device(M,
shards)`` gives, for a (B, k, n) stripe batch, the parity ``M (GF) @
shards[b]`` and the bitrot HighwayHash-256 digest of every data row and,
with ``hash_parity``, every parity row.  A CUDA tensor launches
``csrc/rs_fused.cu``, which reads the data once and writes the parity and
the finished digests; a CPU tensor runs ``encode_hash_ref``, Kernel A's
plain product followed by Kernel B's plain hash.

The TPU tile plan (stripes packed into (S, 128) hash lanes) does not carry
over: ``plan`` sizes the port's own pipeline, one thread block per stripe
walking the width in ``tile``-byte stages of a shared-memory ring.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from ..hashing.highwayhash import MAGIC_KEY
from . import _build, gf8, rs_kernels
from .gf8 import nibble_tables  # noqa: F401  (re-exported: its old home)
from .hh import hh_plain

COUNTS = _build.Counts()
MAX_ROWS = 256              # k + ro
TILE_MAX = 3072             # bytes of width per stage
STAGES = 4                  # ring slots (csrc/rs_fused.cu kStages)
SMEM_BUDGET = 200 * 1024    # shared memory one block may take
HASH_ROWS = 16              # rows per hashing warp, two lanes each
_BARS, _SLACK = 128, 16     # mbarrier bytes, read slack past the ring


def smem_bytes(k: int, ro: int, tile: int) -> int:
    """Shared memory of one block (``smem_bytes`` of csrc/rs_fused.cu):
    the mbarriers and ``STAGES`` slots of k data and ro parity rows,
    ``tile`` + 16 bytes apart."""
    return _BARS + STAGES * (k + ro) * (tile + 16) + _SLACK


def plan(B: int, k: int, ro: int, n: int, hash_parity: bool = True) -> dict:
    """Pipeline plan for a (B, k, n) stripe batch with ro parity rows: the
    stage width ``tile`` (a multiple of 128, at most ``TILE_MAX``, shrunk
    until the block fits ``SMEM_BUDGET``), the rows hashed per stripe, the
    hashing warps and the block's threads (producer, six product warps,
    hashing warps).  Raises ValueError on geometry the kernel cannot
    take."""
    if B < 1 or n < 1:
        raise ValueError(f"degenerate batch ({B}, {n})")
    if k < 1 or ro < 1 or k + ro > MAX_ROWS:
        raise ValueError(f"{k}+{ro} shards per stripe: the kernel takes "
                         f"1 <= k, ro and k + ro <= {MAX_ROWS}")
    tile = min(TILE_MAX, -(-n // 128) * 128)
    while smem_bytes(k, ro, tile) > SMEM_BUDGET:
        tile -= 128
    R = k + (ro if hash_parity else 0)
    hash_warps = -(-R // HASH_ROWS)
    return {"R": R, "tile": tile, "stages": STAGES, "pitch": tile + 16,
            "hash_warps": hash_warps,
            "threads": 32 * (7 + hash_warps),
            "smem": smem_bytes(k, ro, tile)}


def encode_hash_ref(M: np.ndarray, shards: torch.Tensor, *,
                    n_real: int | None = None,
                    hash_parity: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of Kernel C: Kernel A's plain product, then Kernel
    B's plain hash of the first ``n_real`` bytes of the data rows (and
    the parity rows with ``hash_parity``).  Returns (parity (B, ro, n),
    digests (B, R, 32))."""
    COUNTS.plain += 1
    n_real = shards.shape[-1] if n_real is None else n_real
    parity = rs_kernels.gf_apply_plain(M, shards)
    rows = torch.cat([shards, parity], dim=1) if hash_parity else shards
    return parity, hh_plain(rows[..., :n_real])


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("rs_fused").mt_rs_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(M: np.ndarray, shards: torch.Tensor, parity: torch.Tensor,
            digests: torch.Tensor, n_real: int, hash_parity: bool,
            p: dict) -> None:
    B, k, n = shards.shape
    ro = M.shape[0]
    dev = shards.device
    fn = _kernel()
    tabs = rs_kernels.device_tables(M, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        COUNTS.launches += 1
        rc = fn(shards.data_ptr(), shards.stride(0), shards.stride(1),
                parity.data_ptr(), parity.stride(0), parity.stride(1),
                tabs.data_ptr(), digests.data_ptr(), B, k, ro,
                int(hash_parity), n, n_real, p["tile"], p["stages"],
                *struct.unpack("<4Q", MAGIC_KEY), stream)
    _build.check(rc, "rs_fused")


def encode_hash_device(M, shards: torch.Tensor, *, n_real: int | None = None,
                       hash_parity: bool = True,
                       out_parity: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parity and bitrot digests of a stripe batch in one pass.

    M: (ro, k) uint8 GF coefficients (host).  shards: (B, k, n) uint8;
    the byte axis must be dense, the batch and row axes may have any
    stride.  Digests cover the first ``n_real`` bytes of every row
    (default n).  ``out_parity`` (optional): a (B, ro, n) uint8 tensor on
    the same device, byte axis dense, written in place.  Returns (parity
    (B, ro, n), digests (B, R, 32)) on the shards' device, R = k + ro
    with ``hash_parity``, else k; data rows first."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    if not isinstance(shards, torch.Tensor) or shards.dtype != torch.uint8:
        raise TypeError("shards must be a uint8 tensor")
    if M.ndim != 2 or shards.ndim != 3 or shards.shape[1] != M.shape[1]:
        raise ValueError(f"shards {tuple(shards.shape)} do not match "
                         f"matrix {M.shape}")
    B, k, n = shards.shape
    ro = M.shape[0]
    n_real = n if n_real is None else int(n_real)
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real {n_real} outside [0, {n}]")
    p = plan(B, k, ro, n, hash_parity)
    dev = shards.device
    if out_parity is None:
        out_parity = torch.empty((B, ro, n), dtype=torch.uint8, device=dev)
    elif (out_parity.dtype != torch.uint8
          or tuple(out_parity.shape) != (B, ro, n)
          or out_parity.device != dev):
        raise ValueError(f"out_parity must be uint8 {(B, ro, n)} on {dev}")
    if dev.type == "cpu":
        parity, digests = encode_hash_ref(M, shards, n_real=n_real,
                                          hash_parity=hash_parity)
        out_parity.copy_(parity)
        return out_parity, digests
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > 1 and (shards.stride(2) != 1 or out_parity.stride(2) != 1):
        raise ValueError("the byte axis must be dense")
    digests = torch.empty((B, p["R"], 32), dtype=torch.uint8, device=dev)
    _launch(M, shards, out_parity, digests, n_real, hash_parity, p)
    return out_parity, digests


def encode_with_bitrot_fused(data_blocks: int, parity_blocks: int, blocks,
                             matrix: np.ndarray | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(parity (B, m, n), digests (B, k+m, 32), data rows first) of a
    (B, k, n) stripe batch through one pass.  ``blocks``: a uint8 tensor,
    or a host array (run on the CPU)."""
    if not isinstance(blocks, torch.Tensor):
        blocks = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8))
    if matrix is None:
        matrix = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)
    return encode_hash_device(np.asarray(matrix)[data_blocks:], blocks,
                              hash_parity=True)

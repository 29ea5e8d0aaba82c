"""Erasure codec — the port's counterpart of MinIO's ``Erasure``
(cmd/erasure-coding.go:28-143, ``minio_tpu/ops/codec.py``).

One (k, m, blockSize) geometry on one device.  Shards are uint8 tensors on
that device; the GF(2^8) work runs through ``rs_kernels.apply_matrix``
(Kernel A on a card, its plain version on the CPU).  The shard layout,
padding and matrix are those of klauspost/reedsolomon's defaults, so the
shard files equal ``minio_tpu``'s byte for byte.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve
from . import gf8, rs_kernels

MAX_SHARDS = 256  # data + parity <= 256 (cmd/erasure-coding.go:41)


class ErasureError(ValueError):
    pass


def as_tensor(data, device: torch.device) -> torch.Tensor:
    """Bytes-like or tensor -> flat uint8 tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).to(device)
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    with warnings.catch_warnings():
        # read-only source: torch warns, but nothing writes through it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(buf).to(device)


class Erasure:
    """Erasure coding for one (k, m, block size) geometry."""

    def __init__(self, data_blocks: int, parity_blocks: int,
                 block_size: int, device: str | torch.device = "cuda"):
        if data_blocks <= 0 or parity_blocks <= 0:
            raise ErasureError("invalid shard number")
        if data_blocks + parity_blocks > MAX_SHARDS:
            raise ErasureError("max shard number exceeded")
        self.data_blocks = data_blocks
        self.parity_blocks = parity_blocks
        self.block_size = int(block_size)
        self.device = resolve(device)
        self.matrix = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)

    # -- coding ------------------------------------------------------------

    def encode_data(self, data) -> list[torch.Tensor]:
        """EncodeData (cmd/erasure-coding.go:70): split + encode one block
        into k + m shards; empty input gives k + m empty shards."""
        buf = as_tensor(data, self.device)
        k, m = self.data_blocks, self.parity_blocks
        if buf.numel() == 0:
            return [buf.new_empty(0) for _ in range(k + m)]
        per = gf8.ceil_frac(buf.numel(), k)
        shards = buf.new_zeros((k + m, per))
        shards[:k].view(-1)[:buf.numel()] = buf
        rs_kernels.encode_parity(shards[:k], m, self.matrix, out=shards[k:])
        return list(shards)

    def encode_object(self, data) -> torch.Tensor:
        """Encode a whole object into its k + m shard files.

        Returns (k + m, L) uint8 on the codec's device; row i is the
        concatenation of shard i of every block, as block-by-block
        encode_data writes it (cmd/erasure-encode.go:80-107).  All full
        blocks go through one Kernel A launch that reads the data rows and
        writes the parity rows in place; the short last block takes one
        more."""
        buf = as_tensor(data, self.device)
        k, m = self.data_blocks, self.parity_blocks
        total = buf.numel()
        bs, ss = self.block_size, self.shard_size()
        nfull, tail = divmod(total, bs)
        t_ss = gf8.ceil_frac(tail, k)
        L = nfull * ss + t_ss
        out = buf.new_zeros((k + m, L))
        if nfull:
            # (nfull, k+m, ss) view of the shard files: stripe b, shard i
            stripes = out[:, :nfull * ss].unflatten(1, (nfull, ss)) \
                .transpose(0, 1)
            if bs == k * ss:
                stripes[:, :k] = buf[:nfull * bs].view(nfull, k, ss)
            else:
                padded = buf.new_zeros((nfull, k * ss))
                padded[:, :bs] = buf[:nfull * bs].view(nfull, bs)
                stripes[:, :k] = padded.view(nfull, k, ss)
            rs_kernels.encode_parity(stripes[:, :k], m, self.matrix,
                                     out=stripes[:, k:])
        if tail:
            tstripe = out[:, nfull * ss:]
            flat = buf.new_zeros(k * t_ss)
            flat[:tail] = buf[nfull * bs:]
            tstripe[:k] = flat.view(k, t_ss)
            rs_kernels.encode_parity(tstripe[:k], m, self.matrix,
                                     out=tstripe[k:])
        return out

    def _reconstruct(self, shards, data_only: bool) -> list:
        lens = {len(s) for s in shards if s is not None and len(s) > 0}
        if len(lens) > 1:
            raise ErasureError("shard size mismatch")
        return rs_kernels.reconstruct(shards, self.data_blocks,
                                      self.parity_blocks,
                                      data_only=data_only,
                                      matrix=self.matrix)

    def decode_data_blocks(self, shards: list) -> list:
        """DecodeDataBlocks (cmd/erasure-coding.go:89): rebuild the data
        shards only.  A no-op when nothing is missing; fails when fewer
        than k shards survive, including when all are empty."""
        missing = sum(1 for s in shards if s is None or len(s) == 0)
        if missing == 0:
            return list(shards)
        return self._reconstruct(shards, data_only=True)

    def decode_data_and_parity_blocks(self, shards: list) -> list:
        """DecodeDataAndParityBlocks (cmd/erasure-coding.go:106)."""
        return self._reconstruct(shards, data_only=False)

    # -- shard math (cmd/erasure-coding.go:115-143) ------------------------

    def shard_size(self) -> int:
        return gf8.shard_size(self.block_size, self.data_blocks)

    def shard_file_size(self, total_length: int) -> int:
        return gf8.shard_file_size(self.block_size, self.data_blocks,
                                   total_length)

    def shard_file_offset(self, start_offset: int, length: int,
                          total_length: int) -> int:
        return gf8.shard_file_offset(self.block_size, self.data_blocks,
                                     start_offset, length, total_length)

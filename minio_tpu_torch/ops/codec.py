"""Erasure codec — the port's counterpart of MinIO's ``Erasure``
(cmd/erasure-coding.go:28-143, ``minio_tpu/ops/codec.py``).

One (k, m, blockSize) geometry on one device, or on a device mesh.
Shards are uint8 tensors on that device; the GF(2^8) work runs through
``apply_matrix``: ``rs_kernels.apply_matrix`` (Kernel A on a card, its
plain version on the CPU), or with a mesh ``rs_mesh.apply_matrix`` (the
counterpart of ``backend="mesh"``).  The device, never a backend string,
decides kernel against plain version.  The shard layout, padding and
matrix are those of klauspost/reedsolomon's defaults, so the shard files
equal ``minio_tpu``'s byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, resolve
from ..parallel.mesh import Mesh
from . import gf8, rs_kernels, rs_mesh

MAX_SHARDS = 256  # data + parity <= 256 (cmd/erasure-coding.go:41)


class ErasureError(ValueError):
    pass


class Erasure:
    """Erasure coding for one (k, m, block size) geometry."""

    def __init__(self, data_blocks: int, parity_blocks: int,
                 block_size: int, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        """``mesh``: run on that device mesh (the mesh data plane); the
        codec's device is then the mesh's and ``device`` is not read."""
        if data_blocks <= 0 or parity_blocks <= 0:
            raise ErasureError("invalid shard number")
        if data_blocks + parity_blocks > MAX_SHARDS:
            raise ErasureError("max shard number exceeded")
        self.data_blocks = data_blocks
        self.parity_blocks = parity_blocks
        self.block_size = int(block_size)
        self.mesh = mesh
        self.device = (rs_mesh.mesh_device(mesh) if mesh is not None
                       else resolve(device))
        self.matrix = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)

    # -- the GF(2^8) engine --------------------------------------------------

    def apply_matrix(self, rows: np.ndarray, shards: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """out[b] = rows (GF) @ shards[b] on the codec's device or mesh."""
        if self.mesh is not None:
            return rs_mesh.apply_matrix(rows, shards, out, mesh=self.mesh)
        return rs_kernels.apply_matrix(rows, shards, out)

    def _encode_parity(self, data: torch.Tensor, out: torch.Tensor) -> None:
        self.apply_matrix(np.asarray(self.matrix)[self.data_blocks:], data,
                          out)

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
        self._encode_parity(shards[:k], shards[k:])
        return list(shards)

    def encode_object(self, data) -> torch.Tensor:
        """Encode a whole object into its k + m shard files.

        Returns (k + m, L) uint8 on the codec's device; row i is the
        concatenation of shard i of every block, as block-by-block
        encode_data writes it (cmd/erasure-encode.go:80-107).  All full
        blocks go through one GF launch that reads the data rows and
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
            self._encode_parity(stripes[:, :k], stripes[:, k:])
        if tail:
            tstripe = out[:, nfull * ss:]
            flat = buf.new_zeros(k * t_ss)
            flat[:tail] = buf[nfull * bs:]
            tstripe[:k] = flat.view(k, t_ss)
            self._encode_parity(tstripe[:k], tstripe[k:])
        return out

    def _reconstruct(self, shards, data_only: bool) -> list:
        lens = {len(s) for s in shards if s is not None and len(s) > 0}
        if len(lens) > 1:
            raise ErasureError("shard size mismatch")
        return rs_kernels.reconstruct(shards, self.data_blocks,
                                      self.parity_blocks,
                                      data_only=data_only,
                                      matrix=self.matrix,
                                      apply=self.apply_matrix)

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

"""The mesh data plane: erasure coding over a device mesh
(``parallel/mesh.py``), behind the same surface as ``rs_kernels``.

Counterpart of ``minio_tpu/ops/rs_mesh.py`` on a one-device mesh, the
single-card case of that module ("a 1-device mesh is the degenerate
single-chip case").  There the GF(2^8) apply goes to Kernel A on the
mesh's device, and a PUT's parity and digests come from one Kernel C
launch per stripe batch (``rs_fused``), with the parity hashed in the
kernel because the shard axis is 1.

A mesh of more than one device raises NotImplementedError: its
collectives (a packed-byte XOR ring over NCCL) are ROADMAP Queue 1 item 9.
Every function takes ``mesh=`` and defaults to the active mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..hashing.bitrot import DIGEST_SIZE
from ..parallel import mesh as mesh_mod
from . import gf8, rs_fused, rs_kernels


def mesh_device(mesh: mesh_mod.Mesh | None = None) -> torch.device:
    """The device of a one-device mesh."""
    mesh = mesh_mod.get_active_mesh() if mesh is None else mesh
    if mesh.size != 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: only a 1 x 1 mesh runs in the port; "
            "multi-device meshes are ROADMAP Queue 1 item 9")
    return mesh.devices[0, 0]


def apply_matrix(rows: np.ndarray, shards: torch.Tensor,
                 out: torch.Tensor | None = None, *,
                 mesh: mesh_mod.Mesh | None = None) -> torch.Tensor:
    """out[b] = rows (GF) @ shards[b] on the mesh: (B, k, n) or (k, n)
    uint8, moved to the mesh's device."""
    dev = mesh_device(mesh)
    return rs_kernels.apply_matrix(rows, shards.to(dev), out)


def encode_parity(data_shards: torch.Tensor, parity: int,
                  matrix: np.ndarray | None = None, *,
                  mesh: mesh_mod.Mesh | None = None) -> torch.Tensor:
    """(B, k, n) or (k, n) data -> (B, m, n) / (m, n) parity."""
    k = data_shards.shape[-2]
    if matrix is None:
        matrix = gf8.rs_matrix(k, k + parity)
    return apply_matrix(np.asarray(matrix)[k:], data_shards, mesh=mesh)


def reconstruct(shards: list, data_blocks: int, parity_blocks: int,
                data_only: bool = False, matrix: np.ndarray | None = None,
                *, mesh: mesh_mod.Mesh | None = None) -> list:
    """Single-stripe reconstruct; the survivor logic is ``rs_kernels``',
    the product runs on the mesh."""
    return rs_kernels.reconstruct(
        shards, data_blocks, parity_blocks, data_only=data_only,
        matrix=matrix,
        apply=lambda rows, x: apply_matrix(rows, x, mesh=mesh))


def reconstruct_batch(shards: torch.Tensor, present: list[int],
                      wanted: list[int], data_blocks: int,
                      parity_blocks: int, matrix: np.ndarray | None = None,
                      *, mesh: mesh_mod.Mesh | None = None) -> torch.Tensor:
    """(B, k, n) survivors, the same missing pattern in every stripe ->
    (B, len(wanted), n), one launch on the mesh."""
    if matrix is None:
        matrix = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)
    rows = rs_kernels.decode_rows(matrix, data_blocks, list(present),
                                  list(wanted))
    return apply_matrix(rows, shards, mesh=mesh)


def encode_with_bitrot(data_blocks: int, parity_blocks: int,
                       blocks: torch.Tensor, *,
                       mesh: mesh_mod.Mesh | None = None,
                       out_parity: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(parity (B, m, n), digests (B, k+m, 32), data rows first) of a
    (B, k, n) stripe batch: one Kernel C launch, hashing the parity in
    the kernel when the shard axis is 1."""
    mesh = mesh_mod.get_active_mesh() if mesh is None else mesh
    dev = mesh_device(mesh)
    rows = gf8.rs_matrix(data_blocks, data_blocks + parity_blocks)
    return rs_fused.encode_hash_device(
        np.asarray(rows)[data_blocks:], blocks.to(dev),
        hash_parity=mesh.shape["shard"] == 1, out_parity=out_parity)


def encode_object_framed_fused(data_blocks: int, parity_blocks: int,
                               block_size: int, data, *,
                               mesh: mesh_mod.Mesh | None = None
                               ) -> torch.Tensor:
    """A whole object (or one stream batch of whole blocks and a short
    last block) -> its (k+m, framed_len) bitrot-framed shard files on the
    mesh's device: per erasure block a [32-byte HighwayHash-256 digest]
    [shard payload] frame, byte-identical to ``Erasure.encode_object``
    plus ``bitrot.frame_batch``.

    The data payloads are copied once into their frame slots; Kernel C
    then reads them in place and writes the parity payloads in place
    (strided rows of the frame tensor).  Full blocks take one launch and
    the short last block one more."""
    mesh = mesh_mod.get_active_mesh() if mesh is None else mesh
    dev = mesh_device(mesh)
    k, m = data_blocks, parity_blocks
    buf = as_tensor(data, dev)
    total = buf.numel()
    bs = block_size
    ss = gf8.shard_size(bs, k)
    nfull, tail = divmod(total, bs)
    t_ss = gf8.ceil_frac(tail, k)
    F = DIGEST_SIZE + ss
    flen = nfull * F + ((DIGEST_SIZE + t_ss) if tail else 0)
    out = buf.new_zeros((k + m, flen))
    if nfull:
        # (nfull, k+m, F) view: stripe b's frame on shard file i
        frames = out[:, :nfull * F].unflatten(1, (nfull, F)).transpose(0, 1)
        data_rows = frames[:, :k, DIGEST_SIZE:]
        if bs == k * ss:
            data_rows.copy_(buf[:nfull * bs].view(nfull, k, ss))
        else:
            padded = buf.new_zeros((nfull, k * ss))
            padded[:, :bs] = buf[:nfull * bs].view(nfull, bs)
            data_rows.copy_(padded.view(nfull, k, ss))
        _, digests = encode_with_bitrot(
            k, m, data_rows, mesh=mesh,
            out_parity=frames[:, k:, DIGEST_SIZE:])
        frames[:, :, :DIGEST_SIZE] = digests
    if tail:
        frame = out[:, nfull * F:]
        flat = buf.new_zeros(k * t_ss)
        flat[:tail] = buf[nfull * bs:]
        frame[:k, DIGEST_SIZE:] = flat.view(k, t_ss)
        _, digests = encode_with_bitrot(
            k, m, frame[None, :k, DIGEST_SIZE:], mesh=mesh,
            out_parity=frame[None, k:, DIGEST_SIZE:])
        frame[:, :DIGEST_SIZE] = digests[0]
    return out

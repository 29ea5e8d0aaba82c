"""Bitrot framing with HighwayHash256S, done for whole batches of shards.

Reference behaviour (cmd/bitrot-streaming.go, cmd/bitrot.go): a shard file
interleaves ``hash(block) || block`` for every shard-size block, the last
block possibly short; a reader checks every block's digest and fails with
errFileCorrupt on a mismatch.  Only the default streaming algorithm,
``highwayhash256S``, is in the port.

Both directions run on the shards' device in one Kernel B launch per
block width: ``frame_batch`` hashes every block of every shard of a batch
(the counterpart of ``bitrot._streaming_encode_batch_device``), and
``verify_frames`` hashes the payloads of a batch of framed shards in place
and compares them with the stored digests (GET verification and heal).
"""

from __future__ import annotations

import torch

from ..ops.gf8 import ceil_frac
from ..ops.hh import hh256_batch

HIGHWAYHASH256S = "highwayhash256S"
DIGEST_SIZE = 32


class BitrotError(IOError):
    """errFileCorrupt analog: stored digest does not match the content."""


def digest_size(algo: str = HIGHWAYHASH256S) -> int:
    if algo != HIGHWAYHASH256S:
        raise ValueError(f"unsupported bitrot algorithm {algo!r}")
    return DIGEST_SIZE


def bitrot_shard_file_size(size: int, shard_size: int,
                           algo: str = HIGHWAYHASH256S) -> int:
    """On-disk size of a framed shard file (cmd/bitrot.go:140-145)."""
    return ceil_frac(size, shard_size) * digest_size(algo) + size


def bitrot_shard_file_offset(offset: int, shard_size: int,
                             algo: str = HIGHWAYHASH256S) -> int:
    """Logical shard offset -> offset in the framed file."""
    return (offset // shard_size) * digest_size(algo) + offset


def frame_batch(shards: torch.Tensor, shard_size: int) -> torch.Tensor:
    """Frame S equal-length shard files at once.

    shards: (S, L) uint8 on any device.  Returns (S, framed_len) with
    ``hash(block) || block`` per ``shard_size`` block, the last block
    short when L is not a multiple; one hash launch for the full blocks
    and one for the short ones."""
    if shards.ndim != 2 or shards.dtype != torch.uint8:
        raise ValueError("shards must be a (S, L) uint8 tensor")
    S, L = shards.shape
    nfull, rem = divmod(L, shard_size)
    F = DIGEST_SIZE + shard_size
    head = nfull * F
    out = torch.empty((S, head + (DIGEST_SIZE + rem if rem else 0)),
                      dtype=torch.uint8, device=shards.device)
    if nfull:
        blocks = shards[:, :nfull * shard_size].unflatten(
            1, (nfull, shard_size))
        frames = out[:, :head].view(S, nfull, F)
        frames[:, :, :DIGEST_SIZE] = hh256_batch(blocks)
        frames[:, :, DIGEST_SIZE:] = blocks
    if rem:
        tail = shards[:, nfull * shard_size:]
        out[:, head:head + DIGEST_SIZE] = hh256_batch(tail)
        out[:, head + DIGEST_SIZE:] = tail
    return out


def verify_frames(framed: torch.Tensor, shard_size: int,
                  length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Check every block digest of S framed shards and extract payloads.

    framed: (S, FL) uint8, rows laid out as ``frame_batch`` writes them.
    Returns (payload (S, length) uint8, ok (S,) bool) on framed's device:
    ``ok[s]`` is False when any block of row s fails its digest.  Raises
    BitrotError when the frame layout cannot hold ``length`` payload
    bytes (the declared length comes from xl.meta and is not trusted)."""
    if framed.ndim != 2 or framed.dtype != torch.uint8:
        raise ValueError("framed must be a (S, FL) uint8 tensor")
    S, FL = framed.shape
    F = DIGEST_SIZE + shard_size
    nfull, tail = divmod(FL, F)
    if 0 < tail <= DIGEST_SIZE:
        raise BitrotError(f"torn frame: {tail} trailing bytes")
    tail_len = tail - DIGEST_SIZE if tail else 0
    if nfull * shard_size + tail_len < length:
        raise BitrotError(
            f"truncated frame: {nfull * shard_size + tail_len} payload "
            f"bytes present, {length} declared")
    ok = torch.ones(S, dtype=torch.bool, device=framed.device)
    payload = torch.empty((S, length), dtype=torch.uint8,
                          device=framed.device)
    head = nfull * F
    if nfull:
        frames = framed[:, :head].view(S, nfull, F)
        body = frames[:, :, DIGEST_SIZE:]
        ok &= (hh256_batch(body) == frames[:, :, :DIGEST_SIZE]).all(2).all(1)
        take = min(nfull * shard_size, length)
        payload[:, :take] = body.reshape(S, nfull * shard_size)[:, :take]
    if tail:
        body = framed[:, head + DIGEST_SIZE:]
        ok &= (hh256_batch(body)
               == framed[:, head:head + DIGEST_SIZE]).all(1)
        if length > nfull * shard_size:
            payload[:, nfull * shard_size:] = \
                body[:, :length - nfull * shard_size]
    return payload, ok


def verify_extract(framed: torch.Tensor, shard_size: int,
                   length: int) -> torch.Tensor:
    """Verify one whole framed shard and return its ``length`` payload
    bytes (cmd/bitrot-streaming.go ReadAt); BitrotError on a mismatch."""
    payload, ok = verify_frames(framed.reshape(1, -1), shard_size, length)
    if not bool(ok[0]):
        raise BitrotError("content hash mismatch")
    return payload[0]

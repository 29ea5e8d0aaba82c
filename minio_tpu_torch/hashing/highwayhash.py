"""HighwayHash constants for the bitrot digests (reference: cmd/bitrot.go:31).

The hashing itself runs in ``ops/hh.py``: the Hopper kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.  The port has no host
HighwayHash library.
"""

from __future__ import annotations

import struct

# cmd/bitrot.go:31 — the bitrot HighwayHash-256 key
MAGIC_KEY = (b"\x4b\xe7\x34\xfa\x8e\x23\x8a\xcd\x26\x3e\x83\xe6\xbb\x96\x85"
             b"\x52\x04\x0f\x93\x5d\xa3\x9f\x44\x14\x97\xe0\x9d\x13\x22\xde"
             b"\x36\xa0")

INIT_MUL0 = (0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0,
             0x13198A2E03707344, 0x243F6A8885A308D3)
INIT_MUL1 = (0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C,
             0xBE5466CF34E90C6C, 0x452821E638D01377)

_M64 = (1 << 64) - 1


def init_state(key: bytes = MAGIC_KEY) -> tuple[tuple[int, ...], ...]:
    """Initial (v0, v1, mul0, mul1), four u64 lanes each, for a 32-byte
    key: v0 = mul0 ^ key, v1 = mul1 ^ (key with its 32-bit halves
    swapped) — the values ``hh_kernels._init_state_np`` splits into
    limbs."""
    k = struct.unpack("<4Q", key)
    v0 = tuple(m ^ kk for m, kk in zip(INIT_MUL0, k))
    v1 = tuple(m ^ (((kk >> 32) | (kk << 32)) & _M64)
               for m, kk in zip(INIT_MUL1, k))
    return v0, v1, INIT_MUL0, INIT_MUL1

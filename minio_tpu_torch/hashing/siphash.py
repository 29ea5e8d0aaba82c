"""SipHash-2-4, the object-name -> erasure-set placement hash
(``minio_tpu/hashing/siphash.py``, cmd/erasure-sets.go:629 sipHashMod).

Pure Python and bit-identical to the reference's: placement decides
which drives hold an object, so one differing bit would read another
deployment's objects from the wrong set.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _M64


def siphash24(data: bytes | str, key: bytes) -> int:
    """SipHash-2-4 of ``data`` under a 16-byte key."""
    if isinstance(data, str):
        data = data.encode()
    k0, k1 = struct.unpack("<2Q", key)
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def rnd():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & _M64
        v1 = _rotl(v1, 13) ^ v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & _M64
        v3 = _rotl(v3, 16) ^ v2
        v0 = (v0 + v3) & _M64
        v3 = _rotl(v3, 21) ^ v0
        v2 = (v2 + v1) & _M64
        v1 = _rotl(v1, 17) ^ v2
        v2 = _rotl(v2, 32)

    n = len(data)
    end = n - (n % 8)
    for i in range(0, end, 8):
        m = struct.unpack_from("<Q", data, i)[0]
        v3 ^= m
        rnd()
        rnd()
        v0 ^= m
    b = (n << 56) & _M64
    for i in range(n % 8):
        b |= data[end + i] << (8 * i)
    v3 ^= b
    rnd()
    rnd()
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(4):
        rnd()
    return (v0 ^ v1 ^ v2 ^ v3) & _M64


def sip_hash_mod(key: str, cardinality: int, id_bytes: bytes) -> int:
    """The set index of an object name (sipHashMod); -1 without sets."""
    if cardinality <= 0:
        return -1
    return siphash24(key, id_bytes[:16]) % cardinality

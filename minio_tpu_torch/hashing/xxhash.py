"""xxHash64 (``minio_tpu/hashing/xxhash.py``, cespare/xxhash v2.1.1).

The data-update tracker's bloom filter (``background/tracker.py``)
hashes object paths with it; its bits equal the reference's, so a
persisted filter reads in either package.  Pure Python: the filter
hashes short paths, off every data path.
"""

PRIME1 = 0x9E3779B185EBCA87
PRIME2 = 0xC2B2AE3D27D4EB4F
PRIME3 = 0x165667B19E3779F9
PRIME4 = 0x85EBCA77C2B2AE63
PRIME5 = 0x27D4EB2F165667C5

_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, inp: int) -> int:
    acc = (acc + inp * PRIME2) & _M
    return (_rotl(acc, 31) * PRIME1) & _M


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * PRIME1 + PRIME4) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + PRIME1 + PRIME2) & _M
        v2 = (seed + PRIME2) & _M
        v3 = seed
        v4 = (seed - PRIME1) & _M
        while i <= n - 32:
            v1 = _round(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) +
             _rotl(v4, 18)) & _M
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + PRIME5) & _M
    h = (h + n) & _M
    while i <= n - 8:
        k = _round(0, int.from_bytes(data[i:i + 8], "little"))
        h ^= k
        h = (_rotl(h, 27) * PRIME1 + PRIME4) & _M
        i += 8
    if i <= n - 4:
        h ^= (int.from_bytes(data[i:i + 4], "little") * PRIME1) & _M
        h = (_rotl(h, 23) * PRIME2 + PRIME3) & _M
        i += 4
    while i < n:
        h ^= (data[i] * PRIME5) & _M
        h = (_rotl(h, 11) * PRIME1) & _M
        i += 1
    h ^= h >> 33
    h = (h * PRIME2) & _M
    h ^= h >> 29
    h = (h * PRIME3) & _M
    h ^= h >> 32
    return h

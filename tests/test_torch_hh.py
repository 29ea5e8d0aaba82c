"""Kernel B's plain version against minio_tpu's HighwayHash: the Pallas
kernel (interpret mode on the CPU), the lax.scan formulation
``hh_kernels.hh256_batch`` and the host ``highwayhash.hh256``, plus the
published HighwayHash test vectors.  Exact equality."""

import struct

import numpy as np
import pytest
import torch

from minio_tpu.hashing import highwayhash as ref_hh
from minio_tpu.ops import hh_kernels, hh_pallas
from minio_tpu_torch.hashing.highwayhash import MAGIC_KEY, init_state
from minio_tpu_torch.ops import hh

# the ragged lengths around the 32-byte packet and the 64-packet chunk of
# the Pallas kernel
LENGTHS = [0, 1, 31, 32, 33, 2047, 2048, 2049, 64 * 32 + 5]
# google/highwayhash test vectors: key 0x0706...00, data bytes 0..n-1
HH_TEST_KEY = struct.pack("<4Q", 0x0706050403020100, 0x0F0E0D0C0B0A0908,
                          0x1716151413121110, 0x1F1E1D1C1B1A1918)
HH64_VECTORS = {0: 0x907A56DE22C26E53, 1: 0x7EAB43AAC7CDDD78,
                2: 0xB8D0569AB0B53D62}
HH256_VECTOR_0 = (0xDD44482AC2C874F5, 0xD946017313C7351F,
                  0xB3AEBECCB98714FF, 0x41DA233145751DF4)


def _blocks(B, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_matches_host_hash(n):
    b = _blocks(6, n, n)
    got = hh.hh256_batch(torch.from_numpy(b)).numpy()
    for i in range(6):
        assert got[i].tobytes() == ref_hh.hh256(b[i].tobytes()), (n, i)


def test_matches_scan_formulation():
    """One width with whole packets and a remainder packet (each width
    compiles its own scan, seconds apiece; the host hash above covers
    every length)."""
    n = 2049
    b = _blocks(4, n, n + 1)
    got = hh.hh256_batch(torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(hh_kernels.hh256_batch(b)))


@pytest.mark.parametrize("n", [64 * 32 + 5, 8808])
def test_matches_pallas_kernel(n):
    """One single-chunk width and one multi-chunk width (275 packets: five
    64-packet chunks, the last part-full, plus an 8-byte remainder)."""
    b = _blocks(3, n, n + 2)
    got = hh.hh256_batch(torch.from_numpy(b)).numpy()
    assert np.array_equal(got, np.asarray(hh_pallas.hh256_batch(b)))


def test_published_vectors():
    for n, want in HH64_VECTORS.items():
        row = torch.arange(n, dtype=torch.uint8).reshape(1, n)
        got = hh.hh64_batch(row, HH_TEST_KEY).numpy()[0]
        assert int.from_bytes(got.tobytes(), "little") == want
    got = hh.hh256_batch(torch.zeros((1, 0), dtype=torch.uint8), HH_TEST_KEY)
    assert struct.unpack("<4Q", got.numpy().tobytes()) == HH256_VECTOR_0


def test_custom_key_and_strided_rows():
    """Any key; rows of a (G, R, n) view with gaps between them."""
    key = bytes(range(32))
    base = _blocks(2, 3 * 150, 3)
    view = torch.from_numpy(base).unflatten(1, (3, 150))[:, :, 10:110]
    got = hh.hh256_batch(view, key).numpy()
    for g in range(2):
        for r in range(3):
            want = ref_hh.hh256(view[g, r].numpy().tobytes(), key)
            assert got[g, r].tobytes() == want


def test_init_state_matches_reference_limbs():
    limbs = hh_kernels._init_state_np(MAGIC_KEY)
    for word, hi, lo in zip(init_state(MAGIC_KEY), limbs[0::2], limbs[1::2]):
        assert [x >> 32 for x in word] == [int(v) for v in hi]
        assert [x & 0xFFFFFFFF for x in word] == [int(v) for v in lo]


def test_rejects_bad_input():
    with pytest.raises(TypeError):
        hh.hh256_batch(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        hh.hh256_batch(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        hh.hh256_batch(torch.zeros((1, 8), dtype=torch.uint8), b"short")

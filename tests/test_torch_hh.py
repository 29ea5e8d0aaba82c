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


def _random_state_and_packet(seed):
    """A random (hi, lo)-limb state of 3 rows and one packet, as
    ``hh._update`` takes them."""
    rng = np.random.default_rng(seed)
    limbs = [torch.from_numpy(rng.integers(0, 1 << 32, (3, 4), dtype=np.int64))
             for _ in range(10)]
    return tuple(limbs[:8]), limbs[8], limbs[9]


@pytest.mark.parametrize("changed", ["packet", "state"])
@pytest.mark.parametrize("half", [0, 1])
def test_lane_pairs_are_independent(changed, half):
    """The packet update never mixes lanes {0, 1} with lanes {2, 3}: new
    values in one half's packet or state lanes leave the other half of the
    updated state bit-identical.  Kernels B and C split each row over two
    threads on this."""
    st, lh, ll = _random_state_and_packet(half)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64)
    perm = torch.tensor(hh._zipper_perm())
    mine = slice(2 * half, 2 * half + 2)
    other = slice(2 - 2 * half, 4 - 2 * half)
    flip = torch.zeros_like(lh)
    flip[:, mine] = 0x5A5A5A5A
    if changed == "packet":
        st2, lh2, ll2 = st, lh ^ flip, ll ^ flip
    else:
        st2, lh2, ll2 = tuple(t ^ flip for t in st), lh, ll
    before = hh._update(st, lh, ll, shifts, perm)
    after = hh._update(st2, lh2, ll2, shifts, perm)
    for a, b in zip(before, after):
        assert torch.equal(a[:, other], b[:, other])
    assert any(not torch.equal(a[:, mine], b[:, mine])
               for a, b in zip(before, after))


def _banks_of_8_byte_reads(pitch, rows):
    """The 4-byte banks (of 32) an 8-byte read touches in each row, rows
    ``pitch`` bytes apart, at one column."""
    return [{(r * pitch // 4 + i) % 32 for i in (0, 1)} for r in range(rows)]


@pytest.mark.parametrize("rows", [1, 2, 16, 96, 133, 300, 528, 529, 5000,
                                  10 ** 6])
@pytest.mark.parametrize("n", [0, 1, 33, 2049, 873814])
def test_plan(rows, n):
    """Kernel B's launch geometry: two lanes per row, at most one warp per
    scheduler in a block, every row covered once, the shared memory of
    one block within the card's 227 KB, and a row pitch at which one
    warp's 8-byte reads of its rows at one column hit distinct banks."""
    p = hh.plan(rows, n)
    assert 2 * p["rows_per_warp"] <= 32
    assert 1 <= p["warps"] <= hh.SCHEDULERS
    assert p["threads"] == 32 * p["warps"]
    assert p["rows_per_block"] == p["warps"] * p["rows_per_warp"]
    assert (p["blocks"] - 1) * p["rows_per_block"] < rows \
        <= p["blocks"] * p["rows_per_block"]
    assert p["tile"] % 128 == 0 and p["tile"] >= 128
    assert p["pitch"] >= p["tile"] + 16 and p["pitch"] % 128 == 16
    assert p["smem"] == (p["warps"] * p["rows_per_warp"] * p["stages"]
                         * p["pitch"] + 16)
    assert p["smem"] <= 232448
    banks = _banks_of_8_byte_reads(p["pitch"], p["rows_per_warp"])
    assert sum(len(b) for b in banks) == len(set().union(*banks))


def test_plan_spreads_a_put_batch():
    """A 64 MiB PUT batch (96 rows) gets one row per warp and one warp per
    block, so its 96 hashing warps land on 96 SMs."""
    p = hh.plan(96, 873814)
    assert (p["rows_per_warp"], p["warps"], p["blocks"]) == (1, 1, 96)
    assert hh.plan(16, 873814)["blocks"] == 16


def test_rejects_bad_input():
    with pytest.raises(TypeError):
        hh.hh256_batch(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        hh.hh256_batch(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        hh.hh256_batch(torch.zeros((1, 8), dtype=torch.uint8), b"short")

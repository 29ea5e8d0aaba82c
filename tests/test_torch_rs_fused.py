"""Kernel C's plain version (``minio_tpu_torch.ops.rs_fused``) against
minio_tpu: the fused Pallas kernel run in interpret mode, and the host
oracles ``gf8_ref.encode_parity`` and ``HighwayHash256(MAGIC_KEY)``.
Integer work throughout: results must be exactly equal.

Interpret-mode compiles cost seconds apiece, so the Pallas kernel is
compared at the two shapes of the JAX package's own fast tests; the host
oracles cover the many cheap shapes."""

import itertools

import numpy as np
import pytest
import torch

from minio_tpu.hashing.highwayhash import MAGIC_KEY, HighwayHash256
from minio_tpu.ops import gf8 as ref_gf8
from minio_tpu.ops import gf8_ref
from minio_tpu.ops import rs_fused as ref_fused
from minio_tpu_torch.ops import gf8, rs_fused


def _blocks(B, k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, k, n),
                                                dtype=np.uint8)


def _hh(row) -> bytes:
    h = HighwayHash256(MAGIC_KEY)
    h.update(bytes(row))
    return h.digest()


@pytest.mark.parametrize("B,k,m,n", [(3, 4, 2, 997), (2, 4, 2, 2079)])
def test_matches_pallas_fused_kernel(B, k, m, n):
    d = _blocks(B, k, n, n)
    par, dig = rs_fused.encode_with_bitrot_fused(k, m, torch.from_numpy(d))
    want_par, want_dig = ref_fused.encode_with_bitrot_fused(
        k, m, d, interpret=True)
    assert np.array_equal(par.numpy(), np.asarray(want_par))
    assert np.array_equal(dig.numpy(), np.asarray(want_dig))


def test_data_only_digests_match_pallas_fused_kernel():
    """``hash_parity=False``: digests of the data rows only."""
    B, k, m, n = 4, 6, 2, 500
    d = _blocks(B, k, n, 7)
    M = gf8.rs_matrix(k, k + m)[k:]
    par, dig = rs_fused.encode_hash_device(M, torch.from_numpy(d),
                                           hash_parity=False)
    want_par, want_dig = ref_fused.encode_hash_device(
        M, d, hash_parity=False, interpret=True)
    assert dig.shape == (B, k, 32)
    assert np.array_equal(par.numpy(), np.asarray(want_par))
    assert np.array_equal(dig.numpy(), np.asarray(want_dig))


@pytest.mark.parametrize("k,m,n,B", [
    (k, m, n, B) for (k, m), n, B in itertools.product(
        [(4, 2), (3, 2), (5, 1), (12, 4)], [1, 31, 32, 33, 2048, 2079],
        [1, 2, 5])])
def test_matches_host_oracles(k, m, n, B):
    d = _blocks(B, k, n, k * 10000 + n * 10 + B)
    par, dig = rs_fused.encode_with_bitrot_fused(k, m, d)
    want = np.stack([gf8_ref.encode_parity(d[b], m) for b in range(B)])
    assert np.array_equal(par.numpy(), want)
    assert dig.shape == (B, k + m, 32)
    for b in range(B):
        for s, row in enumerate(list(d[b]) + list(want[b])):
            assert dig[b, s].numpy().tobytes() == _hh(row), (b, s)


def test_short_hashed_width_and_strided_rows():
    """Digests over the first ``n_real`` bytes only; data read from, and
    parity written into, strided rows of a frame tensor, leaving every
    other byte as it was."""
    k, m, nf, ss = 5, 3, 3, 301
    M = gf8.rs_matrix(k, k + m)[k:]
    frames = torch.from_numpy(_blocks(1, k + m, nf * (32 + ss), 3)[0])
    before = frames.clone()
    view = frames.unflatten(1, (nf, 32 + ss)).transpose(0, 1)
    data = view[:, :k, 32:]
    _, dig = rs_fused.encode_hash_device(M, data, n_real=200,
                                         out_parity=view[:, k:, 32:])
    d = data.numpy()
    want = np.stack([gf8_ref.encode_parity(d[b], m) for b in range(nf)])
    assert np.array_equal(view[:, k:, 32:].numpy(), want)
    for b in range(nf):
        for s, row in enumerate(list(d[b]) + list(want[b])):
            assert dig[b, s].numpy().tobytes() == _hh(row[:200])
    view[:, k:, 32:] = before.unflatten(1, (nf, 32 + ss)).transpose(
        0, 1)[:, k:, 32:]
    assert torch.equal(frames, before)


def test_plan_rejects_oversized_stripe():
    with pytest.raises(ValueError):
        rs_fused.plan(4, 1000, 100, 4096)
    with pytest.raises(ValueError):
        rs_fused.plan(1, 200, 57, 64)
    with pytest.raises(ValueError):
        rs_fused.encode_hash_device(np.ones((100, 1000), np.uint8),
                                    torch.zeros((1, 1000, 64),
                                                dtype=torch.uint8))


def test_plan_fits_the_shared_memory_budget():
    """The 12+4 path takes 3 KiB stages; the widest stripe (k + ro = 256)
    still gets whole 128-byte stages and a hashing warp per 16 rows."""
    assert rs_fused.plan(6, 12, 4, 873814)["tile"] == 3072
    assert rs_fused.plan(1, 4, 2, 33)["tile"] == 128
    for k, ro in ((128, 128), (255, 1), (1, 255)):
        p = rs_fused.plan(1, k, ro, 10 ** 6)
        assert p["tile"] >= 128 and p["tile"] % 128 == 0
        assert p["smem"] <= rs_fused.SMEM_BUDGET
        assert p["hash_warps"] == 16 and p["threads"] <= 1024


@pytest.mark.parametrize("k,ro,hp", [(12, 4, True), (12, 4, False),
                                     (4, 2, True), (17, 3, True),
                                     (100, 28, False)])
def test_plan_geometry(k, ro, hp):
    """Stage width, pitch (16 mod 128 bytes), the shared-memory total of
    the kernel's layout, and the block's warps: a producer, six product
    warps and one hashing warp per 16 hashed rows."""
    p = rs_fused.plan(3, k, ro, 873814, hp)
    R = k + (ro if hp else 0)
    assert p["R"] == R
    assert p["pitch"] == p["tile"] + 16 and p["pitch"] % 128 == 16
    assert p["smem"] == 128 + p["stages"] * (k + ro) * p["pitch"] + 16
    assert p["hash_warps"] == -(-R // 16)
    assert p["threads"] == 32 * (7 + p["hash_warps"])


def test_nibble_tables_multiply():
    """c * x = lo[x & 15] ^ hi[x >> 4] for every coefficient and byte,
    against minio_tpu's GF(2^8) product table."""
    M = np.arange(256, dtype=np.uint8).reshape(1, 256)
    T = rs_fused.nibble_tables(M)[:, 0]                      # (256, 32)
    x = np.arange(256)
    got = T[:, x & 15] ^ T[:, 16 + (x >> 4)]                 # (256, 256)
    assert np.array_equal(got, ref_gf8.GF_MUL)


def test_nibble_tables_layout():
    """The kernel reads the tables data row major, parity rows padded to
    a multiple of 4 with zero tables."""
    M = gf8.rs_matrix(5, 11)[5:]                                # (6, 5)
    T = rs_fused.nibble_tables(M)
    assert T.shape == (5, 8, 32)
    for o in range(6):
        for j in range(5):
            assert list(T[j, o, :16]) == [ref_gf8.GF_MUL[M[o, j], i]
                                          for i in range(16)]
    assert not T[:, 6:].any()


def test_rejects_bad_input():
    M = gf8.rs_matrix(4, 6)[4:]
    with pytest.raises(TypeError):
        rs_fused.encode_hash_device(M, torch.zeros((1, 4, 8),
                                                   dtype=torch.int32))
    with pytest.raises(ValueError):
        rs_fused.encode_hash_device(M, torch.zeros((1, 5, 8),
                                                   dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_fused.encode_hash_device(M, torch.zeros((1, 4, 8),
                                                   dtype=torch.uint8),
                                    n_real=9)
    with pytest.raises(ValueError):
        rs_fused.encode_hash_device(
            M, torch.zeros((1, 4, 8), dtype=torch.uint8),
            out_parity=torch.zeros((1, 3, 8), dtype=torch.uint8))


def test_cpu_tensors_run_the_plain_version_alone():
    """A CPU tensor runs Kernel C's plain version, which counts itself
    and not Kernels A and B, whose plain functions it reuses."""
    from minio_tpu_torch.ops import hh, rs_kernels
    for c in (rs_fused.COUNTS, rs_kernels.COUNTS, hh.COUNTS):
        c.reset()
    rs_fused.encode_with_bitrot_fused(4, 2, _blocks(2, 4, 40, 1))
    assert rs_fused.COUNTS.plain == 1 and rs_fused.COUNTS.launches == 0
    assert rs_kernels.COUNTS.plain == hh.COUNTS.plain == 0

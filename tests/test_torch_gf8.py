"""The port's GF(2^8) tables, matrices and shard math against minio_tpu's."""

import numpy as np
import pytest

from minio_tpu.ops import gf8 as ref
from minio_tpu_torch.ops import gf8

GEOMETRIES = [(4, 2), (8, 4), (12, 4), (14, 2)]


def test_tables_match():
    assert np.array_equal(gf8.GF_EXP, ref.GF_EXP)
    assert np.array_equal(gf8.GF_LOG, ref.GF_LOG)
    assert np.array_equal(gf8.GF_MUL, ref.GF_MUL)
    assert np.array_equal(gf8.GF_INV, ref.GF_INV)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_rs_matrix_and_inverse(k, m):
    M = gf8.rs_matrix(k, k + m)
    assert np.array_equal(M, ref.rs_matrix(k, k + m))
    rng = np.random.default_rng(k * 31 + m)
    rows = np.sort(rng.choice(k + m, size=k, replace=False))
    assert np.array_equal(gf8.gf_mat_inv(M[rows]), ref.gf_mat_inv(M[rows]))
    assert np.array_equal(gf8.gf2_expand(M[k:]), ref.gf2_expand(M[k:]))
    B = rng.integers(0, 256, (k, 77), dtype=np.uint8)
    assert np.array_equal(gf8.gf_matmul(M, B), ref.gf_matmul_numpy(M, B))


def test_singular_matrix_raises():
    with pytest.raises(ValueError):
        gf8.gf_mat_inv(np.array([[1, 2], [1, 2]], dtype=np.uint8))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_shard_math(k, m):
    for bs in (1, 4096, 10 * 1024 * 1024, 10 * 1024 * 1024 + 7):
        assert gf8.shard_size(bs, k) == ref.shard_size(bs, k)
        for total in (-1, 0, 1, bs - 1, bs, bs + 1, 3 * bs + 5):
            assert gf8.shard_file_size(bs, k, total) == \
                ref.shard_file_size(bs, k, total)
            for off, ln in ((0, total), (bs // 2, 3), (bs, bs)):
                assert gf8.shard_file_offset(bs, k, off, ln, total) == \
                    ref.shard_file_offset(bs, k, off, ln, total)
    for num, den in ((7, 2), (-7, 2), (7, -2), (0, 3), (5, 0), (6, 3)):
        assert gf8.ceil_frac(num, den) == ref.ceil_frac(num, den)
    for n in (1, k - 1, k, k + 1, 1000):
        data = bytes(range(256)) * 4
        assert np.array_equal(gf8.split(data[:n], k), ref.split(data[:n], k))
    with pytest.raises(ValueError):
        gf8.split(b"", k)


def test_nibble_tables_multiply():
    """The split-nibble tables Kernels A and C read: c * x = lo[x & 15] ^
    hi[x >> 4] for every coefficient and byte, against minio_tpu's GF(2^8)
    product table; output rows padded to a multiple of 4 with zeros."""
    M = np.arange(256, dtype=np.uint8).reshape(1, 256)
    T = gf8.nibble_tables(M)
    assert T.shape == (256, 4, 32) and not T[:, 1:].any()
    x = np.arange(256)
    got = T[:, 0, x & 15] ^ T[:, 0, 16 + (x >> 4)]            # (256, 256)
    assert np.array_equal(got, ref.GF_MUL)


def test_nibble_tables_keep_their_old_name():
    from minio_tpu_torch.ops import rs_fused
    assert rs_fused.nibble_tables is gf8.nibble_tables

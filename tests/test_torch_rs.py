"""Kernel A's plain version and the reconstruct functions of the port
against minio_tpu: the Pallas kernel run in interpret mode, the XLA
formulation ``rs_kernels._gf2_apply`` and the numpy oracle ``gf8_ref``.
All integer work: results must be exactly equal."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import codec as ref_codec
from minio_tpu.ops import gf8 as ref_gf8
from minio_tpu.ops import gf8_ref, rs_pallas
from minio_tpu.ops import rs_kernels as ref_rs
from minio_tpu_torch.ops import codec, gf8, rs_kernels


def _shards(B, k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, k, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("B,k,m,n", [
    (3, 4, 2, 300), (3, 12, 4, 300),      # the issue's base shapes
    (3, 12, 4, 301), (5, 4, 2, 1),        # ragged width, B not a power of 2
    (1, 12, 4, 4097),
])
def test_apply_matrix_matches_reference(B, k, m, n):
    d = _shards(B, k, n, B * 1000 + k * 10 + n)
    M = ref_gf8.rs_matrix(k, k + m)[k:]
    got = rs_kernels.apply_matrix(M, torch.from_numpy(d)).numpy()
    pallas = np.asarray(rs_pallas.apply_matrix(M, d, interpret=True))
    xla = np.asarray(ref_rs._gf2_apply(
        jnp.asarray(ref_gf8.gf2_expand(M), jnp.int8), jnp.asarray(d)))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)


def test_apply_matrix_strided_out_and_2d():
    """A strided input and an ``out`` view written in place (the layout
    Erasure.encode_object uses), and the unbatched (k, n) form."""
    k, m, n = 6, 3, 50
    M = gf8.rs_matrix(k, k + m)[k:]
    files = torch.from_numpy(_shards(1, k + m, 4 * n, 5)[0])   # (k+m, 4n)
    stripes = files.unflatten(1, (4, n)).transpose(0, 1)       # (4, k+m, n)
    want = np.stack([ref_gf8.gf_matmul_numpy(M, stripes[b, :k].numpy())
                     for b in range(4)])
    rs_kernels.apply_matrix(M, stripes[:, :k], out=stripes[:, k:])
    assert np.array_equal(stripes[:, k:].numpy(), want)
    flat = rs_kernels.apply_matrix(M, stripes[0, :k].contiguous())
    assert np.array_equal(flat.numpy(), want[0])


def test_apply_matrix_rejects_bad_input():
    M = gf8.rs_matrix(4, 6)[4:]
    with pytest.raises(TypeError):
        rs_kernels.apply_matrix(M, torch.zeros((1, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        rs_kernels.apply_matrix(M, torch.zeros((1, 5, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_kernels.apply_matrix(M, torch.zeros((1, 4, 8), dtype=torch.uint8),
                                out=torch.zeros((1, 3, 8), dtype=torch.uint8))


PATH = (6, 12, 4, 873814)     # a 64 MiB PUT batch of a 12 + 4 set


def test_plan_at_the_path_shape():
    """2 KiB of columns per block on 128 threads, at least two blocks per
    SM, one pass, one block per tile and stripe."""
    B, k, r, n = PATH
    p = rs_kernels.plan(B, k, r, n)
    assert p["tile"] == 16 * p["threads"] == 2048
    assert p["smem"] == rs_kernels.smem_bytes(k, p["tile"])
    assert p["smem"] <= rs_kernels.SMEM_BUDGET
    assert p["blocks_per_sm"] >= 2
    assert p["grid"] == (-(-n // 2048), B) and p["passes"] == 1


@pytest.mark.parametrize("n", [1, 17, 4097, 873814])
def test_plan_fits_shared_memory_for_every_k_and_r(n):
    """Every (k, r) that apply_matrix takes gets a plan: tile a multiple of
    16 x threads (whole warps), the kernel's shared-memory total, two
    blocks per SM up to k = 169 and one block within the opt-in limit
    above."""
    for k in range(1, 257):
        for r in range(1, 257):
            p = rs_kernels.plan(3, k, r, n)
            t = p["threads"]
            assert 32 <= t <= rs_kernels.THREADS and t % 32 == 0
            assert p["tile"] % (16 * t) == 0
            assert p["smem"] == rs_kernels.smem_bytes(k, p["tile"])
            assert p["smem"] <= (rs_kernels.SMEM_BUDGET if k <= 169
                                 else rs_kernels.BLOCK_SMEM_MAX)
            assert p["blocks_per_sm"] >= (2 if k <= 169 else 1)
            assert p["passes"] == -(-r // 4)
            assert p["grid"][0] * p["tile"] >= n


@pytest.mark.parametrize("n,threads", [(1, 32), (15, 32), (512, 32),
                                       (513, 64), (2048, 128)])
def test_plan_for_a_row_narrower_than_a_tile(n, threads):
    """A narrow row takes one block per stripe, with as few whole warps as
    cover it."""
    p = rs_kernels.plan(2, 12, 4, n)
    assert p["threads"] == threads and p["tile"] >= n
    assert p["grid"] == (1, 2)


@pytest.mark.parametrize("B,k,r,n", [(0, 4, 2, 8), (1, 0, 2, 8),
                                     (1, 4, 0, 8), (1, 257, 2, 8),
                                     (1, 4, 257, 8), (1, 4, 2, 0)])
def test_plan_rejects_what_the_kernel_cannot_take(B, k, r, n):
    with pytest.raises(ValueError):
        rs_kernels.plan(B, k, r, n)


def _check_reconstruct(k, m, lost, seed):
    data = _shards(1, k, 97, seed)[0]
    full = gf8_ref.encode(data, m)
    ref_in = [None if i in lost else full[i] for i in range(k + m)]
    want = gf8_ref.reconstruct(list(ref_in), k, m)
    got = rs_kernels.reconstruct(
        [None if s is None else torch.from_numpy(s) for s in ref_in], k, m)
    for i in range(k + m):
        assert np.array_equal(got[i].numpy(), want[i]), (lost, i)


def test_reconstruct_every_2_loss_pattern_4_2():
    for lost in itertools.combinations(range(6), 2):
        _check_reconstruct(4, 2, set(lost), sum(lost))


def test_reconstruct_sampled_4_loss_patterns_12_4():
    pats = list(itertools.combinations(range(16), 4))
    rng = np.random.default_rng(4)
    for idx in rng.choice(len(pats), size=12, replace=False):
        _check_reconstruct(12, 4, set(pats[idx]), int(idx))


def test_reconstruct_too_few_shards():
    shards = [torch.zeros(8, dtype=torch.uint8)] * 3 + [None] * 3
    with pytest.raises(gf8.ReconstructError):
        rs_kernels.reconstruct(shards, 4, 2)


def test_reconstruct_batch_matches_decode_rows():
    k, m = 12, 4
    present = [0, 1, 2, 3, 4, 5, 6, 7, 12, 13, 14, 15]
    wanted = [8, 9, 10, 11]
    d = _shards(3, k, 64, 9)
    full = np.stack([gf8_ref.encode(d[b], m) for b in range(3)])
    got = rs_kernels.reconstruct_batch(
        torch.from_numpy(full[:, present]), present, wanted, k, m).numpy()
    assert np.array_equal(got, full[:, wanted])
    M = gf8.rs_matrix(k, k + m)
    assert np.array_equal(rs_kernels.decode_rows(M, k, present, wanted),
                          ref_rs.decode_rows(M, k, present, wanted))


@pytest.mark.parametrize("size", [0, 1, 4095, 4096, 3 * 4096 + 777])
def test_codec_matches_reference(size):
    """Erasure.encode_object and the single-block decode against
    minio_tpu's numpy codec (blockSize not a multiple of k)."""
    body = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    ours = codec.Erasure(12, 4, 4096, device="cpu")
    ref = ref_codec.Erasure(12, 4, 4096, backend="numpy")
    got = ours.encode_object(body)
    want = ref.encode_object(body)
    assert got.shape[0] == 16
    for i in range(16):
        assert np.array_equal(got[i].numpy(), want[i])
    block = body[:4096]
    shards = ours.encode_data(block)
    assert all(np.array_equal(s.numpy(), w)
               for s, w in zip(shards, ref.encode_data(block)))
    if size:
        lost = list(shards)
        for i in (0, 3, 7, 13):
            lost[i] = None
        back = ours.decode_data_and_parity_blocks(lost)
        assert all(torch.equal(a, b) for a, b in zip(back, shards))
        data_only = ours.decode_data_blocks(lost)
        assert all(torch.equal(data_only[i], shards[i]) for i in range(12))

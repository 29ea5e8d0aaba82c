"""The port's bitrot framing against minio_tpu's, byte for byte, and its
device-side verification."""

import numpy as np
import pytest
import torch

from minio_tpu.hashing import bitrot as ref
from minio_tpu_torch.hashing import bitrot


def _shards(S, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, L),
                                                dtype=np.uint8)


@pytest.mark.parametrize("S,L,ss", [
    (6, 4500, 1387),      # ragged shard size, short last block
    (16, 3 * 342, 342),   # whole blocks only
    (4, 100, 342),        # one short block
    (3, 0, 342),          # empty shard files
])
def test_frame_batch_matches_reference(S, L, ss):
    sh = _shards(S, L, L + ss)
    got = bitrot.frame_batch(torch.from_numpy(sh), ss).numpy()
    want = ref.streaming_encode_batch([sh[i].tobytes() for i in range(S)],
                                      ss)
    assert [got[i].tobytes() for i in range(S)] == want
    assert got.shape[1] == bitrot.bitrot_shard_file_size(L, ss) == \
        ref.bitrot_shard_file_size(L, ss, ref.HIGHWAYHASH256S)


def test_offsets_match_reference():
    for off in (0, 342, 3 * 342):
        assert bitrot.bitrot_shard_file_offset(off, 342) == \
            ref.bitrot_shard_file_offset(off, 342, ref.HIGHWAYHASH256S)


@pytest.mark.parametrize("L,length", [(4500, 4500), (4500, 2000),
                                      (2774, 2774)])
def test_verify_extract_returns_payload(L, length):
    sh = _shards(1, L, 11)[0]
    framed = torch.from_numpy(bitrot.frame_batch(
        torch.from_numpy(sh[None]), 1387).numpy()[0])
    got = bitrot.verify_extract(framed, 1387, length)
    assert np.array_equal(got.numpy(), sh[:length])


@pytest.mark.parametrize("pos", [0, 31, 32, 1387 + 40, -1])
def test_verify_extract_detects_flips(pos):
    """A flipped digest byte (0, 31) or payload byte (32, second block,
    last byte of the short block) fails verification."""
    sh = _shards(1, 4500, 12)
    framed = bitrot.frame_batch(torch.from_numpy(sh), 1387)[0].clone()
    framed[pos] ^= 0x01
    with pytest.raises(bitrot.BitrotError):
        bitrot.verify_extract(framed, 1387, 4500)


def test_verify_frames_marks_only_bad_rows():
    sh = _shards(5, 4500, 13)
    framed = bitrot.frame_batch(torch.from_numpy(sh), 1387).clone()
    framed[2, 100] ^= 0xFF
    payload, ok = bitrot.verify_frames(framed, 1387, 4500)
    assert ok.tolist() == [True, True, False, True, True]
    assert np.array_equal(payload[0].numpy(), sh[0])


def test_verify_rejects_truncated_frame():
    sh = _shards(1, 4500, 14)
    framed = bitrot.frame_batch(torch.from_numpy(sh), 1387)[0]
    with pytest.raises(bitrot.BitrotError):
        bitrot.verify_extract(framed, 1387, 4501)
    with pytest.raises(bitrot.BitrotError):
        bitrot.verify_extract(framed[:-(4500 - 3 * 1387) - 10], 1387, 4000)

"""The port's SipHash-2-4 (``minio_tpu_torch/hashing/siphash.py``) against
the published vector and ``minio_tpu``'s ``sip_hash_mod``: placement must
agree bit for bit, or the two packages would look for an object in
different sets of one deployment."""

import uuid

import numpy as np
import pytest

from minio_tpu.hashing import siphash as ref_siphash
from minio_tpu_torch.hashing import siphash


def test_published_vector():
    # SipHash-2-4 reference vectors: key 00..0f, message 00..0e
    assert siphash.siphash24(bytes(range(15)), bytes(range(16))) == \
        0xa129ca6149be45e5


@pytest.mark.parametrize("length", range(0, 18))
def test_every_tail_length_matches_reference(length):
    rng = np.random.default_rng(length)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
    assert siphash.siphash24(data, key) == ref_siphash.siphash24(data, key)


def _names(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789/-_.") + \
        ["é", "ß", "日", "本", "😀", "ü"]
    out = []
    for _ in range(n):
        size = int(rng.integers(1, 40))
        out.append("".join(alphabet[i] for i in
                           rng.integers(0, len(alphabet), size)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_sip_hash_mod_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    dep = uuid.UUID(bytes=rng.integers(0, 256, 16,
                                       dtype=np.uint8).tobytes())
    id_bytes = bytes.fromhex(str(dep).replace("-", ""))
    names = _names(seed, 200)
    for card in range(1, 17):
        assert [siphash.sip_hash_mod(n, card, id_bytes) for n in names] \
            == [ref_siphash.sip_hash_mod(n, card, id_bytes) for n in names]
    assert siphash.sip_hash_mod("x", 0, id_bytes) == -1

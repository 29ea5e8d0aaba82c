"""AES-GCM from libcrypto, DARE 2.0 and configcrypt in the port against
``minio_tpu``'s (which seals through the ``cryptography`` package here):
the same key, nonce and plaintext give the same ciphertext; with
``os.urandom`` pinned (``_torch_iam.pin_random``) DARE streams and
sealed blobs are byte-equal; each package opens the other's, also a
range, also a blob sealed under an old secret (which asks to be
resealed); tampering is refused alike.  Without libcrypto the port
refuses to seal, where the reference writes plaintext (ROADMAP Queue 3
item 23)."""

import os

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers.aead import AESGCM as WheelGCM

from minio_tpu.crypto import dare as ref_dare
from minio_tpu.secure import configcrypt as ref_cc
from minio_tpu_torch.crypto import dare as port_dare
from minio_tpu_torch.crypto import libcrypto
from minio_tpu_torch.secure import configcrypt as port_cc

from ._torch_iam import pin_random

SIZES = [0, 1, 1000, 65535, 65536, 65537, 3 * 65536, 200_000]


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).integers(0, 256, n,
                                                    dtype=np.uint8).tobytes()


def test_the_port_never_imports_the_wheel():
    assert port_dare.AESGCM is libcrypto.AESGCM
    assert ref_dare.BACKEND == "cryptography"


@pytest.mark.parametrize("klen", [16, 24, 32])
@pytest.mark.parametrize("n,aad", [(0, b""), (1, b"h"), (1000, b""),
                                   (70_000, b"header-bytes")])
def test_aesgcm_equals_the_wheel(klen, n, aad):
    key, nonce, data = _bytes(klen, 1), _bytes(12, 2), _bytes(n, 3)
    want = WheelGCM(key).encrypt(nonce, data, aad or None)
    got = libcrypto.AESGCM(key).encrypt(nonce, data, aad or None)
    assert got == want
    assert libcrypto.AESGCM(key).decrypt(nonce, want, aad or None) == data
    bad = bytearray(want)
    bad[-1] ^= 1
    with pytest.raises(libcrypto.InvalidTag):
        libcrypto.AESGCM(key).decrypt(nonce, bytes(bad), aad or None)


@pytest.mark.parametrize("n", SIZES)
def test_dare_streams_are_byte_equal(monkeypatch, n):
    pin_random(monkeypatch)
    key, data = _bytes(32, 5), _bytes(n, 6)
    ct = port_dare.encrypt(key, data)
    assert ct == ref_dare.encrypt(key, data)
    assert len(ct) == port_dare.ciphertext_size(n) == \
        ref_dare.ciphertext_size(n)
    assert port_dare.plaintext_size(len(ct)) == n
    assert ref_dare.decrypt(key, ct) == port_dare.decrypt(key, ct) == data


@pytest.mark.parametrize("offset,length", [(0, -1), (0, 1), (65535, 2),
                                           (65536, 65536), (100_000, 50_000),
                                           (199_999, 1), (5, 0)])
def test_decrypt_range_equals_the_references(offset, length):
    key, data = _bytes(32, 7), _bytes(200_000, 8)
    ct = port_dare.encrypt(key, data)
    reads = []

    def read_cipher(off, n):
        reads.append((off, n))
        return ct[off:off + n]
    got = port_dare.decrypt_range(key, read_cipher, len(ct), offset, length)
    want = ref_dare.decrypt_range(key, lambda o, n: ct[o:o + n], len(ct),
                                  offset, length)
    end = len(data) if length < 0 else offset + length
    assert got == want == data[offset:end]
    # only the covering packages were read
    assert sum(n for _, n in reads) <= \
        (2 + (end - offset) // port_dare.MAX_PAYLOAD) * port_dare.MAX_PACKAGE


@pytest.mark.parametrize("damage", ["flip", "truncate", "drop-final",
                                    "swap"])
def test_tampered_streams_are_refused_alike(damage):
    key, data = _bytes(32, 9), _bytes(3 * 65536 + 10, 10)
    ct = bytearray(port_dare.encrypt(key, data))
    pkg = port_dare.MAX_PACKAGE
    if damage == "flip":
        ct[100] ^= 0x40
    elif damage == "truncate":
        ct = ct[:-5]
    elif damage == "drop-final":
        ct = ct[:3 * pkg]
    else:
        ct[:pkg], ct[pkg:2 * pkg] = ct[pkg:2 * pkg], ct[:pkg]
    for mod in (port_dare, ref_dare):
        with pytest.raises(mod.DAREError):
            mod.decrypt(key, bytes(ct))


@pytest.mark.parametrize("n", [0, 10, 70_000])
def test_sealed_blobs_are_byte_equal_and_open_across(monkeypatch, n):
    pin_random(monkeypatch)
    doc = _bytes(n, 11)
    blob = port_cc.encrypt_data("admin-secret", doc)
    assert blob == ref_cc.encrypt_data("admin-secret", doc)
    assert port_cc.is_encrypted(blob) and blob.startswith(port_cc.MAGIC)
    assert port_cc.decrypt_data("admin-secret", blob) == doc
    assert ref_cc.decrypt_data("admin-secret", blob) == doc
    for mod in (port_cc, ref_cc):
        with pytest.raises(mod.DecryptError):
            mod.decrypt_data("other-secret", blob)
        assert mod.maybe_decrypt("admin-secret", blob) == (doc, False)


def test_an_old_secret_opens_and_asks_for_a_reseal(monkeypatch):
    old = ref_cc.encrypt_data("old-secret", b'{"a": 1}')
    monkeypatch.setenv("MT_ADMIN_SECRET_OLD", "older, old-secret")
    for mod in (port_cc, ref_cc):
        olds = mod.old_secrets_from_env()
        assert olds == ("older", "old-secret")
        assert mod.maybe_decrypt("new-secret", old, olds) == \
            (b'{"a": 1}', True)
        with pytest.raises(mod.DecryptError):
            mod.maybe_decrypt("new-secret", old, ("nope",))
        # plaintext migrates
        assert mod.maybe_decrypt("new-secret", b'{"b": 2}') == \
            (b'{"b": 2}', True)


def test_without_libcrypto_the_port_refuses_to_seal(monkeypatch):
    """The reference writes plaintext without an AES-GCM backend
    (``minio_tpu/secure/configcrypt.py:59-66``); the port raises."""
    monkeypatch.setattr(libcrypto, "available", lambda: False)
    assert not port_cc.encryption_available()
    with pytest.raises(RuntimeError, match="libcrypto"):
        port_cc.encrypt_data("s", b"{}")
    with pytest.raises(port_dare.DAREError):
        port_dare.encrypt(os.urandom(32), b"x")
    monkeypatch.setattr(ref_cc, "encryption_available", lambda: False)
    assert ref_cc.encrypt_data("s", b"{}") == b"{}"

"""DARE 2.0 authenticated encryption of a byte stream
(``minio_tpu/crypto/dare.py``, minio/sio v0.2.1; cmd/encryption-v1.go).

The layout is sio's: packages of a 16-byte header, at most 64 KiB of
AES-256-GCM ciphertext and a 16-byte tag; each package's nonce is the
stream nonce with its sequence number XORed into the last 4 bytes, and
the last package sets the final marker.  So a package moved, dropped or
cut off fails to open, and ``decrypt_range`` opens only the packages
that cover a plaintext range.  The whole header is the AEAD's associated
data.  AES-GCM comes from libcrypto (``crypto/libcrypto.py``); the same
key, nonce and plaintext give the reference's bytes.
"""

from __future__ import annotations

import os
import struct
from typing import Callable

from . import libcrypto as _libcrypto
from .libcrypto import AESGCM, InvalidTag

VERSION_20 = 0x20
AES_256_GCM = 0x00

HEADER_SIZE = 16
TAG_SIZE = 16
MAX_PAYLOAD = 64 * 1024                       # plaintext bytes per package
PKG_OVERHEAD = HEADER_SIZE + TAG_SIZE         # 32
MAX_PACKAGE = MAX_PAYLOAD + PKG_OVERHEAD
KEY_SIZE = 32
_FINAL = 0x80                                 # final-package marker (nonce[0])


class DAREError(Exception):
    """Tampered / malformed / truncated ciphertext."""


def backend_available() -> bool:
    """True when libcrypto is bound (sealing at rest needs it)."""
    return _libcrypto.available()


def _aead(key: bytes) -> AESGCM:
    """An AES-GCM instance; DAREError naming why when libcrypto cannot
    be bound."""
    if not _libcrypto.available():
        raise DAREError("no AES-GCM: libcrypto cannot be bound ("
                        f"{_libcrypto.unavailable_reason()})")
    return AESGCM(key)


def ciphertext_size(plain_size: int) -> int:
    """Encrypted size of a plain_size-byte stream (sio.EncryptedSize)."""
    if plain_size < 0:
        raise ValueError("negative size")
    full, rem = divmod(plain_size, MAX_PAYLOAD)
    size = full * MAX_PACKAGE
    if rem or plain_size == 0:
        size += rem + PKG_OVERHEAD            # empty stream = 1 empty pkg
    return size


def plaintext_size(cipher_size: int) -> int:
    """Decrypted size of a cipher_size-byte DARE stream (sio.DecryptedSize)."""
    full, rem = divmod(cipher_size, MAX_PACKAGE)
    size = full * MAX_PAYLOAD
    if rem:
        if rem < PKG_OVERHEAD:
            raise DAREError("truncated final package")
        size += rem - PKG_OVERHEAD
    return size


def _package_nonce(base: bytes, seq: int, final: bool) -> bytes:
    """Per-package nonce: stream nonce with the big-endian sequence number
    XORed into the last 4 bytes; final package sets the top marker bit."""
    n = bytearray(base)
    seq_bytes = struct.pack(">I", seq)
    for i in range(4):
        n[8 + i] ^= seq_bytes[i]
    if final:
        n[0] |= _FINAL
    return bytes(n)


def encrypt(key: bytes, plaintext: bytes) -> bytes:
    """Encrypt a whole stream into DARE packages."""
    if len(key) != KEY_SIZE:
        raise ValueError("DARE needs a 32-byte key")
    aead = _aead(key)
    base_nonce = bytearray(os.urandom(12))
    base_nonce[0] &= 0x7F          # reserve the final-marker bit
    base_nonce = bytes(base_nonce)
    out = bytearray()
    n_pkgs = max(1, (len(plaintext) + MAX_PAYLOAD - 1) // MAX_PAYLOAD)
    for seq in range(n_pkgs):
        chunk = plaintext[seq * MAX_PAYLOAD:(seq + 1) * MAX_PAYLOAD]
        final = seq == n_pkgs - 1
        nonce = _package_nonce(base_nonce, seq, final)
        header = struct.pack("<BBH", VERSION_20, AES_256_GCM,
                             max(len(chunk) - 1, 0)) + nonce
        sealed = aead.encrypt(nonce, chunk, header)
        out += header + sealed
    return bytes(out)


def _decrypt_package(aead: AESGCM, pkg: bytes, seq: int, final: bool,
                     expect_base: bytes | None = None
                     ) -> tuple[bytes, bytes]:
    """Decrypt one package; returns (plaintext, recovered stream nonce).

    The stream nonce recovered from the first package a reader sees is the
    reference all later packages must match (sio's refNonce check) — a
    package moved to a different sequence position recovers a different
    base and is rejected, even though its GCM tag verifies under its own
    header.
    """
    if len(pkg) < PKG_OVERHEAD:
        raise DAREError("truncated package")
    header, body = pkg[:HEADER_SIZE], pkg[HEADER_SIZE:]
    version, cipher, size1 = struct.unpack("<BBH", header[:4])
    if version != VERSION_20 or cipher != AES_256_GCM:
        raise DAREError("unsupported DARE version/cipher")
    nonce = header[4:16]
    if final:
        if not nonce[0] & _FINAL:
            raise DAREError("stream truncated (final marker missing)")
    elif nonce[0] & _FINAL:
        raise DAREError("unexpected final package")
    base = bytearray(nonce)
    seq_bytes = struct.pack(">I", seq)
    for i in range(4):
        base[8 + i] ^= seq_bytes[i]
    base[0] &= ~_FINAL & 0xFF
    base = bytes(base)
    if expect_base is not None and base != expect_base:
        raise DAREError("package out of sequence")
    try:
        plain = aead.decrypt(nonce, body, header)
    except InvalidTag as e:
        raise DAREError("authentication failed") from e
    if len(plain) != size1 + 1 and not (len(plain) == 0 and size1 == 0):
        raise DAREError("payload size mismatch")
    return plain, base


def decrypt(key: bytes, ciphertext: bytes) -> bytes:
    """Decrypt a whole DARE stream, verifying order and final marker."""
    aead = _aead(key)
    out = bytearray()
    off, seq = 0, 0
    ref_nonce: bytes | None = None
    total = len(ciphertext)
    if total == 0:
        raise DAREError("empty ciphertext")
    while off < total:
        if total - off < PKG_OVERHEAD:
            raise DAREError("truncated package")
        size1 = struct.unpack("<H", ciphertext[off + 2:off + 4])[0]
        plen = size1 + 1
        end = off + HEADER_SIZE + plen + TAG_SIZE
        # an empty final package (empty object) encodes size1=0, plen may
        # be 0: detect via remaining bytes
        if end > total and total - off == PKG_OVERHEAD:
            plen, end = 0, off + PKG_OVERHEAD
        if end > total:
            raise DAREError("truncated package")
        final = end == total
        plain, base = _decrypt_package(aead, ciphertext[off:end], seq,
                                       final, expect_base=ref_nonce)
        ref_nonce = base
        out += plain
        off, seq = end, seq + 1
    return bytes(out)


def decrypt_range(key: bytes,
                  read_cipher: Callable[[int, int], bytes],
                  cipher_size: int, offset: int, length: int) -> bytes:
    """Ranged decryption (cmd/encryption-v1.go:475-535 package math).

    Reads only the DARE packages covering plaintext [offset, offset+length)
    via ``read_cipher(cipher_offset, cipher_length)``, decrypts them with
    the correct sequence numbers, and slices.  The final-marker check is
    only applicable when the range covers the last package.
    """
    total_plain = plaintext_size(cipher_size)
    if offset < 0 or offset > total_plain:
        raise ValueError("offset out of range")
    if length < 0:
        length = total_plain - offset
    length = min(length, total_plain - offset)
    if length == 0:
        return b""
    first_pkg = offset // MAX_PAYLOAD
    last_pkg = (offset + length - 1) // MAX_PAYLOAD
    n_pkgs_total = max(
        1, (cipher_size + MAX_PACKAGE - 1) // MAX_PACKAGE)
    c_off = first_pkg * MAX_PACKAGE
    c_end = min((last_pkg + 1) * MAX_PACKAGE, cipher_size)
    blob = read_cipher(c_off, c_end - c_off)
    if len(blob) != c_end - c_off:
        raise DAREError("short ciphertext read")
    aead = _aead(key)
    out = bytearray()
    off = 0
    ref_nonce: bytes | None = None
    for seq in range(first_pkg, last_pkg + 1):
        end = min(off + MAX_PACKAGE, len(blob))
        final = seq == n_pkgs_total - 1
        plain, base = _decrypt_package(aead, blob[off:end], seq, final,
                                       expect_base=ref_nonce)
        ref_nonce = base
        out += plain
        off = end
    skip = offset - first_pkg * MAX_PAYLOAD
    return bytes(out[skip:skip + length])

"""AES-GCM from the system libcrypto through ctypes
(``minio_tpu/crypto/libcrypto.py``).

The card's machine has no ``cryptography`` package, but every image the
port runs on has the OpenSSL ``libcrypto`` that the stdlib ``ssl``
module links.  This module binds its EVP AEAD interface
(``EVP_aes_{128,192,256}_gcm``) and offers an ``AESGCM`` with the
``cryptography`` class's calls, so DARE (``crypto/dare.py``) seals
config.json and iam.json on any image.  It is the port's only AES-GCM:
the ``cryptography`` package is never imported.

One EVP context per call: no shared mutable state, so concurrent calls
from the request threads need no lock.
"""

from __future__ import annotations

import ctypes
import ctypes.util

# EVP_CIPHER_CTX_ctrl commands (openssl/evp.h — stable ABI constants)
_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11

TAG_SIZE = 16


class InvalidTag(Exception):
    """GCM authentication failed (ciphertext or AAD tampered)."""


class LibcryptoError(Exception):
    """libcrypto missing or an EVP call failed unexpectedly."""


_lib = None
_load_error = ""


def _bind(lib) -> None:
    """Declare the EVP prototypes we call (pointer widths must be
    right on 64-bit — default int restype would truncate EVP_CIPHER_CTX
    pointers)."""
    lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
    lib.EVP_CIPHER_CTX_new.argtypes = []
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
    for name in ("EVP_aes_128_gcm", "EVP_aes_192_gcm",
                 "EVP_aes_256_gcm"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = []
    for name in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_char_p,
                       ctypes.c_char_p]
    lib.EVP_CIPHER_CTX_ctrl.restype = ctypes.c_int
    lib.EVP_CIPHER_CTX_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    for name in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                       ctypes.c_int]
    for name in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_int)]


def _load():
    """dlopen the libcrypto the process's ssl module already maps (the
    soname search covers 1.1 and 3.x layouts); memoized either way."""
    global _lib, _load_error
    if _lib is not None or _load_error:
        return _lib
    names = []
    found = ctypes.util.find_library("crypto")
    if found:
        names.append(found)
    names += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so",
              "libcrypto.dylib"]
    err = []
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            _bind(lib)
            _lib = lib
            return _lib
        except (OSError, AttributeError) as e:
            err.append(f"{name}: {e}")
    _load_error = "; ".join(err) or "no libcrypto candidate found"
    return None


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    _load()
    return _load_error


_GCM_BY_KEYLEN = {16: "EVP_aes_128_gcm", 24: "EVP_aes_192_gcm",
                  32: "EVP_aes_256_gcm"}


class AESGCM:
    """Drop-in for ``cryptography``'s AESGCM over the EVP interface:
    ``encrypt(nonce, data, aad) -> ciphertext || tag`` and
    ``decrypt(nonce, ciphertext || tag, aad)`` raising
    :class:`InvalidTag` on authentication failure."""

    def __init__(self, key: bytes):
        if _load() is None:
            raise LibcryptoError(
                f"libcrypto unavailable: {_load_error}")
        cipher_name = _GCM_BY_KEYLEN.get(len(key))
        if cipher_name is None:
            raise ValueError("AESGCM key must be 128, 192, or 256 bits")
        self._key = bytes(key)
        self._cipher = getattr(_lib, cipher_name)()

    def _ctx(self, nonce: bytes, encrypt: bool):
        init = _lib.EVP_EncryptInit_ex if encrypt \
            else _lib.EVP_DecryptInit_ex
        ctx = _lib.EVP_CIPHER_CTX_new()
        if not ctx:
            raise LibcryptoError("EVP_CIPHER_CTX_new failed")
        ok = init(ctx, self._cipher, None, None, None) == 1 and \
            _lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                     len(nonce), None) == 1 and \
            init(ctx, None, None, self._key, bytes(nonce)) == 1
        if not ok:
            _lib.EVP_CIPHER_CTX_free(ctx)
            raise LibcryptoError("EVP GCM init failed")
        return ctx

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None = None) -> bytes:
        data = bytes(data)
        ctx = self._ctx(nonce, encrypt=True)
        try:
            outl = ctypes.c_int(0)
            if associated_data:
                if _lib.EVP_EncryptUpdate(
                        ctx, None, ctypes.byref(outl),
                        bytes(associated_data),
                        len(associated_data)) != 1:
                    raise LibcryptoError("EVP AAD update failed")
            out = ctypes.create_string_buffer(len(data) or 1)
            n = 0
            if data:
                if _lib.EVP_EncryptUpdate(ctx, out, ctypes.byref(outl),
                                          data, len(data)) != 1:
                    raise LibcryptoError("EVP encrypt update failed")
                n = outl.value
            fin = ctypes.create_string_buffer(16)
            if _lib.EVP_EncryptFinal_ex(ctx, fin,
                                        ctypes.byref(outl)) != 1:
                raise LibcryptoError("EVP encrypt final failed")
            n += outl.value                  # 0 for GCM (stream mode)
            tag = ctypes.create_string_buffer(TAG_SIZE)
            if _lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG,
                                        TAG_SIZE, tag) != 1:
                raise LibcryptoError("EVP get-tag failed")
            return out.raw[:n] + tag.raw
        finally:
            _lib.EVP_CIPHER_CTX_free(ctx)

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None = None) -> bytes:
        data = bytes(data)
        if len(data) < TAG_SIZE:
            raise InvalidTag("ciphertext shorter than the GCM tag")
        ct, tag = data[:-TAG_SIZE], data[-TAG_SIZE:]
        ctx = self._ctx(nonce, encrypt=False)
        try:
            outl = ctypes.c_int(0)
            if associated_data:
                if _lib.EVP_DecryptUpdate(
                        ctx, None, ctypes.byref(outl),
                        bytes(associated_data),
                        len(associated_data)) != 1:
                    raise LibcryptoError("EVP AAD update failed")
            out = ctypes.create_string_buffer(len(ct) or 1)
            n = 0
            if ct:
                if _lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl),
                                          ct, len(ct)) != 1:
                    raise InvalidTag("authentication failed")
                n = outl.value
            if _lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_TAG,
                                        TAG_SIZE, tag) != 1:
                raise LibcryptoError("EVP set-tag failed")
            fin = ctypes.create_string_buffer(16)
            if _lib.EVP_DecryptFinal_ex(ctx, fin,
                                        ctypes.byref(outl)) != 1:
                # the ONLY authenticated verdict: tag mismatch
                raise InvalidTag("authentication failed")
            n += outl.value
            return out.raw[:n]
        finally:
            _lib.EVP_CIPHER_CTX_free(ctx)

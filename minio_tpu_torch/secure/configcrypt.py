"""Config and IAM sealed at rest (``minio_tpu/secure/configcrypt.py``,
cmd/config-encrypted.go and madmin.EncryptData).

``config/config.json`` and ``config/iam.json`` live in the system volume
of every drive of the metadata set, and sealed, so a drive image leaks
no credential.  A blob is::

    MAGIC (8 bytes) || salt (16 bytes) || DARE 2.0 ciphertext

under a key derived from the admin secret with PBKDF2-HMAC-SHA256
(10,000 iterations: one derivation per IAM mutation or config set, and
per blob read at start, never on the data path).  The prefix tells sealed from
plaintext, so ``maybe_decrypt`` reads a plaintext blob or one sealed
under a retired secret (``MT_ADMIN_SECRET_OLD``) and asks the caller to
reseal it under the current one.  The bytes are the reference's.

Unlike the reference, which writes plaintext when it has no AES-GCM
(``minio_tpu/secure/configcrypt.py:59-66``), ``encrypt_data`` raises
without libcrypto: the port never persists a credential in the clear.
"""

from __future__ import annotations

import hashlib
import os

from ..crypto import dare

MAGIC = b"MTCFGE1\x00"
SALT_SIZE = 16
PBKDF2_ITERS = 10_000


class DecryptError(Exception):
    """A sealed blob that no offered secret opens."""


def encryption_available() -> bool:
    return dare.backend_available()


def require_encryption() -> None:
    """Raise unless sealing can run (the server refuses to start
    without it)."""
    if not encryption_available():
        from ..crypto import libcrypto
        raise RuntimeError("config and IAM are sealed at rest with "
                           "AES-GCM from libcrypto, which cannot be bound: "
                           f"{libcrypto.unavailable_reason()}")


def derive_key(secret: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", secret.encode(), salt,
                               PBKDF2_ITERS, dklen=dare.KEY_SIZE)


def is_encrypted(blob: bytes) -> bool:
    return bool(blob) and bytes(blob[:len(MAGIC)]) == MAGIC


def encrypt_data(secret: str, plaintext: bytes) -> bytes:
    """Seal; RuntimeError without libcrypto (never plaintext)."""
    require_encryption()
    salt = os.urandom(SALT_SIZE)
    return MAGIC + salt + dare.encrypt(derive_key(secret, salt), plaintext)


def decrypt_data(secret: str, blob: bytes) -> bytes:
    if not is_encrypted(blob):
        raise DecryptError("blob carries no encryption header")
    salt = bytes(blob[len(MAGIC):len(MAGIC) + SALT_SIZE])
    body = bytes(blob[len(MAGIC) + SALT_SIZE:])
    if len(salt) != SALT_SIZE or not body:
        raise DecryptError("truncated encrypted blob")
    try:
        return dare.decrypt(derive_key(secret, salt), body)
    except dare.DAREError as e:
        raise DecryptError(f"cannot decrypt: {e}") from e


def old_secrets_from_env() -> tuple[str, ...]:
    """Retired admin secrets offered at load: ``MT_ADMIN_SECRET_OLD``,
    comma-separated, newest first."""
    raw = os.environ.get("MT_ADMIN_SECRET_OLD", "")
    return tuple(s for s in (p.strip() for p in raw.split(",")) if s)


def maybe_decrypt(secret: str, blob: bytes,
                  old_secrets: tuple[str, ...] = ()) -> tuple[bytes, bool]:
    """Open one persisted blob, sealed or not: ``(plaintext, reseal)``,
    ``reseal`` True for a plaintext blob and for one that only a retired
    secret opens.  DecryptError when no offered secret opens it (the
    caller skips that copy)."""
    if not is_encrypted(blob):
        return bytes(blob), True
    last: DecryptError | None = None
    for cand, stale in ((secret, False), *((o, True) for o in old_secrets)):
        try:
            return decrypt_data(cand, blob), stale
        except DecryptError as e:
            last = e
    raise last or DecryptError("no credential offered")

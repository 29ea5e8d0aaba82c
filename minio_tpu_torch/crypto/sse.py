"""SSE-C, SSE-S3 and SSE-KMS: the request headers, the sealed object key
and the object's data path (``minio_tpu/crypto/sse.py``;
cmd/crypto/sse-c.go, sse-s3.go, sse-kms.go, cmd/encryption-v1.go).

Each object has a random object key (OEK).  SSE-C seals it under a key
derived from the client's key and the object's path; SSE-S3 and SSE-KMS
under one derived from a data key of the key service
(``crypto/kms.py``), whose sealed form is stored with it.  What is stored
lives in the object's internal metadata
(``x-minio-internal-server-side-encryption-*``), never a key in the
clear.  The body is one DARE stream (``crypto/dare.py``) under the OEK.

A multipart object is one DARE stream per part under the same OEK; the
object's part table gives each part's ciphertext size, so a ranged read
walks the part boundaries (``decrypt_object_range``, DecryptedSize over
``ObjectInfo.Parts``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
from typing import Callable, Optional

from . import dare
from .kms import KMSError, LocalKMS, default_kms

# --- request headers (cmd/crypto/header.go) --------------------------------
SSE_HEADER = "x-amz-server-side-encryption"
SSE_KMS_KEY_ID = "x-amz-server-side-encryption-aws-kms-key-id"
SSE_KMS_CONTEXT = "x-amz-server-side-encryption-context"
SSEC_ALGO = "x-amz-server-side-encryption-customer-algorithm"
SSEC_KEY = "x-amz-server-side-encryption-customer-key"
SSEC_KEY_MD5 = "x-amz-server-side-encryption-customer-key-md5"
SSEC_COPY_ALGO = \
    "x-amz-copy-source-server-side-encryption-customer-algorithm"
SSEC_COPY_KEY = "x-amz-copy-source-server-side-encryption-customer-key"
SSEC_COPY_KEY_MD5 = \
    "x-amz-copy-source-server-side-encryption-customer-key-md5"

# --- internal metadata (cmd/crypto/metadata.go) ----------------------------
META_IV = "x-minio-internal-server-side-encryption-iv"
META_SEAL_ALGO = "x-minio-internal-server-side-encryption-seal-algorithm"
META_SEALED_KEY = "x-minio-internal-server-side-encryption-sealed-key"
META_KMS_KEY_ID = "x-minio-internal-server-side-encryption-s3-kms-key-id"
META_KMS_SEALED = \
    "x-minio-internal-server-side-encryption-s3-kms-sealed-key"
# SSE-KMS uses distinct keys (reference: X-Minio-Internal-...-Kms-*) so the
# applied mode is reported back faithfully
META_KMSV_KEY_ID = "x-minio-internal-server-side-encryption-kms-key-id"
META_KMSV_SEALED = \
    "x-minio-internal-server-side-encryption-kms-sealed-key"
META_SSEC_KEY_MD5 = \
    "x-minio-internal-server-side-encryption-ssec-key-md5"
META_ACTUAL_SIZE = "x-minio-internal-actual-size"
META_PART_SIZES = "x-minio-internal-encrypted-part-sizes"

SEAL_ALGORITHM = "DAREv2-HMAC-SHA256"


class SSEError(Exception):
    """Carries an S3 error code."""

    def __init__(self, code: str, msg: str = ""):
        super().__init__(msg or code)
        self.code = code


def _b64_32(value: str) -> bytes:
    try:
        key = base64.b64decode(value, validate=True)
    except Exception as e:
        raise SSEError("InvalidArgument",
                       "invalid base64 customer key") from e
    if len(key) != 32:
        raise SSEError("InvalidArgument", "customer key must be 256 bits")
    return key


def parse_ssec(headers, copy_source: bool = False) -> Optional[bytes]:
    """Validate SSE-C headers -> 32-byte client key, or None if absent
    (cmd/crypto/sse-c.go ParseHTTP)."""
    a, k, m = ((SSEC_COPY_ALGO, SSEC_COPY_KEY, SSEC_COPY_KEY_MD5)
               if copy_source else (SSEC_ALGO, SSEC_KEY, SSEC_KEY_MD5))
    algo = headers.get(a)
    key_b64 = headers.get(k)
    md5_b64 = headers.get(m)
    if algo is None and key_b64 is None and md5_b64 is None:
        return None
    if algo != "AES256":
        raise SSEError("InvalidEncryptionAlgorithmError")
    if not key_b64 or not md5_b64:
        raise SSEError("InvalidArgument", "missing SSE-C key or MD5")
    key = _b64_32(key_b64)
    want = base64.b64encode(hashlib.md5(key).digest()).decode()
    if want != md5_b64:
        raise SSEError("SSECustomerKeyMD5Mismatch")
    return key


def requested_sse(headers, bucket_sse_algo: str = "") -> str:
    """Which SSE applies to a PUT: '', 'SSE-C', 'SSE-S3', 'SSE-KMS'.
    Bucket default encryption (cmd/bucket-encryption.go) applies when no
    explicit headers are present."""
    if parse_ssec(headers) is not None:
        if headers.get(SSE_HEADER):
            raise SSEError("InvalidArgument",
                           "SSE-C cannot be combined with SSE-S3/KMS")
        return "SSE-C"
    algo = headers.get(SSE_HEADER, "")
    if algo == "AES256":
        return "SSE-S3"
    if algo == "aws:kms":
        return "SSE-KMS"
    if algo:
        raise SSEError("InvalidEncryptionAlgorithmError")
    if bucket_sse_algo == "AES256":
        return "SSE-S3"
    if bucket_sse_algo == "aws:kms":
        return "SSE-KMS"
    return ""


def _derive_kek(client_key: bytes, bucket: str, obj: str) -> bytes:
    """KEK from the SSE-C client key, domain-separated by object path so
    the same client key on two objects seals differently
    (cmd/crypto/key.go ObjectKey derivation)."""
    return hmac.new(client_key,
                    f"{SEAL_ALGORITHM}\x00{bucket}/{obj}".encode(),
                    hashlib.sha256).digest()


class ObjectEncryption:
    """Sealed per-object encryption state: produces/consumes the internal
    metadata entries and exposes the OEK for the data path."""

    def __init__(self, oek: bytes, meta: dict[str, str]):
        self.oek = oek
        self.meta = meta

    # -- creation (PUT path) -----------------------------------------------

    @staticmethod
    def new(kind: str, bucket: str, obj: str, headers=None,
            kms: LocalKMS | None = None) -> "ObjectEncryption":
        oek = os.urandom(32)
        if kind == "SSE-C":
            client_key = parse_ssec(headers)
            if client_key is None:
                raise SSEError("InvalidArgument", "missing SSE-C headers")
            sealed = dare.encrypt(_derive_kek(client_key, bucket, obj), oek)
            meta = {
                META_SEAL_ALGO: SEAL_ALGORITHM,
                META_SEALED_KEY: base64.b64encode(sealed).decode(),
                META_SSEC_KEY_MD5: headers.get(SSEC_KEY_MD5, ""),
            }
            return ObjectEncryption(oek, meta)
        if kind in ("SSE-S3", "SSE-KMS"):
            kms = kms or default_kms()
            context = {"bucket": bucket, "object": obj}
            data_key, sealed_blob = kms.generate_key(context)
            sealed = dare.encrypt(_derive_kek(data_key, bucket, obj), oek)
            id_key, blob_key = (
                (META_KMS_KEY_ID, META_KMS_SEALED) if kind == "SSE-S3"
                else (META_KMSV_KEY_ID, META_KMSV_SEALED))
            meta = {
                META_SEAL_ALGO: SEAL_ALGORITHM,
                META_SEALED_KEY: base64.b64encode(sealed).decode(),
                id_key: kms.key_id,
                blob_key: sealed_blob,
            }
            return ObjectEncryption(oek, meta)
        raise SSEError("InvalidArgument", f"unknown SSE kind {kind}")

    # -- recovery (GET path) -----------------------------------------------

    @staticmethod
    def kind_of(meta: dict[str, str]) -> str:
        if META_SEALED_KEY not in meta:
            return ""
        if META_KMSV_SEALED in meta:
            return "SSE-KMS"
        if META_KMS_SEALED in meta:
            return "SSE-S3"
        return "SSE-C"

    @staticmethod
    def open(meta: dict[str, str], bucket: str, obj: str, headers=None,
             kms: LocalKMS | None = None,
             copy_source: bool = False) -> "ObjectEncryption":
        kind = ObjectEncryption.kind_of(meta)
        if not kind:
            raise SSEError("InvalidArgument", "object is not encrypted")
        sealed = base64.b64decode(meta[META_SEALED_KEY])
        if kind == "SSE-C":
            client_key = parse_ssec(headers, copy_source=copy_source)
            if client_key is None:
                raise SSEError("SSEEncryptedObject")
            want_md5 = meta.get(META_SSEC_KEY_MD5, "")
            got_md5 = base64.b64encode(
                hashlib.md5(client_key).digest()).decode()
            if want_md5 and want_md5 != got_md5:
                raise SSEError("AccessDenied", "SSE-C key mismatch")
            kek = _derive_kek(client_key, bucket, obj)
        else:
            kms = kms or default_kms()
            blob = meta.get(META_KMSV_SEALED) or meta[META_KMS_SEALED]
            try:
                data_key = kms.unseal_key(blob,
                                          {"bucket": bucket, "object": obj})
            except KMSError as e:
                raise SSEError("InternalError", str(e)) from e
            kek = _derive_kek(data_key, bucket, obj)
        try:
            oek = dare.decrypt(kek, sealed)
        except dare.DAREError as e:
            raise SSEError("AccessDenied",
                           "failed to unseal object key") from e
        return ObjectEncryption(oek, dict(meta))

    # -- data path ---------------------------------------------------------

    def encrypt(self, plaintext: bytes) -> bytes:
        return dare.encrypt(self.oek, plaintext)

    def decrypt(self, ciphertext: bytes) -> bytes:
        try:
            return dare.decrypt(self.oek, ciphertext)
        except dare.DAREError as e:
            raise SSEError("InternalError", str(e)) from e


def is_encrypted(meta: dict[str, str]) -> bool:
    return META_SEALED_KEY in meta


def decrypted_size(meta: dict[str, str], cipher_size: int,
                   parts: list[tuple[int, int]] | None = None) -> int:
    """DARE-plaintext size of a stored encrypted object, computed from the
    package math.  (META_ACTUAL_SIZE is the pre-compression size and may
    differ when the object is compressed-then-encrypted.)"""
    sizes = part_cipher_sizes(meta, cipher_size, parts)
    return sum(dare.plaintext_size(s) for s in sizes)


def part_cipher_sizes(meta: dict[str, str], cipher_size: int,
                      parts: list[tuple[int, int]] | None = None
                      ) -> list[int]:
    """Per-part ciphertext sizes ([whole size] for single-stream objects).

    The authoritative source is the object's committed part table
    (ObjectInfo.parts, persisted atomically by CompleteMultipartUpload) —
    each part is its own DARE stream.
    """
    if parts:
        sizes = [s for _, s in sorted(parts)]
        if sum(sizes) != cipher_size:
            raise SSEError("InternalError",
                           "encrypted part sizes inconsistent")
        return sizes
    raw = meta.get(META_PART_SIZES)
    if not raw:
        return [cipher_size]
    sizes = json.loads(raw)
    if sum(sizes) != cipher_size:
        raise SSEError("InternalError", "encrypted part sizes inconsistent")
    return sizes


def cipher_range(meta: dict[str, str], cipher_size: int, offset: int,
                 length: int, parts: list[tuple[int, int]] | None = None
                 ) -> tuple[int, int]:
    """[start, end) of the stored bytes that hold the DARE packages
    covering plaintext [offset, offset + length), across part streams;
    ``length`` > 0 and the range within the object."""
    sizes = part_cipher_sizes(meta, cipher_size, parts)
    end = offset + length
    start = None
    p_start = c_start = 0
    for psize_c in sizes:
        p_end = p_start + dare.plaintext_size(psize_c)
        if start is None and offset < p_end:
            start = c_start + (offset - p_start) // dare.MAX_PAYLOAD \
                * dare.MAX_PACKAGE
        if end <= p_end:
            last = (end - 1 - p_start) // dare.MAX_PAYLOAD
            return start, c_start + min((last + 1) * dare.MAX_PACKAGE,
                                        psize_c)
        p_start = p_end
        c_start += psize_c
    raise SSEError("InvalidRange")


def response_headers(meta: dict[str, str]) -> dict[str, str]:
    """Headers a GET/HEAD/PUT response must carry for an encrypted object
    (cmd/encryption-v1.go DecryptObjectInfo response side)."""
    kind = ObjectEncryption.kind_of(meta)
    if kind == "SSE-C":
        return {SSEC_ALGO: "AES256",
                SSEC_KEY_MD5: meta.get(META_SSEC_KEY_MD5, "")}
    if kind == "SSE-S3":
        return {SSE_HEADER: "AES256"}
    if kind == "SSE-KMS":
        hdrs = {SSE_HEADER: "aws:kms"}
        if meta.get(META_KMSV_KEY_ID):
            hdrs[SSE_KMS_KEY_ID] = meta[META_KMSV_KEY_ID]
        return hdrs
    return {}


def decrypt_object_range(
        enc: ObjectEncryption, meta: dict[str, str], cipher_size: int,
        read_cipher: Callable[[int, int], bytes],
        offset: int, length: int,
        parts: list[tuple[int, int]] | None = None) -> bytes:
    """Ranged decrypt across (possibly multipart) DARE streams.

    offset/length are in plaintext space; negative offset means suffix
    range (last -offset bytes), length -1 means to-end — matching the
    object layer's range contract.  Only covering packages are read.
    """
    sizes = part_cipher_sizes(meta, cipher_size, parts)
    plain_sizes = [dare.plaintext_size(s) for s in sizes]
    total_plain = sum(plain_sizes)
    if offset < 0:
        offset = max(0, total_plain + offset)
        length = total_plain - offset
    if length < 0:
        length = total_plain - offset
    if offset > total_plain:
        raise SSEError("InvalidRange")
    length = min(length, total_plain - offset)
    out = bytearray()
    part_plain_start = 0
    part_cipher_start = 0
    remaining = length
    pos = offset
    for psize_c, psize_p in zip(sizes, plain_sizes):
        part_plain_end = part_plain_start + psize_p
        if remaining > 0 and pos < part_plain_end:
            in_off = pos - part_plain_start
            take = min(remaining, part_plain_end - pos)
            cs = part_cipher_start     # closure-safe copy

            def read_part(o: int, n: int, _cs=cs) -> bytes:
                return read_cipher(_cs + o, n)

            out += dare.decrypt_range(enc.oek, read_part, psize_c,
                                      in_off, take)
            pos += take
            remaining -= take
        part_plain_start = part_plain_end
        part_cipher_start += psize_c
        if remaining == 0:
            break
    return bytes(out)

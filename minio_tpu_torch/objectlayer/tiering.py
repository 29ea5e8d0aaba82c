"""What the S3 front reads of an object transitioned to a remote tier
(``minio_tpu/objectlayer/tiering.py``:30-35, :143-170): the stub's
metadata names, whether a version is such a stub, and whether a restored
copy is valid.  The port does not transition or restore objects (ROADMAP
Queue 1 item 16.6); it answers for the stubs ``minio_tpu`` left on the
drives as the reference answers."""

from __future__ import annotations

import time

META_STATUS = "x-minio-internal-transition-status"      # "complete"
META_TIER = "x-minio-internal-transition-tier"
META_KEY = "x-minio-internal-transitioned-object"
META_SIZE = "x-minio-internal-transition-size"          # the original's
META_ETAG = "x-minio-internal-transition-etag"          # the original's
META_RESTORE_EXPIRY = "x-minio-internal-restore-expiry"  # unix seconds

RESTORE_HDR = "x-amz-restore"
STORAGE_CLASS_HDR = "x-amz-storage-class"


def is_transitioned(user_defined: dict) -> bool:
    return user_defined.get(META_STATUS) == "complete"


def restore_expiry(user_defined: dict) -> int:
    try:
        return int(user_defined.get(META_RESTORE_EXPIRY, "0"))
    except ValueError:
        return 0


def restore_valid(user_defined: dict) -> bool:
    return restore_expiry(user_defined) > time.time()


def restore_header(user_defined: dict) -> str:
    """The ``x-amz-restore`` value of a stub's HEAD and GET."""
    exp = restore_expiry(user_defined)
    if not exp:
        return ""
    if exp > time.time():
        date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(exp))
        return f'ongoing-request="false", expiry-date="{date}"'
    return ""

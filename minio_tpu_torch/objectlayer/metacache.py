"""Listing pagination (``minio_tpu/objectlayer/metacache.py``), without
its metacache.

Only ``paginate`` and the V2 continuation tokens are ported: every
listing walks the drives afresh (``ErasureObjects.list_objects``, the
reference's own no-cache path).  The persisted block cache that serves
continuation pages from a snapshot of the walk is not, and stands in
ROADMAP.
"""

from __future__ import annotations

import base64
import json
from typing import Iterable

from .interface import ListObjectsInfo, ObjectInfo

_TOKEN_PREFIX = "mt1-"


def paginate(entries: Iterable[ObjectInfo], prefix: str, marker: str,
             delimiter: str, max_keys: int) -> ListObjectsInfo:
    """Delimiter roll-up and marker pagination over entries sorted by
    name (cmd/metacache-entries.go filterPrefix/forwardTo).  ``entries``
    is consumed once and only as far as the page needs.  The marker
    compares against the rolled-up item, so resuming from a common
    prefix skips the whole prefix."""
    out = ListObjectsInfo()
    prefixes: set[str] = set()
    for oi in entries:
        name = oi.name
        if prefix and not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        item = prefix + rest.split(delimiter, 1)[0] + delimiter \
            if delimiter and delimiter in rest else None
        if marker and (item or name) <= marker:
            continue
        if item is not None:
            if item in prefixes:
                continue
            prefixes.add(item)
            if len(out.objects) + len(prefixes) >= max_keys:
                out.is_truncated = True
                out.next_marker = item
                break
            continue
        out.objects.append(oi)
        if len(out.objects) + len(prefixes) >= max_keys:
            out.is_truncated = True
            out.next_marker = name
            break
    out.prefixes = sorted(prefixes)
    return out


def encode_list_token(key: str) -> str:
    """The opaque NextContinuationToken for a resume key."""
    raw = base64.urlsafe_b64encode(
        json.dumps({"k": key}, separators=(",", ":")).encode()).decode()
    return _TOKEN_PREFIX + raw.rstrip("=")


def decode_list_token(token: str) -> str:
    """The resume key of a continuation token.  A token without our
    prefix passes through as a raw key; one with it that does not decode
    raises ValueError (the front answers InvalidArgument)."""
    if not token.startswith(_TOKEN_PREFIX):
        return token
    raw = token[len(_TOKEN_PREFIX):]
    try:
        key = json.loads(base64.urlsafe_b64decode(
            raw + "=" * (-len(raw) % 4)))["k"]
        if not isinstance(key, str):
            raise TypeError(key)
    except Exception as e:  # noqa: BLE001 — any failure is a bad token
        raise ValueError("invalid continuation token") from e
    return key

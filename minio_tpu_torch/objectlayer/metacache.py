"""Listing pagination (``minio_tpu/objectlayer/metacache.py``), without
its metacache.

Only ``paginate``, ``paginate_versions`` and the V2 continuation tokens
are ported: every listing walks the drives afresh (``ErasureObjects.list_objects``, the
reference's own no-cache path).  The persisted block cache that serves
continuation pages from a snapshot of the walk is not, and stands in
ROADMAP.
"""

from __future__ import annotations

import base64
import json
from typing import Iterable

from .interface import ListObjectsInfo, ListObjectVersionsInfo, ObjectInfo

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


def paginate_versions(versions: Iterable[ObjectInfo], key_marker: str,
                      version_id_marker: str,
                      max_keys: int) -> ListObjectVersionsInfo:
    """Key and version-id marker pagination over versions sorted by key,
    newest first within a key (ListObjectVersions): the page starts after
    ``key_marker``, or with ``version_id_marker`` after that version of
    ``key_marker`` ("null" names the null version).  At most ``max_keys``
    versions (all when negative); a full page names the last version as
    the next markers."""
    out = ListObjectVersionsInfo()
    passed = False                  # past the version-id marker
    for oi in versions:
        if key_marker:
            if oi.name < key_marker:
                continue
            if oi.name == key_marker and not passed:
                passed = bool(version_id_marker) and \
                    (oi.version_id or "null") == version_id_marker
                continue
        if 0 <= max_keys <= len(out.objects):
            if out.objects:
                last = out.objects[-1]
                out.is_truncated = True
                out.next_key_marker = last.name
                out.next_version_id_marker = last.version_id or "null"
            break
        out.objects.append(oi)
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

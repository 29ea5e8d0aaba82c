"""The listing metacache and pagination (``minio_tpu/objectlayer/
metacache.py``; cmd/metacache-manager.go, cmd/metacache-set.go,
cmd/metacache-entries.go).

A listing walks an erasure set's drives once per (bucket, prefix): the
``MetacacheManager`` seals the resolved entries into sorted blocks of
``block_entries`` as the walk yields them, writes each block to the
first drive that takes it (``.mt.sys/metacache/<bucket>/<hash>/<id>/
b000000.json``) and keeps only ``cache_blocks`` of them in memory.  A
manifest (id, creation time, the manager's uuid and the bucket's
mutation generation, the last key of each block) follows the walk, so
another process, or this one after a restart, reuses the blocks.  Every
later page of the snapshot bisects the last-key index to the one block
that covers its marker.  The walk charges its working set to the memory
governor (``listing``): past the watermark the listing is shed with
503.  A mutation of the layer invalidates the bucket's snapshots at once
(``invalidate``, which bumps its generation: a walk that overlapped the
mutation serves its caller but is neither cached nor kept); everything
else expires after ``DEFAULT_TTL`` or, with a data-update tracker
attached, as soon as the tracker saw the bucket change.  The block and
manifest files are the reference's, byte for byte: either package reads
what the other wrote.

``paginate`` and ``paginate_versions`` page any sorted entry iterable,
consumed only as far as the page needs; the V2 continuation tokens are
opaque wrappers of the resume key.
"""

from __future__ import annotations

import base64
import bisect
import hashlib
import json
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import asdict
from typing import Callable, Iterable, List, Optional

from ..utils.memgov import GOVERNOR
from .interface import ListObjectsInfo, ListObjectVersionsInfo, ObjectInfo

# snapshot life (seconds); local writes invalidate at once, so the TTL
# bounds only what another process wrote
DEFAULT_TTL = 15.0
_SYS_PREFIX = "metacache"       # under the drives' system volume
# entries per persisted block, and blocks kept in memory per snapshot
BLOCK_ENTRIES = 1000
CACHE_BLOCKS = 4
# the working set per entry the walk charges to the memory governor
_EST_ENTRY_BYTES = 512
_TOKEN_PREFIX = "mt1-"


class SnapshotGone(Exception):
    """A persisted block vanished under a live snapshot (an invalidate
    race, a drive gone): the caller forgets the snapshot and re-walks."""


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


def encode_list_token(key: str, snap_id: str = "", gen: int = -1) -> str:
    """The opaque NextContinuationToken for a resume key, with the
    snapshot id and generation as advisory fields (a token that outlives
    its snapshot resumes from the key over a fresh walk)."""
    doc: dict = {"k": key}
    if snap_id:
        doc["i"] = snap_id
    if gen >= 0:
        doc["g"] = gen
    raw = base64.urlsafe_b64encode(
        json.dumps(doc, separators=(",", ":")).encode()).decode()
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


# -- persisted blocks (the reference's files) ----------------------------------

def _cache_dir(bucket: str, prefix: str) -> str:
    h = hashlib.sha256(f"{bucket}\x00{prefix}".encode()).hexdigest()[:24]
    return f"{_SYS_PREFIX}/{bucket}/{h}"


def _entries_doc(entries: List[ObjectInfo]) -> list:
    """The reference's ``asdict(ObjectInfo)`` per entry: its ``is_dir``
    (always false for a listed object) sits before ``parts``."""
    out = []
    for e in entries:
        d = asdict(e)
        parts = d.pop("parts")
        d["is_dir"] = False
        d["parts"] = parts
        out.append(d)
    return out


def _entries_from(doc: list) -> List[ObjectInfo]:
    out = []
    for e in doc:
        e.pop("is_dir", None)
        e["parts"] = [tuple(p) for p in e.get("parts", [])]
        out.append(ObjectInfo(**e))
    return out


def leaf_layers_of(layer) -> list:
    """Every erasure set under a layer (a sets layer's, or every pool's
    of a pools layer)."""
    if hasattr(layer, "sets"):
        return [x for s in layer.sets for x in leaf_layers_of(s)]
    return [layer]


def managers_of(layer) -> list["MetacacheManager"]:
    """Every MetacacheManager under a layer."""
    return [leaf.metacache for leaf in leaf_layers_of(layer)
            if getattr(leaf, "metacache", None) is not None]


class BlockedSnapshot:
    """One listing snapshot: sorted entry blocks addressed by the last
    key of each.  Blocks live on a drive and in a small in-memory LRU;
    ``iter_from`` bisects the index, so a page loads the block that
    covers its marker."""

    def __init__(self, mgr: "MetacacheManager | None", bucket: str,
                 prefix: str, *, id: str, created: float, mgr_id: str,
                 gen: int):
        self._mgr = mgr
        self.bucket = bucket
        self.prefix = prefix
        self.id = id
        self.created = created
        self.mgr = mgr_id
        self.gen = gen
        self.block_keys: list[str] = []     # last key of each block
        self._blocks: OrderedDict[int, List[ObjectInfo]] = OrderedDict()
        self._pinned: set[int] = set()      # not on a drive: never evicted
        self._disk = None                   # the drive holding the blocks
        self._mu = threading.Lock()

    def expired(self, ttl: float, now: float | None = None) -> bool:
        return ((now if now is not None else time.time())
                - self.created) > ttl

    def _block_path(self, i: int) -> str:
        return f"{_cache_dir(self.bucket, self.prefix)}/{self.id}" \
               f"/b{i:06d}.json"

    def _block(self, i: int) -> List[ObjectInfo]:
        with self._mu:
            blk = self._blocks.get(i)
            if blk is not None:
                self._blocks.move_to_end(i)
                return blk
        blk = self._load_block(i)
        with self._mu:
            self._blocks[i] = blk
            self._blocks.move_to_end(i)
            self._evict_locked()
        return blk

    def _evict_locked(self) -> None:
        limit = self._mgr.cache_blocks if self._mgr is not None \
            else CACHE_BLOCKS
        evictable = [i for i in self._blocks if i not in self._pinned]
        while evictable and len(self._blocks) > limit:
            self._blocks.pop(evictable.pop(0), None)

    def _load_block(self, i: int) -> List[ObjectInfo]:
        """Block ``i`` from the drive that wrote it, else any drive;
        SnapshotGone when none holds it."""
        mgr = self._mgr
        if mgr is None or not mgr._disks or not mgr._sys_volume:
            raise SnapshotGone(f"block {i} of {self.id} not in memory")
        drives = [self._disk] if self._disk is not None else []
        drives += [d for d in mgr._disks if d is not self._disk]
        path = self._block_path(i)
        for d in drives:
            try:
                doc = json.loads(d.read_all(mgr._sys_volume, path))
                if doc.get("id") != self.id:
                    continue
                return _entries_from(doc["entries"])
            except Exception:  # noqa: BLE001 — missing or corrupt: next
                continue
        raise SnapshotGone(f"block {i} of {self.id} unreadable")

    def iter_from(self, marker: str = "") -> Iterable[ObjectInfo]:
        """Entries in key order from the first block that can hold a key
        past ``marker``; ``paginate`` filters within it."""
        start = bisect.bisect_right(self.block_keys, marker) \
            if marker else 0
        for i in range(start, len(self.block_keys)):
            yield from self._block(i)

    def drop_persisted(self) -> None:
        """Remove this snapshot's blocks, best effort."""
        mgr = self._mgr
        if mgr is None or self._disk is None:
            return
        try:
            self._disk.delete(
                mgr._sys_volume,
                f"{_cache_dir(self.bucket, self.prefix)}/{self.id}",
                recursive=True)
        except Exception:  # noqa: BLE001 — best effort
            pass


class MetacacheManager:
    """One erasure set's snapshots (cmd/metacache-manager.go).  With
    ``disks`` and ``sys_volume`` the blocks and manifests persist in the
    drives' system volume."""

    def __init__(self, disks: Optional[list] = None,
                 ttl: float = DEFAULT_TTL, max_caches: int = 128,
                 sys_volume: str = "", block_entries: int = BLOCK_ENTRIES,
                 cache_blocks: int = CACHE_BLOCKS):
        self._caches: dict[tuple, BlockedSnapshot] = {}
        self._mu = threading.Lock()
        self._disks = disks or []
        self._ttl = ttl
        self._max = max_caches
        self._sys_volume = sys_volume
        self.block_entries = max(1, block_entries)
        self.cache_blocks = max(1, cache_blocks)
        self.hits = 0
        self.misses = 0
        # buckets known to have no snapshot on the drives: an invalidate
        # of one skips the per-drive recursive delete, so only the first
        # write after a persisted snapshot pays it
        self._clean_buckets: set = set()
        # per-bucket mutation generation: a walk that overlapped a
        # mutation must not install what it saw after the mutation's
        # invalidate ran.  Stamped with the manager's uuid into each
        # manifest, so this manager refuses its own stale manifests.
        self._gen: dict = {}
        self._uuid = uuid.uuid4().hex
        # a DataUpdateTracker, when attached: a snapshot is stale once its
        # bucket changed at or after the snapshot's creation
        self.tracker = None

    def _stale(self, snap) -> bool:
        """``created`` is taken before the walk, so a write during the
        walk makes the next lookup walk again; ``>=`` errs toward an
        extra walk, never a stale listing."""
        return self.tracker is not None and \
            self.tracker.bucket_changed_at(snap.bucket) >= snap.created

    # -- at rest ---------------------------------------------------------------

    def _manifest_path(self, bucket: str, prefix: str) -> str:
        return f"{_cache_dir(bucket, prefix)}/manifest.json"

    def _persist_block(self, snap: BlockedSnapshot, i: int,
                       entries: List[ObjectInfo], was_clean: bool) -> bool:
        """Write block ``i`` to the snapshot's drive (the first that
        takes the first block).  The first block of a walk in a bucket
        that was not clean drops the previous snapshot's blocks first."""
        if not self._disks or not self._sys_volume:
            return False
        blob = json.dumps({"id": snap.id,
                           "entries": _entries_doc(entries)}).encode()
        drives = [snap._disk] if snap._disk is not None else self._disks
        for d in drives:
            try:
                if snap._disk is None and not was_clean:
                    try:
                        old = json.loads(d.read_all(
                            self._sys_volume,
                            self._manifest_path(snap.bucket, snap.prefix)))
                        if old.get("id") and old["id"] != snap.id:
                            d.delete(
                                self._sys_volume,
                                f"{_cache_dir(snap.bucket, snap.prefix)}"
                                f"/{old['id']}", recursive=True)
                    except Exception:  # noqa: BLE001 — no old manifest
                        pass
                d.write_all(self._sys_volume, snap._block_path(i), blob)
                snap._disk = d
                return True
            except Exception:  # noqa: BLE001 — the next drive (the first
                continue       # block only; later the snapshot degrades)
        return False

    def _write_manifest(self, snap: BlockedSnapshot) -> bool:
        if snap._disk is None or not self._sys_volume:
            return False
        doc = {"id": snap.id, "bucket": snap.bucket,
               "prefix": snap.prefix, "created": snap.created,
               "mgr": snap.mgr, "gen": snap.gen,
               "block_keys": snap.block_keys}
        try:
            snap._disk.write_all(
                self._sys_volume,
                self._manifest_path(snap.bucket, snap.prefix),
                json.dumps(doc).encode())
            return True
        except Exception:  # noqa: BLE001 — reuse lost, the cache stands
            return False

    def _load_manifest(self, bucket: str,
                       prefix: str) -> Optional[BlockedSnapshot]:
        """The persisted snapshot of (bucket, prefix) from the first
        drive that has a manifest; None when it is expired, or is this
        manager's own from an older generation."""
        path = self._manifest_path(bucket, prefix)
        for d in self._disks:
            try:
                doc = json.loads(d.read_all(self._sys_volume, path))
                snap = BlockedSnapshot(
                    self, bucket, prefix, id=doc["id"],
                    created=doc["created"], mgr_id=doc.get("mgr", ""),
                    gen=doc.get("gen", -1))
                snap.block_keys = list(doc.get("block_keys", []))
                snap._disk = d
                if snap.mgr == self._uuid:
                    with self._mu:
                        if snap.gen != self._gen.get(bucket, 0):
                            return None
                if not snap.expired(self._ttl):
                    return snap
                return None
            except Exception:  # noqa: BLE001 — missing or corrupt: a miss
                continue
        return None

    def _drop_persisted(self, bucket: str) -> None:
        for d in self._disks:
            try:
                d.delete(self._sys_volume, f"{_SYS_PREFIX}/{bucket}",
                         recursive=True)
            except Exception:  # noqa: BLE001 — best effort
                pass

    # -- lookup and fill -------------------------------------------------------

    def list_path_stream(self, bucket: str, prefix: str,
                         loader: Callable[[], Iterable[ObjectInfo]]
                         ) -> BlockedSnapshot:
        """The snapshot of (bucket, prefix): in memory, else persisted,
        else built from ``loader()``, an iterator of entries sorted by
        name, consumed block by block (cmd/metacache-server-pool.go
        listPath)."""
        key = (bucket, prefix)
        now = time.time()
        with self._mu:
            snap = self._caches.get(key)
            if snap is not None and not snap.expired(self._ttl, now) \
                    and not self._stale(snap):
                self.hits += 1
                return snap
            gen_at_load = self._gen.get(bucket, 0)
        snap = self._load_manifest(bucket, prefix)
        if snap is not None and not self._stale(snap):
            self.hits += 1
            with self._mu:
                # an invalidate racing the read keeps its effect
                if self._gen.get(bucket, 0) == gen_at_load:
                    self._install_locked(key, snap)
            return snap
        self.misses += 1
        return self._build(bucket, prefix, loader, now)

    def _install_locked(self, key: tuple, snap: BlockedSnapshot) -> None:
        if len(self._caches) >= self._max and key not in self._caches:
            oldest = min(self._caches,
                         key=lambda k: self._caches[k].created)
            del self._caches[oldest]
        self._caches[key] = snap

    def _build(self, bucket: str, prefix: str,
               loader: Callable[[], Iterable[ObjectInfo]],
               now: float) -> BlockedSnapshot:
        """Walk, sealing blocks as they fill, under a ``listing`` charge
        of one filling block plus the in-memory LRU."""
        with self._mu:
            gen0 = self._gen.get(bucket, 0)
            was_clean = bucket in self._clean_buckets
            self._clean_buckets.discard(bucket)
        snap = BlockedSnapshot(self, bucket, prefix, id=uuid.uuid4().hex,
                               created=now, mgr_id=self._uuid, gen=gen0)
        charge = GOVERNOR.charge(
            (self.cache_blocks + 1) * self.block_entries * _EST_ENTRY_BYTES,
            "listing")
        persist_ok = True
        try:
            buf: List[ObjectInfo] = []
            for oi in loader():
                buf.append(oi)
                if len(buf) >= self.block_entries:
                    persist_ok = self._seal(snap, buf, was_clean,
                                            persist_ok)
                    buf = []
            if buf:
                persist_ok = self._seal(snap, buf, was_clean, persist_ok)
        finally:
            charge.release()
        with self._mu:
            fresh = self._gen.get(bucket, 0) == gen0
        if not fresh:
            # mutated during the walk: this caller pages it (listings are
            # eventually consistent), nobody else; what is in memory stays
            # so its pages need no deleted block
            with snap._mu:
                snap._pinned.update(snap._blocks)
            snap.drop_persisted()
            snap._disk = None
            return snap
        if persist_ok and snap._disk is not None:
            self._write_manifest(snap)
        with self._mu:
            if self._gen.get(bucket, 0) == gen0:
                self._install_locked((bucket, prefix), snap)
        return snap

    def _seal(self, snap: BlockedSnapshot, entries: List[ObjectInfo],
              was_clean: bool, persist_ok: bool) -> bool:
        """Index, persist and keep one block; after a failed write the
        snapshot keeps its later blocks pinned in memory (a cache never
        fails the listing)."""
        i = len(snap.block_keys)
        snap.block_keys.append(entries[-1].name)
        persisted = persist_ok and self._persist_block(snap, i, entries,
                                                       was_clean)
        with snap._mu:
            snap._blocks[i] = entries
            if not persisted:
                snap._pinned.add(i)
            snap._evict_locked()
        return persisted

    def forget(self, bucket: str, prefix: str) -> None:
        """Drop the (bucket, prefix) snapshot (after SnapshotGone)."""
        with self._mu:
            self._caches.pop((bucket, prefix), None)

    def invalidate(self, bucket: str) -> None:
        """Drop every snapshot of the bucket, in memory and on the
        drives (the mutation hook)."""
        with self._mu:
            self._gen[bucket] = self._gen.get(bucket, 0) + 1
            for key in [k for k in self._caches if k[0] == bucket]:
                del self._caches[key]
            if bucket in self._clean_buckets:
                return              # nothing persisted since the last drop
        self._drop_persisted(bucket)
        with self._mu:
            self._clean_buckets.add(bucket)

    def stats(self) -> dict:
        with self._mu:
            return {"caches": len(self._caches), "hits": self.hits,
                    "misses": self.misses}

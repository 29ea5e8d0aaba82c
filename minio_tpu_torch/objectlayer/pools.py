"""Server pools: several ``ErasureSets`` as one namespace that grows and
shrinks (``minio_tpu/objectlayer/pools.py``, cmd/erasure-server-pool.go:41,
cmd/erasure-server-pool-decom.go).

A new name goes to an active pool drawn by the crc32 of ``bucket/name``
over the pools' free bytes (getPoolIdx :255, getAvailablePoolIdx :182),
an existing one to the first active pool that holds it.  The topology
is a manifest sealed with ``secure/configcrypt`` on pool 0's metadata
set (``pools/manifest.json``; the highest version wins, a pool absent
from it was retired): ``attach_pool`` adds a pool under traffic,
``start_decommission`` marks one draining (no new names placed there,
reads and pinned uploads go on), and ``finish_decommission`` retires it
once the rebalancer (``background/rebalance.py``) has emptied it.  A
multipart upload stays on the pool that started it
(``pools/uploads/<uid>.json``).

Where this differs from the reference:

- A GET, HEAD or reader without a version id, when several pools hold
  the name (an overwrite placed on an active pool while the old copy
  waits on a draining one), serves the latest written copy; the
  reference serves the first pool's, the old body (ROADMAP Queue 3).
- Listings merge every pool's sets' snapshots into one sorted stream
  before paging, a name or version two pools hold listed once, a key's
  versions in time order across pools; the reference pages each pool
  from the same marker and unions the pages.
- One pool costs what ``ErasureSets`` costs: no existence probes.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import json
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..parallel.dsync import NamespaceLock
from ..secure import configcrypt
from ..storage.xl_storage import SYS_DIR
from .interface import (BucketInfo, InvalidUploadID, ListObjectsInfo,
                        ListObjectVersionsInfo, MultipartInfo, ObjectInfo,
                        ObjectNotFound, ObjectOptions, ReadQuorumError,
                        VersionNotFound)
from .metacache import paginate_versions
from .sets import ErasureSets, aggregate_health, list_leaves

MANIFEST_PATH = "pools/manifest.json"
UPLOADS_PREFIX = "pools/uploads"

STATUS_ACTIVE = "active"
STATUS_DRAINING = "draining"

# the manifest's set arguments the port builds a pool with; the device
# is the process's (pool 0's), never recorded
LAYOUT_KWARGS = ("parity", "block_size", "enforce_min_part_size")


@dataclass
class PoolSpec:
    """One manifest row: what re-attaches the pool after a restart.
    ``pool_id`` is the pool's format deployment id."""
    pool_id: str
    dirs: list[str] = field(default_factory=list)
    set_count: int = 1
    set_drive_count: int = 0
    status: str = STATUS_ACTIVE
    kwargs: dict = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {"id": self.pool_id, "dirs": self.dirs,
                "setCount": self.set_count,
                "setDriveCount": self.set_drive_count,
                "status": self.status, "kwargs": self.kwargs}

    @classmethod
    def from_doc(cls, doc: dict) -> "PoolSpec":
        return cls(doc.get("id", ""), list(doc.get("dirs", [])),
                   doc.get("setCount", 1), doc.get("setDriveCount", 0),
                   doc.get("status", STATUS_ACTIVE),
                   dict(doc.get("kwargs", {})))


def merge_versions(merged):
    """A key's versions from every pool, newest first, ``is_latest`` and
    ``num_versions`` over them all.  A version id two pools hold is
    listed once, the later written copy: a copy mid-move is the same
    version, but two null versions are an overwrite placed beside a
    draining pool's old copy, and the overwrite is the object."""
    for _, group in itertools.groupby(merged, key=lambda o: o.name):
        by_id: dict[str, object] = {}
        for o in group:
            had = by_id.get(o.version_id)
            if had is None or o.mod_time > had.mod_time:
                by_id[o.version_id] = o
        vs = sorted(by_id.values(), key=lambda o: o.mod_time, reverse=True)
        for i, o in enumerate(vs):
            o.is_latest = i == 0
            o.num_versions = len(vs)
        yield from vs


def is_pooled(layer) -> bool:
    """Is ``layer`` a server-pools deployment (the pool routes, the
    per-pool usage)?"""
    return isinstance(layer, ErasureServerPools)


class ErasureServerPools:
    """cmd/erasure-server-pool.go erasureServerPools."""

    FREE_SPACE_TTL_S = 5.0

    def __init__(self, pools: list[ErasureSets],
                 specs: list[PoolSpec] | None = None, secret: str = ""):
        """``secret`` seals the manifest (the root secret, as the
        kvconfig and IAM are sealed)."""
        if not pools:
            raise ValueError("no pools")
        if specs is None:
            specs = [PoolSpec(pool_id=p.deployment_id or f"pool-{i}",
                              set_count=p.set_count,
                              set_drive_count=p.set_drive_count)
                     for i, p in enumerate(pools)]
        # (pools, specs), replaced whole: a reader takes one consistent
        # pair without a lock
        self._topo = (list(pools), list(specs))
        self._retired: list[ErasureSets] = []
        self._secret = secret
        self._lock = threading.RLock()
        self._manifest_version = 0
        self._free_cache: tuple[float, list[int]] | None = None
        self._names = NamespaceLock()

    @property
    def pools(self) -> list[ErasureSets]:
        return self._topo[0]

    @property
    def specs(self) -> list[PoolSpec]:
        return self._topo[1]

    def topology(self) -> tuple[list[ErasureSets], list[PoolSpec]]:
        """(pools, specs) of one moment, index for index."""
        return self._topo

    @property
    def meta_set(self):
        """Pool 0's metadata set: the system volume of the deployment
        (config, IAM, bucket metadata, the manifest, usage)."""
        return self.pools[0].meta_set

    @property
    def sets(self) -> list:
        """Every pool's erasure sets, pool by pool: what the topology
        walks (``metacache.leaf_layers_of``, ``health.disks_by_set``)
        visit."""
        return [s for p in self.pools for s in p.sets]

    @property
    def disks(self) -> list:
        return [d for p in self.pools for d in p.disks]

    @property
    def set_drive_count(self) -> int:
        """Every pool's sets are pool 0's size in what the reference
        builds; pool 0 answers."""
        return self.pools[0].set_drive_count

    def close(self) -> None:
        """Close every pool, the retired ones too."""
        for p in self.pools + self._retired:
            p.close()

    @contextlib.contextmanager
    def name_lock(self, bucket: str, object_name: str):
        """The pools' write lock on a name, above the sets' own.  A PUT,
        a delete and a completed upload hold it, and so does a move of
        a version from its checks to its source delete, so no write
        lands between a move's check and its commit."""
        lk = self._names.new_lock(bucket, object_name)
        lk.lock(write=True)
        try:
            yield
        finally:
            lk.unlock()

    def _sys_fanout(self, fn) -> tuple[list, list]:
        er = self.meta_set
        return er._fanout(fn, er.disks)

    def _set_kwargs(self, kwargs: dict) -> dict:
        """ErasureObjects arguments from a manifest row's: its layout,
        on pool 0's device."""
        out = {k: v for k, v in kwargs.items() if k in LAYOUT_KWARGS}
        out["device"] = self.pools[0].sets[0].device
        return out

    # -- the manifest ---------------------------------------------------------

    def save_manifest(self) -> None:
        """Write the manifest, sealed, on pool 0's metadata set (pool 0
        is never decommissioned, so it outlives every legal change)."""
        with self._lock:
            self._manifest_version += 1
            doc = {"version": self._manifest_version,
                   "pools": [sp.to_doc() for sp in self.specs]}
            blob = configcrypt.encrypt_data(self._secret,
                                            json.dumps(doc).encode())
            self._sys_fanout(
                lambda d: d.write_all(SYS_DIR, MANIFEST_PATH, blob))

    def load_manifest(self) -> bool:
        """Adopt the persisted topology: the highest version that opens
        wins; a pool recorded with dirs and not yet here is attached
        (``ErasureSets.from_dirs``), a pool absent from it is dropped,
        statuses are applied.  False when there is no manifest."""
        res, _ = self._sys_fanout(lambda d: d.read_all(SYS_DIR,
                                                       MANIFEST_PATH))
        olds = configcrypt.old_secrets_from_env()
        best: dict | None = None
        for blob in res:
            if blob is None:
                continue
            try:
                doc = json.loads(configcrypt.maybe_decrypt(
                    self._secret, blob, olds)[0])
            except Exception:  # noqa: BLE001 — a torn or foreign copy
                continue
            if best is None or doc.get("version", 0) > best.get("version",
                                                                0):
                best = doc
        if best is None:
            return False
        with self._lock:
            self._manifest_version = max(self._manifest_version,
                                         best.get("version", 0))
            pools, specs = list(self.pools), list(self.specs)
            by_id = {sp.pool_id: i for i, sp in enumerate(specs)}
            listed = set()
            for ent in best.get("pools", []):
                spec = PoolSpec.from_doc(ent)
                listed.add(spec.pool_id)
                if spec.pool_id in by_id:
                    i = by_id[spec.pool_id]
                    specs[i].status = spec.status
                    if spec.dirs:
                        specs[i].dirs = spec.dirs
                    continue
                if not spec.dirs:
                    continue        # another host's pool
                pools.append(ErasureSets.from_dirs(
                    spec.dirs, spec.set_count, spec.set_drive_count,
                    **self._set_kwargs(spec.kwargs)))
                specs.append(spec)
            # a pool the winning manifest does not list was retired
            # (pool 0 never is)
            for i in range(len(specs) - 1, 0, -1):
                if specs[i].pool_id not in listed:
                    self._retired.append(pools.pop(i))
                    specs.pop(i)
            self._topo = (pools, specs)
        self._free_cache = None
        return True

    # -- the pools' lifecycle -------------------------------------------------

    def attach_pool(self, dirs: list[str], set_count: int,
                    set_drive_count: int, **set_kwargs) -> int:
        """Attach a pool under traffic: every bucket is made on it before
        it joins the router, so a write placed there never finds its
        bucket missing.  ``set_kwargs`` (parity, block_size,
        enforce_min_part_size; others are recorded, not read) go into
        the manifest; the pool runs on pool 0's device.  Returns its
        index."""
        pool = ErasureSets.from_dirs(list(dirs), set_count, set_drive_count,
                                     **self._set_kwargs(set_kwargs))
        try:
            for b in self.pools[0].list_buckets():
                try:
                    pool.make_bucket(b.name)
                except Exception:  # noqa: BLE001 — heal converges it
                    pass
            with self._lock:
                if any(sp.pool_id == pool.deployment_id
                       for sp in self.specs):
                    raise ValueError(
                        f"pool {pool.deployment_id} already attached")
                spec = PoolSpec(pool.deployment_id, list(dirs), set_count,
                                set_drive_count, STATUS_ACTIVE,
                                {k: v for k, v in set_kwargs.items()
                                 if k not in ("device", "mesh")})
                self._topo = (self.pools + [pool], self.specs + [spec])
                self.save_manifest()
        except BaseException:
            if pool not in self.pools:
                pool.close()
            raise
        self._free_cache = None
        return len(self.pools) - 1

    def _resolve_pool(self, pool) -> int:
        """The index of a pool given by index or by id."""
        if isinstance(pool, int):
            if not 0 <= pool < len(self.pools):
                raise ValueError(f"no pool {pool}")
            return pool
        for i, sp in enumerate(self.specs):
            if sp.pool_id == pool:
                return i
        raise ValueError(f"no pool {pool!r}")

    def start_decommission(self, pool) -> int:
        """Mark a pool draining: no new name is placed there from now on;
        reads, deletes and its pinned uploads go on while the rebalancer
        empties it."""
        with self._lock:
            idx = self._resolve_pool(pool)
            if idx == 0:
                raise ValueError(
                    "pool 0 carries the system volume (config/IAM/"
                    "manifest) and cannot be decommissioned")
            if self.specs[idx].status == STATUS_DRAINING:
                return idx
            if not [i for i in self._active_idxs() if i != idx]:
                raise ValueError("cannot drain the last active pool")
            self.specs[idx].status = STATUS_DRAINING
            self.save_manifest()
        self._free_cache = None
        return idx

    def abort_decommission(self, pool) -> int:
        with self._lock:
            idx = self._resolve_pool(pool)
            if self.specs[idx].status != STATUS_DRAINING:
                raise ValueError(f"pool {idx} is not draining")
            self.specs[idx].status = STATUS_ACTIVE
            self.save_manifest()
        self._free_cache = None
        return idx

    def decommission_pending(self, pool) -> tuple[int, int]:
        """(versions, uploads) the pool still holds: what
        ``finish_decommission`` waits for."""
        from ..background.heal import iter_versions
        p = self.pools[self._resolve_pool(pool)]
        versions = uploads = 0
        for b in self.list_buckets():
            versions += sum(1 for _ in iter_versions(p, b.name))
            uploads += len(p.list_multipart_uploads(b.name))
        return versions, uploads

    def finish_decommission(self, pool) -> None:
        """Retire a drained pool from the manifest; refused while a
        version or an upload remains.  Until the manifest is written the
        pool is draining, so a restart resumes the drain."""
        with self._lock:
            idx = self._resolve_pool(pool)
            if self.specs[idx].status != STATUS_DRAINING:
                raise ValueError(f"pool {idx} is not draining")
            versions, uploads = self.decommission_pending(idx)
            if versions or uploads:
                raise ValueError(
                    f"pool {idx} not empty: {versions} versions, "
                    f"{uploads} uploads remain")
            pools, specs = list(self.pools), list(self.specs)
            self._retired.append(pools.pop(idx))
            specs.pop(idx)
            self._topo = (pools, specs)
            self.save_manifest()
        self._free_cache = None

    def pool_status(self) -> list[dict]:
        pools, specs = self._topo
        frees = self._free_spaces()
        return [{"index": i, "id": sp.pool_id, "status": sp.status,
                 "setCount": pools[i].set_count,
                 "setDriveCount": pools[i].set_drive_count,
                 "dirs": sp.dirs, "freeBytes": frees[i]}
                for i, sp in enumerate(specs)]

    # -- placement ------------------------------------------------------------

    def _active_idxs(self) -> list[int]:
        return [i for i, sp in enumerate(self.specs)
                if sp.status == STATUS_ACTIVE]

    @staticmethod
    def _free_space(pool: ErasureSets) -> int:
        total = 0
        for d in pool.disks:
            if d is not None:
                try:
                    total += d.disk_info().free
                except Exception:  # noqa: BLE001 — an offline drive
                    pass           # has no free space
        return total

    def _free_spaces(self) -> list[int]:
        """Free bytes per pool, cached for ``FREE_SPACE_TTL_S``: not a
        statvfs of every drive per PUT."""
        pools = self.pools
        now = time.monotonic()
        cache = self._free_cache
        if cache and now - cache[0] < self.FREE_SPACE_TTL_S and \
                len(cache[1]) == len(pools):
            return cache[1]
        frees = [self._free_space(p) for p in pools]
        self._free_cache = (now, frees)
        return frees

    def get_pool_idx(self, bucket: str, object_name: str) -> int:
        """The first active pool that holds the name; else an active pool
        drawn by the crc32 of ``bucket/name`` over the active pools' free
        bytes (the reference draws at random; a hash keeps a name's pool
        stable at the same spread).  A name held only by a draining pool
        goes to an active one: the draining pool takes no write.  A probe
        error other than not-found raises (placing elsewhere would hide
        the copy once its pool answers again)."""
        return self._place(bucket, object_name)[2]

    def _place(self, bucket: str, object_name: str
               ) -> tuple[list, list, int]:
        """(pools, specs, index): ``get_pool_idx`` on one topology."""
        pools, specs = self._topo
        if len(pools) == 1:
            return pools, specs, 0  # nothing to place: no probe
        active = [i for i, sp in enumerate(specs)
                  if sp.status == STATUS_ACTIVE]
        for i, p in enumerate(pools):
            try:
                p.get_object_info(bucket, object_name)
            except (ObjectNotFound, VersionNotFound):
                continue
            if i in active:
                return pools, specs, i
        frees = self._free_spaces()
        total = sum(frees[i] for i in active)
        if total <= 0:
            return pools, specs, active[0]
        choose = int(zlib.crc32(f"{bucket}/{object_name}".encode())
                     / 2**32 * total)
        for i in active:
            if choose < frees[i]:
                return pools, specs, i
            choose -= frees[i]
        return pools, specs, active[-1]

    def _find_pool(self, bucket: str, object_name: str,
                   opts=None) -> ErasureSets:
        """The pool to read from.  A version id names its version, which
        any pool holding it serves (a copy mid-move is the same version);
        else every pool is asked and the latest written copy wins, a
        delete marker too.  A pool below read quorum may hold the latest
        copy, so its ReadQuorumError is raised rather than another
        pool's copy served: a client can retry an error, not detect a
        stale body."""
        pools = self.pools
        if len(pools) == 1:
            return pools[0]         # the op itself says not-found
        by_id = opts is not None and bool(opts.version_id)
        missing: Exception = ObjectNotFound(f"{bucket}/{object_name}")
        unsure: ReadQuorumError | None = None
        best, best_t = None, 0
        for p in pools:
            try:
                oi = p.get_object_info(bucket, object_name, opts)
            except (ObjectNotFound, VersionNotFound) as e:
                missing = e
                continue
            except ReadQuorumError as e:
                unsure = e
                continue
            if by_id:
                return p
            if best is None or oi.mod_time > best_t:
                best, best_t = p, oi.mod_time
        if unsure is not None:
            raise unsure
        if best is None:
            raise missing
        return best

    def _find_pools(self, bucket: str, object_name: str) -> list[int]:
        """Every pool that holds the name: a delete reaches them all, or
        a copy mid-move would bring the name back.  A pool below read
        quorum raises, for the same reason."""
        out = []
        for i, p in enumerate(self.pools):
            try:
                p.get_object_info(bucket, object_name)
                out.append(i)
            except (ObjectNotFound, VersionNotFound):
                continue
        return out

    def _read(self, bucket: str, object_name: str, opts, call):
        """``call(pool)`` on the pool ``_find_pool`` picks; when the copy
        it found was moved away before the call, picked once more."""
        self.get_bucket_info(bucket)
        pool = self._find_pool(bucket, object_name, opts)
        try:
            return call(pool)
        except (ObjectNotFound, VersionNotFound):
            if len(self.pools) == 1:
                raise
        return call(self._find_pool(bucket, object_name, opts))

    # -- buckets --------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        pools = self.pools
        pools[0].make_bucket(bucket)
        for p in pools[1:]:
            try:
                p.make_bucket(bucket)
            except Exception:  # noqa: BLE001 — heal_bucket converges it
                pass

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.pools[0].get_bucket_info(bucket)

    _check_bucket = get_bucket_info

    def list_buckets(self) -> list[BucketInfo]:
        return self.pools[0].list_buckets()

    def health(self, maintenance: bool = False) -> dict:
        return aggregate_health(self.pools, maintenance)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        """Delete from every pool; when one refuses (not empty), the
        pools already deleted get the bucket back."""
        done = []
        for p in self.pools:
            try:
                p.delete_bucket(bucket, force)
            except Exception:
                for prev in done:
                    try:
                        prev.make_bucket(bucket)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                raise
            done.append(p)

    def heal_bucket(self, bucket: str) -> int:
        return sum(p.heal_bucket(bucket) for p in self.pools)

    # -- objects --------------------------------------------------------------

    def put_object(self, bucket, object_name, data, opts=None) -> ObjectInfo:
        with self.name_lock(bucket, object_name):
            pools, _, idx = self._place(bucket, object_name)
            return pools[idx].put_object(bucket, object_name, data, opts)

    def get_object(self, bucket, object_name, offset=0, length=-1,
                   opts=None):
        return self._read(bucket, object_name, opts, lambda p: p.get_object(
            bucket, object_name, offset, length, opts))

    def get_object_reader(self, bucket, object_name, offset=0, length=-1,
                          opts=None, **kw):
        return self._read(bucket, object_name, opts,
                          lambda p: p.get_object_reader(
                              bucket, object_name, offset, length, opts,
                              **kw))

    def get_object_info(self, bucket, object_name, opts=None) -> ObjectInfo:
        return self._read(bucket, object_name, opts,
                          lambda p: p.get_object_info(bucket, object_name,
                                                      opts))

    def delete_object(self, bucket, object_name, opts=None) -> ObjectInfo:
        """The delete goes to every pool that holds the name (the first's
        answer is returned); to pool 0 when none does."""
        self.get_bucket_info(bucket)
        with self.name_lock(bucket, object_name):
            pools = self.pools
            idxs = [] if len(pools) == 1 else self._find_pools(bucket,
                                                               object_name)
            if not idxs:
                return pools[0].delete_object(bucket, object_name, opts)
            result = pools[idxs[0]].delete_object(bucket, object_name, opts)
            for i in idxs[1:]:
                try:
                    pools[i].delete_object(bucket, object_name, opts)
                except (ObjectNotFound, VersionNotFound):
                    pass            # a version only some pools hold
            return result

    def put_object_metadata(self, bucket, object_name, version_id, updates,
                            removes=()) -> ObjectInfo:
        """A metadata update of the pool that holds the version (its
        latest copy without a version id), under the name lock, so a
        move cannot copy the version before the update and delete it
        after."""
        self.get_bucket_info(bucket)
        with self.name_lock(bucket, object_name):
            return self._find_pool(
                bucket, object_name, ObjectOptions(version_id=version_id)
            ).put_object_metadata(bucket, object_name, version_id, updates,
                                  removes)

    def heal_object(self, bucket, object_name, version_id=None, deep=False,
                    dry_run=False, remove_dangling=False):
        """The first pool that holds the object heals it."""
        last: Exception = ObjectNotFound(f"{bucket}/{object_name}")
        for p in self.pools:
            try:
                return p.heal_object(bucket, object_name, version_id, deep,
                                     dry_run, remove_dangling)
            except ObjectNotFound as e:
                last = e
        raise last

    # -- listings -------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> ListObjectsInfo:
        """One page of every pool's sets' snapshots merged (a name held
        by two pools once, the latest written)."""
        pools = self.pools
        if len(pools) == 1:
            return pools[0].list_objects(bucket, prefix, marker, delimiter,
                                         max_keys)
        self._check_bucket(bucket)
        return list_leaves([s for p in pools for s in p.sets], bucket,
                           prefix, marker, delimiter, max_keys)

    def list_object_versions(self, bucket: str, prefix: str = "",
                             key_marker: str = "",
                             version_id_marker: str = "",
                             max_keys: int = -1) -> ListObjectVersionsInfo:
        """Every pool's versions merged by key (a version two pools hold
        once, a key's versions newest first across pools), then paged."""
        pools = self.pools
        if len(pools) == 1:
            return pools[0].list_object_versions(
                bucket, prefix, key_marker, version_id_marker, max_keys)
        self._check_bucket(bucket)
        merged = heapq.merge(*(s._versions_iter(bucket, prefix, key_marker)
                               for p in pools for s in p.sets),
                             key=lambda o: o.name)
        return paginate_versions(merge_versions(merged), key_marker,
                                 version_id_marker, max_keys)

    # -- multipart: pinned to the pool that started the upload ---------------

    def new_multipart_upload(self, bucket, object_name, opts=None) -> str:
        pools, specs, idx = self._place(bucket, object_name)
        uid = pools[idx].new_multipart_upload(bucket, object_name, opts)
        if len(pools) > 1:
            rec = json.dumps({"pool": specs[idx].pool_id, "bucket": bucket,
                              "object": object_name}).encode()
            self._sys_fanout(lambda d: d.write_all(
                SYS_DIR, f"{UPLOADS_PREFIX}/{uid}.json", rec))
        return uid

    def _upload_pool(self, bucket, object_name, upload_id) -> ErasureSets:
        """The upload's pool from its record; without one (an upload of a
        one-pool deployment, or of a retired pool) the pool that knows
        the upload."""
        pools, specs = self._topo
        if len(pools) > 1:
            res, _ = self._sys_fanout(lambda d: d.read_all(
                SYS_DIR, f"{UPLOADS_PREFIX}/{upload_id}.json"))
            for blob in res:
                if blob is None:
                    continue
                try:
                    pid = json.loads(blob).get("pool", "")
                except ValueError:
                    continue
                for i, sp in enumerate(specs):
                    if sp.pool_id == pid:
                        return pools[i]
                break               # its pool was retired: ask them all
        for p in pools:
            try:
                p.list_object_parts(bucket, object_name, upload_id)
                return p
            except InvalidUploadID:
                continue
        raise InvalidUploadID(upload_id)

    def _drop_upload_record(self, upload_id) -> None:
        if len(self.pools) <= 1:
            return
        try:
            self._sys_fanout(lambda d: d.delete(
                SYS_DIR, f"{UPLOADS_PREFIX}/{upload_id}.json"))
        except Exception:  # noqa: BLE001 — a stale record is harmless
            pass

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        data, content_md5=None):
        return self._upload_pool(bucket, object_name, upload_id) \
            .put_object_part(bucket, object_name, upload_id, part_number,
                             data, content_md5)

    def get_multipart_info(self, bucket, object_name, upload_id
                           ) -> MultipartInfo:
        return self._upload_pool(bucket, object_name, upload_id) \
            .get_multipart_info(bucket, object_name, upload_id)

    def list_object_parts(self, bucket, object_name, upload_id):
        return self._upload_pool(bucket, object_name, upload_id) \
            .list_object_parts(bucket, object_name, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, opts=None) -> ObjectInfo:
        pool = self._upload_pool(bucket, object_name, upload_id)
        with self.name_lock(bucket, object_name):
            oi = pool.complete_multipart_upload(bucket, object_name,
                                                upload_id, parts, opts)
        self._drop_upload_record(upload_id)
        return oi

    def abort_multipart_upload(self, bucket, object_name, upload_id) -> None:
        self._upload_pool(bucket, object_name, upload_id) \
            .abort_multipart_upload(bucket, object_name, upload_id)
        self._drop_upload_record(upload_id)

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[MultipartInfo]:
        out = []
        for p in self.pools:
            out.extend(p.list_multipart_uploads(bucket, prefix))
        return sorted(out, key=lambda m: m.object_name)

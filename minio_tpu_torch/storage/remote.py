"""Drives on another node, over the internode RPC
(``minio_tpu/storage/remote.py``, cmd/storage-rest-{client,server}.go).

``register_storage_service`` exports a node's drives on its RPC server:
every ``StorageAPI`` call as ``storage.<method>`` with the drive's id,
and the bulk transfers as the raw ``storage-write`` and ``storage-read``
endpoints (framed when longer than ``rpc.stream_chunk_bytes``).
``RemoteStorage`` is the other end: a ``StorageAPI`` whose calls cross
the wire, with the typed storage errors raised again on this side, so
quorum reduction works across nodes unchanged.  Method names, arguments
and documents are the reference's: a port node serves a ``minio_tpu``
node's drive calls and the reverse.  Two additions of the port ride
along without disturbing that: ``read_version`` replies carry the
journal's version count under ``nv``, and ``storage.reopen`` (a port
server's; against a reference server it is a no-op) takes back a drive
that returned empty.
"""

from __future__ import annotations

from ..parallel.rpc import STREAM, RPCClient, RPCError, RPCServer, StreamBody
from . import errors as serrors
from . import msgpack_codec as msgpack
from .api import DiskInfo, StorageAPI, VolInfo
from .datatypes import FileInfo

_ERR_TYPES = {cls.__name__: cls for cls in [
    serrors.DiskNotFound, serrors.UnformattedDisk, serrors.CorruptedFormat,
    serrors.DiskFull, serrors.VolumeNotFound, serrors.VolumeExists,
    serrors.VolumeNotEmpty, serrors.FileNotFound,
    serrors.FileVersionNotFound, serrors.FileNameTooLong,
    serrors.FileAccessDenied, serrors.FileCorrupt, serrors.IsNotRegular,
    serrors.PathNotEmpty, serrors.DiskAccessDenied, serrors.FaultyDisk,
    serrors.MethodNotAllowed,
]}


def _fi_doc(fi: FileInfo) -> dict:
    d = fi.to_dict()
    d["nv"] = fi.num_versions
    return d


def _entries(d, volume, base_dir, recursive, versions) -> list[dict]:
    """``walk_entries`` as the reference's documents:
    ``{"name", "fis": [FileInfo dicts]}``."""
    return [{"name": name,
             "fis": [fi.to_dict() for fi in (e if versions else [e])]}
            for name, e in d.walk_entries(volume, base_dir, versions,
                                          recursive=recursive)]


def register_storage_service(rpc: RPCServer, drives: dict) -> None:
    """Export local drives, keyed by drive id, on a node's RPC server
    (the storage-rest-server.go handler table)."""

    def drive(drive_id: str):
        d = drives.get(drive_id)
        if d is None:
            raise serrors.DiskNotFound(drive_id)
        return d

    def vol(v) -> dict:
        return {"name": v.name, "created": v.created}

    fi_of = FileInfo.from_dict
    methods = {
        "disk_info": lambda drive_id: vars(drive(drive_id).disk_info()),
        "make_vol": lambda drive_id, volume:
            drive(drive_id).make_vol(volume),
        "list_vols": lambda drive_id: [
            vol(v) for v in drive(drive_id).list_vols()],
        "stat_vol": lambda drive_id, volume:
            vol(drive(drive_id).stat_vol(volume)),
        "delete_vol": lambda drive_id, volume, force:
            drive(drive_id).delete_vol(volume, force),
        "list_dir": lambda drive_id, volume, dir_path, count:
            drive(drive_id).list_dir(volume, dir_path, count),
        "read_all": lambda drive_id, volume, path:
            drive(drive_id).read_all(volume, path),
        "write_all": lambda drive_id, volume, path, data:
            drive(drive_id).write_all(volume, path, data),
        "create_file": lambda drive_id, volume, path, data, file_size:
            drive(drive_id).create_file(volume, path, data, file_size),
        "append_file": lambda drive_id, volume, path, data:
            drive(drive_id).append_file(volume, path, data),
        "read_file_stream": lambda drive_id, volume, path, offset, length:
            drive(drive_id).read_file_stream(volume, path, offset, length),
        "read_segment": lambda drive_id, sid, off, length:
            drive(drive_id).read_segment(sid, off, length),
        "rename_file": lambda drive_id, src_volume, src_path, dst_volume,
            dst_path: drive(drive_id).rename_file(
                src_volume, src_path, dst_volume, dst_path),
        "delete": lambda drive_id, volume, path, recursive:
            drive(drive_id).delete(volume, path, recursive),
        "stat_info_file": lambda drive_id, volume, path:
            drive(drive_id).stat_info_file(volume, path),
        "rename_data": lambda drive_id, src_volume, src_path, fi,
            dst_volume, dst_path: drive(drive_id).rename_data(
                src_volume, src_path, fi_of(fi), dst_volume, dst_path),
        "write_metadata": lambda drive_id, volume, path, fi:
            drive(drive_id).write_metadata(volume, path, fi_of(fi)),
        "update_metadata": lambda drive_id, volume, path, fi:
            drive(drive_id).update_metadata(volume, path, fi_of(fi)),
        "read_version": lambda drive_id, volume, path, version_id,
            read_data: _fi_doc(drive(drive_id).read_version(
                volume, path, version_id, read_data)),
        "list_versions": lambda drive_id, volume, path: [
            fi.to_dict()
            for fi in drive(drive_id).list_versions(volume, path)],
        "delete_version": lambda drive_id, volume, path, fi,
            force_del_marker: drive(drive_id).delete_version(
                volume, path, fi_of(fi), force_del_marker),
        "verify_file": lambda drive_id, volume, path, fi:
            drive(drive_id).verify_file(volume, path, fi_of(fi)),
        "check_parts": lambda drive_id, volume, path, fi:
            drive(drive_id).check_parts(volume, path, fi_of(fi)),
        "walk_dir": lambda drive_id, volume, base_dir, recursive:
            list(drive(drive_id).walk_dir(volume, base_dir,
                                          recursive=recursive)),
        "walk_entries": lambda drive_id, volume, base_dir, recursive,
            versions: _entries(drive(drive_id), volume, base_dir,
                               recursive, versions),
        "tmp_dir": lambda drive_id: drive(drive_id).tmp_dir(),
        "clean_tmp": lambda drive_id, rel_dir:
            drive(drive_id).clean_tmp(rel_dir),
        "get_disk_id": lambda drive_id: drive(drive_id).get_disk_id(),
        "set_disk_id": lambda drive_id, disk_id:
            drive(drive_id).set_disk_id(disk_id),
        "reopen": lambda drive_id: drive(drive_id).reopen(),
    }
    rpc.register("storage", methods)

    def raw_write(params, data):
        d = drive(params["drive_id"])
        op = params.get("op")
        if op == "append":
            d.append_file(params["volume"], params["path"], data)
        elif op == "commit":
            # a single-part commit in one round trip: the part, then the
            # version
            d.write_data_commit(params["volume"], params["path"],
                                fi_of(params["fi"]), data)
        elif op == "packed":
            # the shard joins the owning node's segment file, in that
            # node's group commits
            d.write_packed(params["volume"], params["path"],
                           fi_of(params["fi"]), data)
        else:
            d.create_file(params["volume"], params["path"], data,
                          params.get("file_size", -1))
        return b""

    def raw_read(params, data):
        d = drive(params["drive_id"])
        volume, path = params["volume"], params["path"]
        offset, length = params["offset"], params["length"]
        chunk = int(params.get("resp_stream") or 0)
        if not chunk or length <= chunk:
            return d.read_file_stream(volume, path, offset, length)
        # a streamed reply from one open; the first chunk is read now, so
        # a missing or short file is still a typed error
        it = d.read_stream(volume, path, offset, length, chunk)
        first = next(it)

        def rest():
            yield first
            yield from it

        return (length, rest())

    def stream_write(params, frames):
        """The framed twin of raw_write: each frame lands as it arrives.
        A gated commit reads its version from the trailer, which the
        sender resolves only after the part's frames went out."""
        d = drive(params["drive_id"])
        volume, path = params["volume"], params["path"]
        op = params.get("op")
        if op == "append":
            d.write_stream(volume, path, frames, op="append")
        elif op == "packed":
            # a packed shard is small: it lands whole (the reference
            # writes a streamed one as a plain file at the object's path)
            d.write_packed(volume, path, fi_of(params["fi"]),
                           b"".join(frames))
        elif op == "commit":
            gate = None
            if params.get("trailer"):
                def gate():
                    return msgpack.unpackb(frames.read_trailer())
            d.write_data_commit(volume, path, fi_of(params["fi"]), frames,
                                meta_gate=gate)
        else:
            d.write_stream(volume, path, frames, op="create",
                           file_size=params.get("file_size", -1))
        return b""

    rpc.register_raw("storage-write", raw_write)
    rpc.register_raw("storage-read", raw_read)
    rpc.register_raw_stream("storage-write", stream_write)


class RemoteStorage(StorageAPI):
    """A ``StorageAPI`` over RPC to a peer's drive
    (cmd/storage-rest-client.go)."""

    def __init__(self, client: RPCClient, drive_id: str):
        self._c = client
        self.drive_id = drive_id

    # reads may be replayed on a stale pooled connection; a mutation
    # must never run twice
    _IDEMPOTENT = {
        "disk_info", "list_vols", "stat_vol", "list_dir", "read_all",
        "read_file_stream", "read_segment", "stat_info_file",
        "read_version", "list_versions", "verify_file", "check_parts",
        "walk_dir", "walk_entries", "get_disk_id",
    }

    def _call(self, method: str, **kwargs):
        try:
            return self._c.call("storage", method, drive_id=self.drive_id,
                                _idempotent=method in self._IDEMPOTENT,
                                **kwargs)
        except RPCError as e:
            raise self._map_err(e) from e

    def _raw(self, name: str, params: dict, body=b"") -> bytes:
        try:
            return self._c.raw_call(
                name, {"drive_id": self.drive_id, **params}, body,
                idempotent=(name == "storage-read"))
        except RPCError as e:
            raise self._map_err(e) from e

    @staticmethod
    def _stream_body(data, chunk: int,
                     trailer_fn=None) -> StreamBody | None:
        """A framed body over ``chunk``-sized views of ``data``
        (re-iterable, for replays); None when ``data`` fits in one chunk
        (and has no trailer) or is not a flat buffer."""
        if not chunk:
            return None
        try:
            mv = memoryview(data).cast("B")
        except (TypeError, ValueError):
            return None
        if len(mv) <= chunk and trailer_fn is None:
            return None

        def chunks():
            for off in range(0, len(mv), chunk):
                yield mv[off:off + chunk]

        return StreamBody(chunks, trailer_fn)

    def _map_err(self, e: RPCError) -> Exception:
        cls = _ERR_TYPES.get(e.error_type)
        if cls is not None:
            return cls(e.message)
        return serrors.DiskNotFound(
            f"{self._c.endpoint}/{self.drive_id}: {e}")

    # -- identity / health -------------------------------------------------

    def is_online(self) -> bool:
        return self._c.is_online()

    def endpoint(self) -> str:
        return f"{self._c.endpoint}/{self.drive_id}"

    def is_local(self) -> bool:
        return False

    def get_disk_id(self) -> str:
        return self._call("get_disk_id")

    def set_disk_id(self, disk_id: str) -> None:
        self._call("set_disk_id", disk_id=disk_id)

    def disk_info(self) -> DiskInfo:
        return DiskInfo(**self._call("disk_info"))

    def close(self) -> None:
        pass

    def reopen(self) -> None:
        try:
            self._call("reopen")
        except serrors.DiskNotFound as e:
            if not isinstance(e.__cause__, RPCError) or \
                    e.__cause__.error_type != "NoSuchMethod":
                raise

    # -- volumes -----------------------------------------------------------

    def make_vol(self, volume):
        self._call("make_vol", volume=volume)

    def list_vols(self):
        return [VolInfo(v["name"], v["created"])
                for v in self._call("list_vols")]

    def stat_vol(self, volume):
        v = self._call("stat_vol", volume=volume)
        return VolInfo(v["name"], v["created"])

    def delete_vol(self, volume, force=False):
        self._call("delete_vol", volume=volume, force=force)

    # -- files -------------------------------------------------------------

    def list_dir(self, volume, dir_path, count=-1):
        return self._call("list_dir", volume=volume, dir_path=dir_path,
                          count=count)

    def read_all(self, volume, path):
        return self._call("read_all", volume=volume, path=path)

    def write_all(self, volume, path, data):
        self._call("write_all", volume=volume, path=path, data=bytes(data))

    def create_file(self, volume, path, data, file_size=-1):
        body = self._stream_body(data, STREAM.chunk())
        self._raw("storage-write",
                  {"volume": volume, "path": path, "op": "create",
                   "file_size": file_size},
                  bytes(data) if body is None else body)

    def append_file(self, volume, path, data):
        body = self._stream_body(data, STREAM.chunk())
        self._raw("storage-write",
                  {"volume": volume, "path": path, "op": "append"},
                  bytes(data) if body is None else body)

    def read_file_stream(self, volume, path, offset, length):
        params = {"volume": volume, "path": path,
                  "offset": offset, "length": length}
        chunk = STREAM.chunk()
        if chunk and length > chunk:
            # the peer reads the shard off its drive chunk by chunk
            params["resp_stream"] = chunk
        return self._raw("storage-read", params)

    def rename_file(self, src_volume, src_path, dst_volume, dst_path):
        self._call("rename_file", src_volume=src_volume, src_path=src_path,
                   dst_volume=dst_volume, dst_path=dst_path)

    def delete(self, volume, path, recursive=False):
        self._call("delete", volume=volume, path=path, recursive=recursive)

    def stat_info_file(self, volume, path):
        return self._call("stat_info_file", volume=volume, path=path)

    # -- commits -----------------------------------------------------------

    def write_data_commit(self, volume, path, fi, data, shard_index=None,
                          version_dict=None, meta_gate=None):
        def patched(base: dict) -> dict:
            d = dict(base)
            if shard_index is not None:
                d["ec"] = dict(d["ec"], index=shard_index)
            return d

        chunk = STREAM.chunk()
        if meta_gate is not None and chunk:
            # the part's frames cross first and the gate resolves into the
            # trailer, so the MD5 overlaps the remote write as it does a
            # local one; a gate that raises aborts the stream and the
            # peer drops the part
            body = self._stream_body(
                data, chunk, trailer_fn=lambda: msgpack.packb(
                    patched(meta_gate())))
            if body is not None:
                self._raw("storage-write",
                          {"volume": volume, "path": path, "op": "commit",
                           "fi": patched(fi.to_dict()), "trailer": True},
                          body)
                return
        if meta_gate is not None:
            version_dict = meta_gate()
        d = patched(version_dict if version_dict is not None
                    else fi.to_dict())
        body = self._stream_body(data, chunk)
        self._raw("storage-write",
                  {"volume": volume, "path": path, "op": "commit", "fi": d},
                  bytes(data) if body is None else body)

    def write_packed(self, volume, path, fi, data, shard_index=None,
                     version_dict=None):
        d = dict(version_dict) if version_dict is not None \
            else fi.to_dict()
        if shard_index is not None:
            d["ec"] = dict(d["ec"], index=shard_index)
        # never framed: a reference server does not take a framed packed
        # shard (ROADMAP Queue 3 record 61)
        self._raw("storage-write",
                  {"volume": volume, "path": path, "op": "packed", "fi": d},
                  bytes(data))

    def read_segment(self, sid, off, length):
        return self._call("read_segment", sid=sid, off=off, length=length)

    # -- metadata ----------------------------------------------------------

    def rename_data(self, src_volume, src_path, fi, dst_volume, dst_path):
        self._call("rename_data", src_volume=src_volume, src_path=src_path,
                   fi=fi.to_dict(), dst_volume=dst_volume,
                   dst_path=dst_path)

    def write_metadata(self, volume, path, fi):
        self._call("write_metadata", volume=volume, path=path,
                   fi=fi.to_dict())

    def update_metadata(self, volume, path, fi):
        self._call("update_metadata", volume=volume, path=path,
                   fi=fi.to_dict())

    def read_version(self, volume, path, version_id=None, read_data=False):
        d = self._call("read_version", volume=volume, path=path,
                       version_id=version_id, read_data=read_data)
        fi = FileInfo.from_dict(d)
        fi.num_versions = d.get("nv", 0)
        return fi

    def list_versions(self, volume, path):
        return [FileInfo.from_dict(d)
                for d in self._call("list_versions", volume=volume,
                                    path=path)]

    def delete_version(self, volume, path, fi, force_del_marker=False):
        self._call("delete_version", volume=volume, path=path,
                   fi=fi.to_dict(), force_del_marker=force_del_marker)

    # -- integrity ---------------------------------------------------------

    def verify_file(self, volume, path, fi):
        self._call("verify_file", volume=volume, path=path, fi=fi.to_dict())

    def check_parts(self, volume, path, fi):
        self._call("check_parts", volume=volume, path=path,
                   fi=fi.to_dict())

    # -- walking -----------------------------------------------------------

    def walk_dir(self, volume, base_dir="", after="", recursive=True):
        return iter([n for n in self._call(
            "walk_dir", volume=volume, base_dir=base_dir,
            recursive=recursive) if n >= after])

    def walk_entries(self, volume, base_dir="", versions=False, after="",
                     recursive=True):
        for doc in self._call("walk_entries", volume=volume,
                              base_dir=base_dir, recursive=recursive,
                              versions=versions):
            if doc["name"] < after:
                continue
            fis = [FileInfo.from_dict(d) for d in doc["fis"]]
            yield doc["name"], (fis if versions else fis[0])

    # -- staging -----------------------------------------------------------

    def tmp_dir(self) -> str:
        return self._call("tmp_dir")

    def clean_tmp(self, rel_dir: str) -> None:
        self._call("clean_tmp", rel_dir=rel_dir)

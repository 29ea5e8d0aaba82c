"""Bucket DNS federation (``minio_tpu/utils/fed_dns.py``; cmd/etcd.go,
pkg/dns/etcd_dns.go).

Several servers share one bucket namespace: each records the buckets it
makes in a shared store and removes them when it deletes them, and a
request for a bucket homed on another server is redirected there.  The
store is either

  * ``FileDNSStore``: a JSON file under an ``fcntl`` lock, the stand-in
    for etcd that servers on one host or one NFS mount share, or
  * ``EtcdDNSStore``: etcd (``utils/etcd.py``) under the CoreDNS/skydns
    keys, a create guarded by a transaction so two servers racing for one
    name see one winner.

Both lay records out as the reference does, so a port server and a
``minio_tpu`` server federate on one store.  ``FederationSys`` ties a
store to a server (``S3Server.federation``), built once from the
``federation`` subsystem.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from dataclasses import dataclass

from .etcd import EtcdClient


class DNSError(Exception):
    pass


class BucketTaken(DNSError):
    """The bucket is registered by another server of the federation."""


@dataclass
class DNSRecord:
    bucket: str
    host: str
    port: int
    created_ns: int = 0

    def to_dict(self) -> dict:
        return {"bucket": self.bucket, "host": self.host,
                "port": self.port, "created_ns": self.created_ns}

    @classmethod
    def from_dict(cls, d: dict) -> "DNSRecord":
        return cls(d["bucket"], d["host"], int(d["port"]),
                   int(d.get("created_ns", 0)))


class FileDNSStore:
    """Records in one JSON file, ``{bucket: record}``, read and rewritten
    under an exclusive lock on ``<path>.lock``."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)

    def _with_lock(self, fn):
        """``fn(table) -> (answer, new table or None)`` under the lock; a
        new table replaces the file atomically."""
        with open(self.path + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                try:
                    with open(self.path) as f:
                        table = json.load(f)
                except (OSError, json.JSONDecodeError):
                    table = {}
                out, table2 = fn(table)
                if table2 is not None:
                    tmp = self.path + f".tmp{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(table2, f)
                    os.replace(tmp, self.path)
                return out
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def put(self, rec: DNSRecord, replace: bool = False) -> None:
        def fn(table):
            cur = table.get(rec.bucket)
            if cur and not replace and \
                    (cur["host"], cur["port"]) != (rec.host, rec.port):
                raise BucketTaken(f"bucket {rec.bucket!r} is owned by "
                                  f"{cur['host']}:{cur['port']}")
            table[rec.bucket] = rec.to_dict()
            return None, table
        self._with_lock(fn)

    def get(self, bucket: str) -> DNSRecord | None:
        def fn(table):
            d = table.get(bucket)
            return (DNSRecord.from_dict(d) if d else None), None
        return self._with_lock(fn)

    def delete(self, bucket: str) -> None:
        def fn(table):
            table.pop(bucket, None)
            return None, table
        self._with_lock(fn)

    def list(self) -> list[DNSRecord]:
        return self._with_lock(
            lambda table: ([DNSRecord.from_dict(d) for d in table.values()],
                           None))


class EtcdDNSStore:
    """Records in etcd under the skydns keys: bucket ``b`` of domain
    ``example.com`` at ``/skydns/com/example/b``, which CoreDNS's etcd
    plugin answers from."""

    def __init__(self, endpoints, domain: str):
        self._c = EtcdClient(endpoints)
        parts = [p for p in domain.strip(".").split(".") if p]
        self._base = "/skydns/" + "/".join(reversed(parts))

    def _key(self, bucket: str) -> str:
        return f"{self._base}/{bucket}"

    @staticmethod
    def _record(bucket: str, blob: bytes) -> DNSRecord:
        d = json.loads(blob)
        return DNSRecord(bucket, d["host"], int(d["port"]),
                         int(d.get("creationDate", 0)))

    def put(self, rec: DNSRecord, replace: bool = False) -> None:
        # the skydns record (pkg/dns/etcd_dns.go SrvRecord)
        blob = json.dumps({"host": rec.host, "port": rec.port, "ttl": 30,
                           "creationDate": rec.created_ns}).encode()
        if replace:
            self._c.put(self._key(rec.bucket), blob)
            return
        if self._c.put_if_absent(self._key(rec.bucket), blob):
            return
        existing = self.get(rec.bucket)
        if existing is not None and \
                (existing.host, existing.port) == (rec.host, rec.port):
            return                      # ours already
        raise BucketTaken(rec.bucket)

    def get(self, bucket: str) -> DNSRecord | None:
        blob = self._c.get(self._key(bucket))
        return None if blob is None else self._record(bucket, blob)

    def delete(self, bucket: str) -> None:
        self._c.delete(self._key(bucket))

    def list(self) -> list[DNSRecord]:
        return [self._record(k.decode().rsplit("/", 1)[-1], v)
                for k, v in self._c.get_prefix(self._base + "/")]


class FederationSys:
    """One server's side of the federation: it owns the records that
    name its own host and port."""

    def __init__(self, store, domain: str, self_host: str, self_port: int):
        self.store = store
        self.domain = domain
        self.self_host = self_host
        self.self_port = self_port

    @classmethod
    def from_config(cls, cfg, host: str,
                    port: int) -> "FederationSys | None":
        """From the ``federation`` subsystem (None when off): records name
        ``advertise`` or the bound ``host:port``; the store is etcd when
        the ``etcd`` subsystem names endpoints, else ``dns_file``."""
        if cfg.get("federation", "enable") != "on":
            return None
        # a record must name a routable owner: a wildcard bind would make
        # every server look like the owner of every bucket
        adv = cfg.get("federation", "advertise")
        if adv:
            ahost, _, aport = adv.rpartition(":")
            host, port = ahost or adv, int(aport) if aport else port
        elif host in ("0.0.0.0", "::", ""):
            raise DNSError("federation with a wildcard bind requires "
                           "federation.advertise=<host:port>")
        domain = cfg.get("federation", "domain")
        etcd_eps = cfg.get("etcd", "endpoints")
        if etcd_eps:
            return cls(EtcdDNSStore(etcd_eps, domain), domain, host, port)
        path = cfg.get("federation", "dns_file")
        if not path:
            raise DNSError("federation requires etcd.endpoints or "
                           "federation.dns_file")
        return cls(FileDNSStore(path), domain, host, port)

    def _is_self(self, rec: DNSRecord) -> bool:
        return (rec.host, rec.port) == (self.self_host, self.self_port)

    def register(self, bucket: str) -> bool:
        """MakeBucket's record; BucketTaken when another server holds the
        name.  True when this call made the record (a failed local make
        removes only such a record)."""
        existing = self.store.get(bucket)
        if existing is not None and self._is_self(existing):
            return False
        self.store.put(DNSRecord(bucket, self.self_host, self.self_port,
                                 time.time_ns()))
        return True

    def unregister(self, bucket: str) -> None:
        rec = self.store.get(bucket)
        if rec is not None and self._is_self(rec):
            self.store.delete(bucket)

    def lookup_other(self, bucket: str) -> DNSRecord | None:
        """The record of a bucket homed on another server, else None."""
        rec = self.store.get(bucket)
        return None if rec is None or self._is_self(rec) else rec

    def federated_buckets(self) -> list[DNSRecord]:
        return self.store.list()

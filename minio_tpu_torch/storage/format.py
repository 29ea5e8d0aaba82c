"""Drive format and identity: format.json (``minio_tpu/storage/
format.py``, cmd/format-erasure.go:109-122).

Each drive holds ``.mt.sys/format.json`` naming the deployment, its
sets x drives grid of drive uuids and the drive's own uuid.  At startup
the set layer loads it from every drive, or formats a fresh deployment
(waitForFormatErasure, cmd/prepare-storage.go:348).  The JSON bytes and
the order of the ``uuid4`` draws (the deployment id, then the grid row by
row) are the reference's, so either package serves a deployment the
other formatted.
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field

from . import errors
from .xl_storage import SYS_DIR

FORMAT_FILE = "format.json"
FORMAT_BACKEND = "erasure-tpu"
FORMAT_VERSION = "1"
DISTRIBUTION_ALGO_V3 = "SIPMOD+PARITY"  # sipHashMod (cmd/erasure-sets.go:629)


@dataclass
class FormatErasure:
    """formatErasureV3."""
    version: str = FORMAT_VERSION
    backend: str = FORMAT_BACKEND
    id: str = ""                    # deployment id
    this: str = ""                  # this drive's uuid
    sets: list[list[str]] = field(default_factory=list)
    distribution_algo: str = DISTRIBUTION_ALGO_V3

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version, "format": self.backend, "id": self.id,
            "erasure": {"this": self.this, "sets": self.sets,
                        "distributionAlgo": self.distribution_algo}},
            indent=1)

    @classmethod
    def from_json(cls, s: str | bytes) -> "FormatErasure":
        try:
            d = json.loads(s)
            ec = d["erasure"]
            return cls(version=d["version"], backend=d["format"],
                       id=d.get("id", ""), this=ec["this"],
                       sets=ec["sets"],
                       distribution_algo=ec.get("distributionAlgo",
                                                DISTRIBUTION_ALGO_V3))
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            raise errors.CorruptedFormat(str(e)) from e

    def for_drive(self, i: int, set_drive_count: int) -> "FormatErasure":
        """The format drive ``i`` of the flat drive list holds (flat
        order is grid order)."""
        return FormatErasure(
            id=self.id, sets=self.sets,
            this=self.sets[i // set_drive_count][i % set_drive_count],
            distribution_algo=self.distribution_algo)


def read_format(disk) -> FormatErasure:
    try:
        buf = disk.read_all(SYS_DIR, FORMAT_FILE)
    except errors.FileNotFound:
        raise errors.UnformattedDisk(disk.endpoint()) from None
    return FormatErasure.from_json(buf)


def save_format(disk, fmt: FormatErasure) -> None:
    disk.write_all(SYS_DIR, FORMAT_FILE, fmt.to_json().encode())


def init_format_erasure(disks: list, set_count: int, set_drive_count: int,
                        deployment_id: str | None = None) -> FormatErasure:
    """Format a fresh deployment: mint the drive uuids and write each
    drive's format.json (initFormatErasure, cmd/format-erasure.go:770)."""
    if len(disks) != set_count * set_drive_count:
        raise ValueError(f"{len(disks)} drives are not {set_count} sets of "
                         f"{set_drive_count}")
    deployment_id = deployment_id or str(uuid.uuid4())
    sets = [[str(uuid.uuid4()) for _ in range(set_drive_count)]
            for _ in range(set_count)]
    ref = FormatErasure(id=deployment_id, sets=sets)
    for i, disk in enumerate(disks):
        fmt = ref.for_drive(i, set_drive_count)
        save_format(disk, fmt)
        disk.set_disk_id(fmt.this)
    return ref


def load_or_init_format(disks: list, set_count: int,
                        set_drive_count: int) -> FormatErasure:
    """Load the deployment's format when any drive holds one, format a
    fresh deployment when none does; CorruptedFormat when two drives name
    different deployments.  A drive without format.json (a fresh
    replacement) is admitted and healed later."""
    fmts: list[FormatErasure | None] = []
    for d in disks:
        try:
            fmts.append(read_format(d))
        except errors.UnformattedDisk:
            fmts.append(None)
    if all(f is None for f in fmts):
        return init_format_erasure(disks, set_count, set_drive_count)
    ref = next(f for f in fmts if f is not None)
    for d, f in zip(disks, fmts):
        if f is None:
            continue
        if f.id != ref.id:
            raise errors.CorruptedFormat(
                f"deployment id mismatch on {d.endpoint()}")
        d.set_disk_id(f.this)
    return ref

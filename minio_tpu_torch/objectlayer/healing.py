"""Object healing (cmd/erasure-healing.go:233 healObject), single-part
objects: inline, in part files, or packed into segment files.

Each drive is classified for the quorum version as ok / offline / missing
/ outdated / corrupt.  The missing, outdated and corrupt shards are
rebuilt from k verified healthy ones through the set's codec (its device
or mesh): one Kernel A launch for all full stripes (and one for the short
last stripe), framed on the device with Kernel B, and written to each
stale drive through the set's writer plane in the layout of the healthy
drives: into xl.meta for an inline object, packed into the target
drive's own segment file for a packed one (``XLStorage.write_packed``;
an extent belongs to one drive, so it is never copied), else tmp +
``rename_data``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..hashing import bitrot
from ..ops import gf8, rs_kernels
from ..storage import errors as serrors
from ..storage.writers import held_release
from ..storage.xl_storage import SYS_DIR
from . import metadata as meta
from .erasure_object import ErasureObjects, _disk_fileinfo, rebuild
from .interface import ObjectNotFound


@dataclass
class HealResult:
    bucket: str
    object_name: str
    version_id: str = ""
    before_ok: int = 0
    after_ok: int = 0
    healed_disks: list[str] = field(default_factory=list)


OK, OFFLINE, MISSING, OUTDATED, CORRUPT = (
    "ok", "offline", "missing", "outdated", "corrupt")


def classify_disks(er: ErasureObjects, fi, fis: list, errs: list
                   ) -> list[str]:
    """Per-shard state of every drive for the quorum version ``fi``
    (listOnlineDisks / disksWithAllParts)."""
    dist = fi.erasure.distribution
    states = []
    for disk, dfi, derr in zip(meta.shuffle_disks(er.disks, dist),
                               meta.shuffle_parts_metadata(fis, dist),
                               meta.shuffle_parts_metadata(errs, dist)):
        if disk is None or isinstance(derr, serrors.DiskNotFound):
            states.append(OFFLINE)
        elif isinstance(derr, (serrors.FileNotFound,
                               serrors.FileVersionNotFound,
                               serrors.VolumeNotFound)):
            states.append(MISSING)
        elif derr is not None:
            states.append(CORRUPT)
        elif not meta.same_version(dfi, fi):
            states.append(OUTDATED)
        elif dfi.inline_data is not None:
            states.append(OK)
        else:
            try:
                disk.check_parts(fi.volume, fi.name, dfi)
                states.append(OK)
            except serrors.StorageError:
                states.append(CORRUPT)
    return states


def heal_object(er: ErasureObjects, bucket: str,
                object_name: str) -> HealResult:
    """HealObject for the latest version (cmd/erasure-healing.go:233)."""
    fis, errs = er._fanout(lambda d: d.read_version(bucket, object_name),
                           er.disks)
    if all(f is None for f in fis):
        raise ObjectNotFound(f"{bucket}/{object_name}")
    fi = meta.find_file_info_in_quorum(fis, max(1, len(er.disks) // 2))
    ec = fi.erasure
    k, m = ec.data_blocks, ec.parity_blocks
    res = HealResult(bucket, object_name, fi.version_id)
    states = classify_disks(er, fi, fis, errs)
    res.before_ok = res.after_ok = states.count(OK)
    healable = [i for i, s in enumerate(states)
                if s in (MISSING, OUTDATED, CORRUPT)]
    if res.before_ok < k or not healable:
        return res
    if len(fi.parts) > 1:
        raise ValueError("multipart objects are not healed by this slice")
    shuffled = meta.shuffle_disks(er.disks, ec.distribution)
    s_fis = meta.shuffle_parts_metadata(fis, ec.distribution)
    ok_idx = [i for i, s in enumerate(states) if s == OK]
    # the layout comes from the quorum version's healthy drives, never
    # from the stale targets
    inline = any(s_fis[i].inline_data is not None for i in ok_idx)
    packed = any(s_fis[i].seg is not None for i in ok_idx)

    if fi.size == 0 or not fi.parts:
        # nothing to rebuild: copy a healthy drive's version
        src = s_fis[ok_idx[0]]
        framed = release = None
    else:
        part = fi.parts[0]
        sfsize = ec.shard_file_size(part.size)
        got = _read_sources(er, fi, shuffled, s_fis, ok_idx, part.number,
                            sfsize)
        if got is None:
            return res
        present = sorted(got)[:k]
        rows = rs_kernels.decode_rows(gf8.rs_matrix(k, k + m), k, present,
                                      healable)
        surv = torch.stack([got[i] for i in present])
        rebuilt = surv.new_empty((len(healable), sfsize))
        rebuild(er.codec, rows, surv, part.size // ec.block_size,
                ec.shard_size(), rebuilt)
        framed, release = er._to_host(
            bitrot.frame_batch(rebuilt, ec.shard_size()))
        src = fi
    for i in healable:                      # healBucket first
        try:
            shuffled[i].stat_vol(bucket)
        except serrors.VolumeNotFound:
            shuffled[i].make_vol(bucket)

    def heal_one(pos, disk):
        dfi = _disk_fileinfo(src, healable[pos])
        if framed is None:                  # zero-size: metadata only
            dfi.inline_data = src.inline_data
            disk.write_metadata(bucket, object_name, dfi)
            return
        if inline:
            dfi.inline_data = framed[pos].tobytes()
            dfi.data_dir = ""
            disk.write_metadata(bucket, object_name, dfi)
            return
        if packed:
            dfi.data_dir = ""
            disk.write_packed(bucket, object_name, dfi, framed[pos].tobytes())
            return
        tmp = disk.tmp_dir()
        try:
            disk.create_file(SYS_DIR, f"{tmp}/part.1", framed[pos])
            disk.rename_data(SYS_DIR, tmp, dfi, bucket, object_name)
        finally:
            disk.clean_tmp(tmp)

    buf = held_release(release)
    try:
        herrs = er._commit_fanout(heal_one, [shuffled[i] for i in healable],
                                  buf)
    finally:
        buf.done_one()
    for pos, e in enumerate(herrs):
        if e is None:
            res.healed_disks.append(shuffled[healable[pos]].endpoint())
    res.after_ok = res.before_ok + len(res.healed_disks)
    first = next((e for e in herrs if e is not None), None)
    if first is not None:
        raise first
    return res


def _read_sources(er: ErasureObjects, fi, shuffled: list, s_fis: list,
                  ok_idx: list[int], part_number: int, sfsize: int):
    """k verified shard payloads {index: (sfsize,) tensor} from the healthy
    drives, or None when fewer than k verify."""
    k = fi.erasure.data_blocks
    ss = fi.erasure.shard_size()
    path = f"{fi.name}/{fi.data_dir}/part.{part_number}"

    def read_one(i):
        dfi = s_fis[i]
        if dfi.inline_data is not None:
            return dfi.inline_data
        if dfi.seg is not None:                 # a packed extent
            return shuffled[i].read_segment(dfi.seg["sid"], dfi.seg["off"],
                                            dfi.seg["len"])
        return shuffled[i].read_all(fi.volume, path)

    got: dict[int, torch.Tensor] = {}
    want = bitrot.bitrot_shard_file_size(sfsize, ss)
    candidates = list(ok_idx)
    while len(got) < k and candidates:
        batch = candidates[:k - len(got)]
        candidates = candidates[len(batch):]
        res, errs = er._fanout(read_one, batch)
        read = [(i, r) for i, r, e in zip(batch, res, errs)
                if e is None and len(r) == want]
        if not read:
            continue
        framed = np.stack([np.frombuffer(r, dtype=np.uint8) for _, r in read])
        payload, ok = bitrot.verify_frames(
            torch.from_numpy(framed).to(er.device), ss, sfsize)
        for (i, _), good, row in zip(read, ok.tolist(), payload):
            if good:
                got[i] = row
    return got if len(got) >= k else None

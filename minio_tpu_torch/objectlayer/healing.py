"""Object healing (cmd/erasure-healing.go:233 healObject), one version at
a time: inline objects, packed ones, part files of one part or many, and
delete markers.

Each drive is classified for the quorum version as ok / offline / missing
/ outdated / corrupt; ``deep`` also bitrot-verifies every shard of the
drives found ok, on the device (Kernel B).  The missing, outdated and
corrupt shards are rebuilt part by part from k verified healthy ones
through the set's codec (its device or mesh): one Kernel A launch for a
part's full stripes and one for its short last stripe, framed on the
device with Kernel B, and written to each stale drive through the set's
writer plane in the layout of the healthy drives: into xl.meta for an
inline object, packed into the target drive's own segment file for a
packed one (``XLStorage.write_packed``; an extent belongs to one drive,
so it is never copied), else every part into one staging dir per drive
as it is rebuilt and one ``rename_data`` per drive at the end.  A delete
marker or an empty object heals its metadata alone.

A version fewer than k drives hold whole is dangling: with
``remove_dangling`` it is deleted from every drive (purgeObjectDangling,
cmd/erasure-healing.go:692).  ``dry_run`` classifies and changes
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..hashing import bitrot
from ..ops import gf8, rs_kernels
from ..storage import errors as serrors
from ..storage.writers import held_release
from ..storage.xl_storage import SYS_DIR
from . import erasure_object as _eo
from . import metadata as meta
from .erasure_object import ErasureObjects, _disk_fileinfo, rebuild
from .interface import ObjectNotFound, ReadQuorumError


@dataclass
class HealResult:
    bucket: str
    object_name: str
    version_id: str = ""
    before_ok: int = 0
    after_ok: int = 0
    healed_disks: list[str] = field(default_factory=list)
    dangling_purged: bool = False


OK, OFFLINE, MISSING, OUTDATED, CORRUPT = (
    "ok", "offline", "missing", "outdated", "corrupt")


def classify_disks(er: ErasureObjects, fi, fis: list, errs: list,
                   deep: bool = False) -> list[str]:
    """Per-shard state of every drive for the quorum version ``fi``
    (listOnlineDisks / disksWithAllParts); ``deep`` verifies the frames
    of every part file and packed extent found whole."""
    dist = fi.erasure.distribution
    shuffled = meta.shuffle_disks(er.disks, dist)
    s_fis = meta.shuffle_parts_metadata(fis, dist)
    states = []
    for disk, dfi, derr in zip(shuffled, s_fis,
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
    if deep and not fi.deleted:
        _deep_verify(er, fi, shuffled, s_fis, states)
    return states


def _shard_file(disk, fi, dfi, part_number: int) -> bytes:
    """A drive's framed shard file of one part: its inline data, its
    packed extent or its part file."""
    if dfi.inline_data is not None:
        return dfi.inline_data
    if dfi.seg is not None:
        return disk.read_segment(dfi.seg["sid"], dfi.seg["off"],
                                 dfi.seg["len"])
    return disk.read_all(fi.volume,
                         f"{fi.name}/{fi.data_dir}/part.{part_number}")


def _deep_verify(er: ErasureObjects, fi, shuffled: list, s_fis: list,
                 states: list[str]) -> None:
    """Read every part of every drive still ok (inline data aside, as
    the reference does) and verify its frames, one ``verify_frames``
    over all those drives per part; a drive that fails turns corrupt."""
    ec = fi.erasure
    ss = ec.shard_size()
    cand = [i for i, s in enumerate(states)
            if s == OK and s_fis[i].inline_data is None]
    for part in fi.parts:
        if not cand:
            return
        sfsize = ec.shard_file_size(part.size)
        want = bitrot.bitrot_shard_file_size(sfsize, ss)
        res, errs = er._fanout(
            lambda i: _shard_file(shuffled[i], fi, s_fis[i], part.number),
            cand)
        read = []
        for i, r, e in zip(cand, res, errs):
            if e is None and len(r) == want:
                read.append((i, r))
            else:
                states[i] = CORRUPT
        if read:
            framed = np.stack([np.frombuffer(r, dtype=np.uint8)
                               for _, r in read])
            _, ok = bitrot.verify_frames(
                torch.from_numpy(framed).to(er.device), ss, sfsize)
            for (i, _), good in zip(read, ok.tolist()):
                if not good:
                    states[i] = CORRUPT
        cand = [i for i in cand if states[i] == OK]


def heal_object(er: ErasureObjects, bucket: str, object_name: str,
                version_id: Optional[str] = None, deep: bool = False,
                dry_run: bool = False, remove_dangling: bool = False
                ) -> HealResult:
    """HealObject of the latest version or of ``version_id``
    (cmd/erasure-healing.go:803, :233)."""
    fis, errs = er._fanout(
        lambda d: d.read_version(bucket, object_name, version_id), er.disks)
    ok_reads = [f for f in fis if f is not None]
    if not ok_reads:
        raise ObjectNotFound(f"{bucket}/{object_name}")
    try:
        fi = meta.find_file_info_in_quorum(fis, max(1, len(er.disks) // 2))
    except ReadQuorumError:
        # below metadata quorum: never served again
        fi = ok_reads[0]
        res = HealResult(bucket, object_name, fi.version_id,
                         before_ok=len(ok_reads), after_ok=len(ok_reads))
        if remove_dangling and not dry_run:
            _purge(er, bucket, object_name, fi, res)
        return res
    k = fi.erasure.data_blocks
    res = HealResult(bucket, object_name, fi.version_id)
    states = classify_disks(er, fi, fis, errs, deep)
    res.before_ok = res.after_ok = states.count(OK)
    healable = [i for i, s in enumerate(states)
                if s in (MISSING, OUTDATED, CORRUPT)]
    if res.before_ok < k:
        if remove_dangling and not dry_run:
            _purge(er, bucket, object_name, fi, res)
        return res
    shuffled = meta.shuffle_disks(er.disks, fi.erasure.distribution)
    s_fis = meta.shuffle_parts_metadata(fis, fi.erasure.distribution)
    if not dry_run:
        _heal_stale_metadata(er, fi, shuffled, s_fis, states, res)
    if not healable or dry_run:
        return res
    ok_idx = [i for i, s in enumerate(states) if s == OK]
    targets = [shuffled[i] for i in healable]
    for disk in targets:                    # healBucket first
        try:
            disk.stat_vol(bucket)
        except serrors.VolumeNotFound:
            disk.make_vol(bucket)
    # the layout comes from the quorum version's healthy drives, never
    # from the stale targets
    inline = any(s_fis[i].inline_data is not None for i in ok_idx)
    packed = any(s_fis[i].seg is not None for i in ok_idx)
    if fi.deleted or fi.size == 0 or not fi.parts:
        herrs = _heal_metadata(er, fi, s_fis[ok_idx[0]], healable, targets)
    elif inline or packed:
        got = _rebuild_part(er, fi, shuffled, s_fis, ok_idx, healable,
                            fi.parts[0])
        if got is None:
            return res
        herrs = _heal_small(er, fi, got, inline, healable, targets)
    else:
        herrs = _heal_part_files(er, fi, shuffled, s_fis, ok_idx,
                                 healable, targets)
        if herrs is None:
            return res
    for pos, e in enumerate(herrs):
        if e is None:
            res.healed_disks.append(targets[pos].endpoint())
            res.after_ok += 1
    first = next((e for e in herrs if e is not None), None)
    if first is not None:
        raise first
    return res


def _heal_stale_metadata(er: ErasureObjects, fi, shuffled: list,
                         s_fis: list, states: list[str],
                         res: HealResult) -> None:
    """A drive that holds the version whole but missed a metadata update
    in place (``put_object_metadata``: tags, retention, legal hold) gets
    the quorum's metadata merged into its own entry, which keeps its
    shard index, inline data, packed extent and data dir.  The
    reference never heals such a drive (ROADMAP Queue 3)."""
    stale = [i for i, s in enumerate(states)
             if s == OK and s_fis[i].metadata != fi.metadata]

    def write_one(i):
        dfi = s_fis[i]
        dfi.metadata = dict(fi.metadata)
        shuffled[i].write_metadata(fi.volume, fi.name, dfi)

    _, errs = er._fanout(write_one, stale)
    res.healed_disks += [shuffled[i].endpoint()
                         for i, e in zip(stale, errs) if e is None]


def _purge(er: ErasureObjects, bucket: str, object_name: str, fi,
           res: HealResult) -> None:
    er._fanout(lambda d: d.delete_version(bucket, object_name, fi),
               er.disks)
    res.dangling_purged = True


def _heal_metadata(er: ErasureObjects, fi, src, healable: list[int],
                   targets: list) -> list:
    """A delete marker's or an empty object's heal: a healthy drive's
    version (with its inline data, if any) merged into each target's
    xl.meta."""
    def write_one(pos, disk):
        dfi = _disk_fileinfo(fi, healable[pos])
        dfi.inline_data = src.inline_data
        disk.write_metadata(fi.volume, fi.name, dfi)

    buf = held_release(None)
    try:
        return er._commit_fanout(write_one, targets, buf)
    finally:
        buf.done_one()


def _heal_small(er: ErasureObjects, fi, got, inline: bool,
                healable: list[int], targets: list) -> list:
    """An inline or packed object's heal: one storage call per target
    drive, into its xl.meta or its own segment."""
    framed, release = got

    def write_one(pos, disk):
        dfi = _disk_fileinfo(fi, healable[pos])
        dfi.data_dir = ""
        if inline:
            dfi.inline_data = framed[pos].tobytes()
            disk.write_metadata(fi.volume, fi.name, dfi)
        else:
            disk.write_packed(fi.volume, fi.name, dfi, framed[pos].tobytes())

    buf = held_release(release)
    try:
        return er._commit_fanout(write_one, targets, buf)
    finally:
        buf.done_one()


def _heal_part_files(er: ErasureObjects, fi, shuffled: list, s_fis: list,
                     ok_idx: list[int], healable: list[int],
                     targets: list) -> Optional[list]:
    """Part files: each part rebuilt in turn and staged into one tmp dir
    per target as it comes (at most the writer queue's depth of parts in
    flight), then one ``rename_data`` per target commits them all (a
    commit per part would replace the data dir each time).  Returns the
    per-target errors, or None when a part has fewer than k verified
    sources (nothing committed)."""
    tmps: list[Optional[str]] = [None] * len(targets)

    def stage_for(framed, number: int):
        def stage(pos, disk):
            if tmps[pos] is None:
                tmps[pos] = disk.tmp_dir()
            disk.create_file(SYS_DIR, f"{tmps[pos]}/part.{number}",
                             framed[pos])
        return stage

    def commit(pos, disk):
        disk.rename_data(SYS_DIR, tmps[pos],
                         _disk_fileinfo(fi, healable[pos]),
                         fi.volume, fi.name)

    if not er._pipeline_on():
        errs: list = [None] * len(targets)
        try:
            for part in fi.parts:
                got = _rebuild_part(er, fi, shuffled, s_fis, ok_idx,
                                    healable, part)
                if got is None:
                    return None
                framed, release = got
                try:
                    _serial_round(er, stage_for(framed, part.number),
                                  targets, errs)
                finally:
                    release()
            _serial_round(er, commit, targets, errs)
            return errs
        finally:
            for disk, tmp in zip(targets, tmps):
                if tmp is not None:
                    disk.clean_tmp(tmp)
    sw = er._write_plane.stream(targets)
    try:
        for part in fi.parts:
            got = _rebuild_part(er, fi, shuffled, s_fis, ok_idx, healable,
                                part)
            if got is None:
                return None
            framed, release = got
            sw.submit_batch(stage_for(framed, part.number), release=release)
        sw.submit_batch(commit)
        sw.drain()
        return list(sw.errs)
    finally:
        sw.abort()
        sw.drain(_eo.ABORT_DRAIN_S)
        # staging dirs go once their drive settled: an op still running
        # past the wait cleans up after itself
        for pos, disk in enumerate(targets):
            sw.when_drive_idle(
                pos, lambda p=pos, d=disk:
                tmps[p] is not None and d.clean_tmp(tmps[p]))


def _serial_round(er: ErasureObjects, fn, targets: list, errs: list) -> None:
    """fn(pos, disk) on every target that has not failed yet, in line."""
    live = [None if errs[p] is not None else (p, d)
            for p, d in enumerate(targets)]
    _, rerrs = er._fanout(lambda item: fn(*item), live)
    for p, e in enumerate(rerrs):
        if live[p] is not None and e is not None:
            errs[p] = e


def _rebuild_part(er: ErasureObjects, fi, shuffled: list, s_fis: list,
                  ok_idx: list[int], healable: list[int], part):
    """The healable shards of one part, rebuilt and framed on the device
    and copied into a pooled host buffer: (rows, release), or None when
    fewer than k sources verify."""
    ec = fi.erasure
    k, m = ec.data_blocks, ec.parity_blocks
    sfsize = ec.shard_file_size(part.size)
    got = _read_sources(er, fi, shuffled, s_fis, ok_idx, part.number,
                        sfsize)
    if got is None:
        return None
    present = sorted(got)[:k]
    rows = rs_kernels.decode_rows(gf8.rs_matrix(k, k + m), k, present,
                                  healable)
    surv = torch.stack([got[i] for i in present])
    rebuilt = surv.new_empty((len(healable), sfsize))
    rebuild(er.codec, rows, surv, part.size // ec.block_size,
            ec.shard_size(), rebuilt)
    return er._to_host(bitrot.frame_batch(rebuilt, ec.shard_size()))


def _read_sources(er: ErasureObjects, fi, shuffled: list, s_fis: list,
                  ok_idx: list[int], part_number: int, sfsize: int):
    """k verified shard payloads {index: (sfsize,) tensor} of one part
    from the healthy drives, or None when fewer than k verify."""
    k = fi.erasure.data_blocks
    ss = fi.erasure.shard_size()
    got: dict[int, torch.Tensor] = {}
    want = bitrot.bitrot_shard_file_size(sfsize, ss)
    candidates = list(ok_idx)
    while len(got) < k and candidates:
        batch = candidates[:k - len(got)]
        candidates = candidates[len(batch):]
        res, errs = er._fanout(
            lambda i: _shard_file(shuffled[i], fi, s_fis[i], part_number),
            batch)
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

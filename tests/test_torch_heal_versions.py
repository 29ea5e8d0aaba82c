"""The heal sweep restores every version (ROADMAP Queue 3 item 16).

A versioned key is written twice (or written once and then deleted, so
its latest version is a delete marker), one drive of its set comes back
empty, the drive monitor admits it and the sweep runs; then two other
drives of the set go away.  With parity 2 of 4 the key must still read
back whole: every version's body, and the marker as the latest version.
``minio_tpu``'s sweep heals only each key's latest version, so the
oracle is each version's body, not the reference layer."""

import os
import shutil
import threading

import pytest

from minio_tpu_torch.background.heal import BackgroundHealer
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.objectlayer.interface import (MethodNotAllowed,
                                                   ObjectOptions,
                                                   PutObjectOptions)
from minio_tpu_torch.objectlayer.sets import ErasureSets
from minio_tpu_torch.storage.format import init_format_erasure
from minio_tpu_torch.storage.health import DriveMonitor, wrap_disks
from minio_tpu_torch.storage.xl_storage import XLStorage

from ._torch_versions import body

PER, PARITY, BS = 4, 2, 4096
BUCKET, KEY = "ver", "k"
SIZES = (5_000, 3_000)


def _one_set(root):
    dirs = [f"{root}/d{i}" for i in range(PER)]
    for d in dirs:
        os.makedirs(d)
    disks = [XLStorage(d) for d in dirs]
    fmt = init_format_erasure(disks, 1, PER)
    lay = ErasureObjects(wrap_disks(disks, fmt, PER), parity=PARITY,
                         block_size=BS, device="cpu")
    return lay, dirs, lay


def _two_sets(root):
    dirs = [f"{root}/d{i}" for i in range(2 * PER)]
    for d in dirs:
        os.makedirs(d)
    lay = ErasureSets.from_dirs(dirs, 2, PER, parity=PARITY, block_size=BS,
                                device="cpu")
    s = lay.get_hashed_set_index(KEY)
    return lay, dirs[s * PER:(s + 1) * PER], lay.sets[s]


def _write(lay, marker: bool) -> list[str]:
    """The key's versions, oldest first; with ``marker`` the second is a
    delete marker."""
    lay.make_bucket(BUCKET)
    vids = [lay.put_object(BUCKET, KEY, body(SIZES[0], 0),
                           PutObjectOptions(versioned=True)).version_id]
    if marker:
        vids.append(lay.delete_object(
            BUCKET, KEY, ObjectOptions(versioned=True)).version_id)
    else:
        vids.append(lay.put_object(BUCKET, KEY, body(SIZES[1], 1),
                                   PutObjectOptions(versioned=True))
                    .version_id)
    return vids


def _lose(dirs, the_set, i: int) -> None:
    """Drive i goes away and one guarded call notices."""
    shutil.rmtree(dirs[i])
    with pytest.raises(OSError):
        the_set.disks[i].stat_vol(BUCKET)
    assert the_set.disks[i].offline


def _wait_heals() -> None:
    for t in threading.enumerate():
        if t.name == "mt-drive-heal-kick":
            t.join(120)


@pytest.mark.parametrize("marker", [False, True],
                         ids=["two-puts", "delete-marker-latest"])
@pytest.mark.parametrize("build", [_one_set, _two_sets],
                         ids=["one-set", "two-sets"])
def test_sweep_restores_every_version_to_a_returned_drive(tmp_path, build,
                                                          marker):
    lay, dirs, the_set = build(tmp_path)
    try:
        vids = _write(lay, marker)
        # drive 0 comes back empty; the monitor formats and admits it
        _lose(dirs, the_set, 0)
        os.makedirs(dirs[0])
        DriveMonitor(the_set.disks).poll_once()
        _wait_heals()
        assert not the_set.disks[0].offline
        stats = BackgroundHealer(lay).sweep()
        assert stats.objects_failed == 0
        assert stats.objects_scanned == 2           # versions, not keys
        # drive 0 lists both versions, as a drive that never left does
        on_0 = [fi.version_id for fi in
                the_set.disks[0].list_versions(BUCKET, KEY)]
        on_3 = [fi.version_id for fi in
                the_set.disks[3].list_versions(BUCKET, KEY)]
        assert on_0 == on_3 == vids[::-1]
        # two more drives go: drives 0 and 3 must carry both versions
        for i in (1, 2):
            _lose(dirs, the_set, i)
        info, got = lay.get_object(BUCKET, KEY,
                                   opts=ObjectOptions(version_id=vids[0]))
        assert got == body(SIZES[0], 0)
        if marker:
            with pytest.raises(MethodNotAllowed):
                lay.get_object(BUCKET, KEY)
            latest = lay.list_object_versions(BUCKET).objects[0]
            assert latest.delete_marker and latest.version_id == vids[1]
        else:
            info, got = lay.get_object(BUCKET, KEY)
            assert info.version_id == vids[1]
            assert got == body(SIZES[1], 1)
    finally:
        lay.close()

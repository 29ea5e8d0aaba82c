"""format.json in the port (``minio_tpu_torch/storage/format.py``)
against ``minio_tpu``'s: the same bytes after formatting a fresh
deployment with both packages' uuid draws pinned, each package loads the
other's format, two deployment ids on one set of drives are refused, and
a fresh replacement drive is admitted unformatted."""

import json
import os

import pytest

from minio_tpu.storage import format as ref_fmt
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.storage import errors as serrors
from minio_tpu_torch.storage import format as port_fmt
from minio_tpu_torch.storage.xl_storage import SYS_DIR, XLStorage

from ._torch_versions import drives, pin


@pytest.mark.parametrize("sets,per", [(1, 4), (2, 3), (3, 4)])
def test_format_bytes_match_reference(tmp_path, monkeypatch, sets, per):
    pin(monkeypatch)
    n = sets * per
    got = port_fmt.init_format_erasure(drives(tmp_path / "port", XLStorage,
                                              n), sets, per)
    want = ref_fmt.init_format_erasure(drives(tmp_path / "ref", RefStorage,
                                              n), sets, per)
    assert (got.id, got.sets) == (want.id, want.sets)
    for i in range(n):
        path = f"{SYS_DIR}/{port_fmt.FORMAT_FILE}"
        port_bytes = (tmp_path / "port" / f"d{i}" / path).read_bytes()
        assert port_bytes == (tmp_path / "ref" / f"d{i}" / path).read_bytes()
        doc = json.loads(port_bytes)
        assert doc["erasure"]["this"] == want.sets[i // per][i % per]


def test_each_package_loads_the_others_format(tmp_path):
    ref_disks = drives(tmp_path / "a", RefStorage, 6)
    want = ref_fmt.init_format_erasure(ref_disks, 2, 3)
    port_disks = drives(tmp_path / "a", XLStorage, 6)
    got = port_fmt.load_or_init_format(port_disks, 2, 3)
    assert (got.id, got.sets, got.distribution_algo) == \
        (want.id, want.sets, want.distribution_algo)
    assert [d.get_disk_id() for d in port_disks] == \
        [u for row in want.sets for u in row]

    port_disks = drives(tmp_path / "b", XLStorage, 6)
    want = port_fmt.init_format_erasure(port_disks, 3, 2)
    ref_disks = drives(tmp_path / "b", RefStorage, 6)
    got = ref_fmt.load_or_init_format(ref_disks, 3, 2)
    assert (got.id, got.sets) == (want.id, want.sets)
    assert [d.get_disk_id() for d in ref_disks] == \
        [u for row in want.sets for u in row]


def test_mixed_deployment_ids_are_refused(tmp_path):
    a = drives(tmp_path / "a", XLStorage, 4)
    b = drives(tmp_path / "b", XLStorage, 4)
    port_fmt.init_format_erasure(a, 1, 4)
    port_fmt.init_format_erasure(b, 1, 4)
    with pytest.raises(serrors.CorruptedFormat, match="deployment id"):
        port_fmt.load_or_init_format(a[:2] + b[2:], 1, 4)


def test_fresh_replacement_drive_is_admitted_unformatted(tmp_path):
    disks = drives(tmp_path, XLStorage, 4)
    fmt = port_fmt.init_format_erasure(disks, 1, 4)
    os.remove(tmp_path / "d2" / SYS_DIR / port_fmt.FORMAT_FILE)
    fresh = drives(tmp_path, XLStorage, 4)
    got = port_fmt.load_or_init_format(fresh, 1, 4)
    assert got.id == fmt.id
    assert [d.get_disk_id() for d in fresh] == \
        [fmt.sets[0][0], fmt.sets[0][1], "", fmt.sets[0][3]]
    assert not (tmp_path / "d2" / SYS_DIR / port_fmt.FORMAT_FILE).exists()
    with pytest.raises(serrors.UnformattedDisk):
        port_fmt.read_format(fresh[2])


def test_corrupt_format_is_refused(tmp_path):
    disk, = drives(tmp_path, XLStorage, 1)
    disk.write_all(SYS_DIR, port_fmt.FORMAT_FILE, b"{not json")
    with pytest.raises(serrors.CorruptedFormat):
        port_fmt.read_format(disk)
    disk.write_all(SYS_DIR, port_fmt.FORMAT_FILE, b'{"version": "1"}')
    with pytest.raises(serrors.CorruptedFormat):
        port_fmt.read_format(disk)
    with pytest.raises(ValueError):
        port_fmt.init_format_erasure([disk], 2, 2)

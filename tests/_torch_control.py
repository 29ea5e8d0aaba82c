"""Shared set-up of the control-plane tests (``test_torch_metrics.py``,
``test_torch_admin.py``): ``minio_tpu``'s server and the port's, each
built by its own package's ``build_server`` over two sets of four drives
(4 KiB blocks, parity 2), with both packages' clocks, uuid draws and
formats pinned (``_torch_versions.pin``), so placement, version ids and
drive ids agree.  The reference's hot-read cache is off (the port has
none) and its crawler never runs in a test's time."""

import contextlib
import os

import pytest

import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu import server_main as ref_main
from minio_tpu.objectlayer import hotread as ref_hotread
from minio_tpu.storage import commit as ref_commit
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.storage import commit as port_commit

from ._torch_versions import pin

SETS, PER, BS = 2, 4, 4096
BATCH = 260 * BS                    # a 1.1 MB body streams in two batches
THRESHOLD = 1_500_000               # larger HTTP bodies take the stream route
AK, SK = "ctl-key", "ctl-secret"


@contextlib.contextmanager
def servers(root, mp: pytest.MonkeyPatch):
    """(reference server, port server), started; both stopped and the
    process-wide knobs they touched restored on exit."""
    saved = (dict(ref_hotread.CONFIG.__dict__),
             dict(ref_commit.CONFIG.__dict__),
             dict(port_commit.CONFIG.__dict__))
    mp.setenv("MT_CACHE_ENABLE", "off")
    mp.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    pin(mp, batch=BATCH)
    for mod in (ref_ho, port_ho):
        mp.setattr(mod, "STREAM_PUT_THRESHOLD", THRESHOLD)
    dirs = {tag: [str(root / tag / f"d{i}") for i in range(SETS * PER)]
            for tag in ("ref", "port")}
    ref = ref_main.build_server(dirs["ref"], "127.0.0.1:0", AK, SK,
                                set_drive_count=PER, backend="numpy",
                                block_size=BS)
    try:
        port = port_main.build_server(dirs["port"], "127.0.0.1:0", AK, SK,
                                      block_size=BS, device="cpu",
                                      set_drive_count=PER)
    except BaseException:
        ref.stop()
        raise
    for srv in (ref, port):
        for s in srv.layer.sets:
            s.enforce_min_part_size = False
    ref.start()
    port.start()
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()
        ref_hotread.CONFIG.__dict__.update(saved[0])
        ref_commit.CONFIG.__dict__.update(saved[1])
        port_commit.CONFIG.__dict__.update(saved[2])


def client(srv, key: str = AK, secret: str = SK) -> S3Client:
    return S3Client(f"http://127.0.0.1:{srv.port}", key, secret)


def both(ref, port, method: str, path: str, query: str = "",
         body: bytes = b"", sign: bool = True) -> tuple:
    """The same request to each server; (reference answer, port
    answer), any status."""
    return tuple(client(s).request(method, path, query, body, sign=sign,
                                   expect=())
                 for s in (ref, port))


def drive_no(endpoint: str) -> int:
    """A drive's number from its endpoint (the two roots differ)."""
    return int(os.path.basename(endpoint.rstrip("/"))[1:])

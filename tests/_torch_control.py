"""Shared set-up of the control-plane tests (``test_torch_metrics.py``,
``test_torch_admin.py``): ``minio_tpu``'s server and the port's, each
built by its own package's ``build_server`` over two sets of four drives
(4 KiB blocks, parity 2), with both packages' clocks, uuid draws and
formats pinned (``_torch_versions.pin``), so placement, version ids and
drive ids agree.  The reference's hot-read cache is off (the port has
none) and its crawler never runs in a test's time.  On exit the
reference's drive monitor and fan-out pools are stopped too, which its
``stop()`` leaves running.  ``replication_pairs`` builds a source and a
destination pair for the replication tests and stops every replication
plane on exit; ``start_replication`` gives a server of either package a
plane of a chosen worker count."""

import contextlib
import os
import ssl

import pytest

import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu import server_main as ref_main
from minio_tpu.background import replication as ref_repl
from minio_tpu.objectlayer import hotread as ref_hotread
from minio_tpu.storage import commit as ref_commit
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.background import replication as port_repl
from minio_tpu_torch.s3 import server as port_server
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.storage import commit as port_commit

from ._torch_versions import pin

SETS, PER, BS = 2, 4, 4096
BATCH = 260 * BS                    # a 1.1 MB body streams in two batches
THRESHOLD = 1_500_000               # larger HTTP bodies take the stream route
AK, SK = "ctl-key", "ctl-secret"


@contextlib.contextmanager
def servers(root, mp: pytest.MonkeyPatch, sets: int = SETS, per: int = PER):
    """(reference server, port server) over ``sets`` sets of ``per``
    drives, started; both stopped and the process-wide knobs they
    touched restored on exit."""
    saved = (dict(ref_hotread.CONFIG.__dict__),
             dict(ref_commit.CONFIG.__dict__),
             dict(port_commit.CONFIG.__dict__))
    mp.setenv("MT_CACHE_ENABLE", "off")
    mp.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    pin(mp, batch=BATCH)
    for mod in (ref_ho, port_ho):
        mp.setattr(mod, "STREAM_PUT_THRESHOLD", THRESHOLD)
    dirs = {tag: [str(root / tag / f"d{i}") for i in range(sets * per)]
            for tag in ("ref", "port")}
    ref = ref_main.build_server(dirs["ref"], "127.0.0.1:0", AK, SK,
                                set_drive_count=per, backend="numpy",
                                block_size=BS)
    try:
        port = port_main.build_server(dirs["port"], "127.0.0.1:0", AK, SK,
                                      block_size=BS, device="cpu",
                                      set_drive_count=per)
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
        # the reference's stop leaves its drive monitor polling and its
        # sets' fan-out pools alive; later tests count threads
        ref.layer.monitor.stop()
        for s in ref.layer.sets:
            s._pool.shutdown(wait=True)
        ref_hotread.CONFIG.__dict__.update(saved[0])
        ref_commit.CONFIG.__dict__.update(saved[1])
        port_commit.CONFIG.__dict__.update(saved[2])


@contextlib.contextmanager
def replication_pairs(root, mp: pytest.MonkeyPatch):
    """(reference source, port source, reference destination, port
    destination): two ``servers`` pairs, started.  On exit every
    server's replication plane is stopped (the reference's ``stop()``
    leaves its workers running), then the servers."""
    with servers(root / "src", mp) as (rsrc, psrc), \
            servers(root / "dst", mp) as (rdst, pdst):
        try:
            yield rsrc, psrc, rdst, pdst
        finally:
            for srv in (rsrc, psrc, rdst, pdst):
                if srv.replication is not None:
                    srv.replication.stop()


def start_replication(srv, workers: int = 1, start: bool = True):
    """A replication plane of ``workers`` for ``srv`` (either package),
    attached as ``srv.replication`` and, with ``start``, started; the
    targets on its drives are loaded."""
    if isinstance(srv, port_server.S3Server):
        repl = port_repl.ReplicationSys(
            srv.layer, srv.bucket_meta,
            lambda b, k, v: port_ho.read_version(srv, b, k, v),
            workers=workers)
    else:
        repl = ref_repl.ReplicationSys(srv.layer, srv.bucket_meta,
                                       workers=workers)
    if start:
        repl.start()
    srv.replication = repl
    return repl


def client(srv, key: str = AK, secret: str = SK) -> S3Client:
    """A client of ``srv``; over TLS, trusting the CA its test gave it
    (``srv.test_ca``)."""
    ca = getattr(srv, "test_ca", None)
    if ca is None:
        return S3Client(f"http://127.0.0.1:{srv.port}", key, secret)
    return S3Client(f"https://127.0.0.1:{srv.port}", key, secret,
                    ssl_context=ssl.create_default_context(cafile=ca))


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

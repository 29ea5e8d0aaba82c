"""``python -m minio_tpu_torch server`` on the CPU: it serves S3 over one
erasure set when asked for the CPU, refuses to start without a card when
it is not (no fallback), and sizes sets as ``minio_tpu`` does, serving
only a drive count that makes one set."""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from minio_tpu import server_main as ref_main
from minio_tpu_torch import server_main
from minio_tpu_torch.s3.client import S3Client

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", **extra)
    return env


def test_server_entry_point_on_the_cpu(tmp_path):
    port = _free_port()
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", "--device",
         "cpu", "--address", f"127.0.0.1:{port}", "--block-size", "4096",
         *dirs],
        cwd=ROOT, env=_env(MT_ROOT_USER="entry-key",
                           MT_ROOT_PASSWORD="entry-secret"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = S3Client(f"http://127.0.0.1:{port}", "entry-key",
                          "entry-secret", timeout=60)
        deadline = time.monotonic() + 60
        while True:
            try:
                r = client.request("GET", "/minio/health/live", sign=False)
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "server never answered"
                time.sleep(0.2)
        assert r.status == 200
        client.make_bucket("entry")
        body = os.urandom(300_000)
        client.put_object("entry", "obj", body)
        client.put_object_chunked("entry", "chunked", body[:100_000])
        assert client.get_object("entry", "obj").body == body
        assert client.get_object("entry", "chunked").body == body[:100_000]
        assert client.list_buckets() == ["entry"]
        assert [o["key"] for o in client.list_objects("entry")["objects"]] \
            == ["chunked", "obj"]
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "2 data + 2 parity" in out and "device cpu" in out


def test_server_entry_point_without_a_card_refuses(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch", "server", "--address",
         f"127.0.0.1:{_free_port()}",
         *[str(tmp_path / f"d{i}") for i in range(4)]],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "is_available" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("n", range(1, 49))
def test_set_sizes_match_reference(n):
    try:
        want = ref_main.choose_set_drive_count(n)
    except ValueError:
        with pytest.raises(ValueError):
            server_main.choose_set_drive_count(n)
        return
    assert server_main.choose_set_drive_count(n) == want


@pytest.mark.parametrize("n", [18, 32])
def test_several_sets_are_not_served(tmp_path, n):
    with pytest.raises(NotImplementedError, match="ErasureSets"):
        server_main.build_server([str(tmp_path / f"d{i}") for i in range(n)],
                                 "127.0.0.1:0", device="cpu")
    assert not any(tmp_path.iterdir())


def test_build_server_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("MT_ROOT_USER", "env-user")
    monkeypatch.setenv("MT_ROOT_PASSWORD", "env-password")
    srv = server_main.build_server(
        [str(tmp_path / f"d{i}") for i in range(16)], "127.0.0.1:0",
        block_size=4096, device="cpu")
    try:
        er = srv.layer
        assert (er.data_blocks, er.parity) == (12, 4)
        assert srv.lookup_secret("env-user") == "env-password"
        assert srv.lookup_secret("minioadmin") is None
        srv.start()
        assert S3Client(srv.endpoint, "env-user", "env-password"
                        ).list_buckets() == []
    finally:
        srv.stop()

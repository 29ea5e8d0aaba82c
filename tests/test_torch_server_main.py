"""``python -m minio_tpu_torch server`` on the CPU: it serves S3 over
erasure sets when asked for the CPU, refuses to start without a card when
it is not (no fallback), sizes sets as ``minio_tpu`` does (also from
``--set-drive-count`` and ``MT_ERASURE_SET_DRIVE_COUNT``), and serves
every drive count that makes several sets."""

import json
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


def _wait_live(proc, port: int) -> None:
    client = S3Client(f"http://127.0.0.1:{port}", "k", "s", timeout=60)
    deadline = time.monotonic() + 60
    while True:
        try:
            client.request("GET", "/minio/health/live", sign=False)
            return
        except OSError:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "server never answered"
            time.sleep(0.2)


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


@pytest.mark.parametrize("n", range(1, 49))
def test_set_size_override_matches_reference(n):
    for override in (4, 6, 8, 16):
        try:
            want = ref_main.choose_set_drive_count(n, override)
        except ValueError:
            with pytest.raises(ValueError):
                server_main.choose_set_drive_count(n, override)
            continue
        assert server_main.choose_set_drive_count(n, override) == want


@pytest.mark.parametrize("n,sets,per_set,data", [(18, 2, 9, 5),
                                                (32, 2, 16, 12),
                                                (64, 4, 16, 12)])
def test_several_sets_are_served(tmp_path, n, sets, per_set, data):
    dirs = [str(tmp_path / f"d{i}") for i in range(n)]
    srv = server_main.build_server(dirs, "127.0.0.1:0", block_size=4096,
                                   device="cpu")
    try:
        layer = srv.layer
        assert (layer.set_count, layer.set_drive_count) == (sets, per_set)
        assert [(s.data_blocks, s.parity) for s in layer.sets] == \
            [(data, per_set - data)] * sets
        assert layer.monitor is not None and srv.healer is not None
        srv.start()
        client = S3Client(srv.endpoint, "minioadmin", "minioadmin")
        client.make_bucket("many")
        bodies = {f"obj/{i}": os.urandom(700 * i + 1) for i in range(24)}
        for key, body in bodies.items():
            client.put_object("many", key, body)
        for key, body in bodies.items():
            assert client.get_object("many", key).body == body
        keys = [o["key"] for o in client.list_objects("many")["objects"]]
        assert keys == sorted(bodies)
        placed = {layer.get_hashed_set_index(k) for k in bodies}
        assert placed == set(range(sets))
        r = client.request("GET", "/minio/health/cluster", sign=False)
        assert r.status == 200
        assert r.headers["X-Minio-Write-Quorum"] == str(data)
    finally:
        srv.stop()
    ids = {json.loads(open(f"{d}/.mt.sys/format.json").read())["id"]
           for d in dirs}
    assert len(ids) == 1


def test_set_drive_count_from_env_and_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("MT_ERASURE_SET_DRIVE_COUNT", "4")
    srv = server_main.build_server(
        [str(tmp_path / "a" / f"d{i}") for i in range(16)], "127.0.0.1:0",
        block_size=4096, device="cpu")
    srv.stop()
    assert (srv.layer.set_count, srv.layer.set_drive_count) == (4, 4)
    srv = server_main.build_server(
        [str(tmp_path / "b" / f"d{i}") for i in range(16)], "127.0.0.1:0",
        block_size=4096, device="cpu", set_drive_count=8)
    srv.stop()
    assert (srv.layer.set_count, srv.layer.set_drive_count) == (2, 8)
    with pytest.raises(ValueError, match="not divisible"):
        server_main.build_server(
            [str(tmp_path / "c" / f"d{i}") for i in range(16)],
            "127.0.0.1:0", device="cpu", set_drive_count=6)


def test_startup_line_names_sets(tmp_path):
    port = _free_port()
    dirs = [str(tmp_path / f"d{i}") for i in range(18)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", "--device",
         "cpu", "--address", f"127.0.0.1:{port}", "--block-size", "4096",
         *dirs],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        first = proc.stdout.readline()
        _wait_live(proc, port)
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    assert "18 drives, 2 set(s) x 9 drives of 5 data + 4 parity" in first, \
        first + out
    assert proc.returncode == 0, out


def test_build_server_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("MT_ROOT_USER", "env-user")
    monkeypatch.setenv("MT_ROOT_PASSWORD", "env-password")
    srv = server_main.build_server(
        [str(tmp_path / f"d{i}") for i in range(16)], "127.0.0.1:0",
        block_size=4096, device="cpu")
    try:
        er, = srv.layer.sets
        assert (er.data_blocks, er.parity) == (12, 4)
        assert srv.lookup_secret("env-user") == "env-password"
        assert srv.lookup_secret("minioadmin") is None
        srv.start()
        assert S3Client(srv.endpoint, "env-user", "env-password"
                        ).list_buckets() == []
    finally:
        srv.stop()

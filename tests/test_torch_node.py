"""``python -m minio_tpu_torch node``: three node processes on
``--device cpu``, each owning two drives of one six-drive set, over the
real internode RPC (modelled on ``tests/test_multiprocess.py``): a PUT
through one node read through every node, a user added on one node
authorised on another at once, and a node killed, its drives wiped and
the node started again, healed by its own start."""

import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.s3.client import S3Client, S3ClientError

from ._torch_cluster import cluster_state_left, free_ports
from ._torch_versions import body as _body

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = ("n1", "n2", "n3")


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


class Cluster:
    def __init__(self, tmp):
        self.tmp = tmp
        ports = free_ports(6)
        self.rpc, self.s3 = ports[:3], ports[3:]
        self.dirs = {nid: [str(tmp / f"{nid}d{j}") for j in range(2)]
                     for nid in IDS}
        self.peers = [f"{nid}=127.0.0.1:{self.rpc[i]}="
                      f"{','.join(self.dirs[nid])}"
                      for i, nid in enumerate(IDS)]
        self.procs: dict[str, subprocess.Popen] = {}

    def start(self, nid: str) -> None:
        i = IDS.index(nid)
        env = dict(os.environ, MT_CLUSTER_SECRET="node-secret",
                   OMP_NUM_THREADS="1", MT_CRAWL_INTERVAL_S="1000000",
                   PYTHONPATH=ROOT)
        with open(self.tmp / f"{nid}.log", "ab") as log:
            self.procs[nid] = subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch", "node",
                 "--node-id", nid, "--device", "cpu",
                 "--address", f"127.0.0.1:{self.s3[i]}", *self.peers],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)

    def wait(self, nid: str, timeout: float = 90.0) -> None:
        port = self.s3[IDS.index(nid)]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            assert self.procs[nid].poll() is None, self.logs()
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/minio-tpu/metrics",
                    timeout=2).close()
                return
            except OSError:
                time.sleep(0.2)
        raise TimeoutError(f"{nid} never served: {self.logs()}")

    def logs(self) -> str:
        return "\n".join(f"{nid}: {(self.tmp / f'{nid}.log').read_text()}"
                         for nid in IDS
                         if (self.tmp / f"{nid}.log").exists())

    def kill(self, nid: str) -> None:
        p = self.procs.pop(nid)
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)

    def client(self, nid: str, key="minioadmin", secret="minioadmin"):
        return S3Client(f"http://127.0.0.1:{self.s3[IDS.index(nid)]}",
                        key, secret)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("nodes"))
    try:
        for nid in IDS:
            c.start(nid)
        for nid in IDS:
            c.wait(nid)
        yield c
    finally:
        for nid in list(c.procs):
            c.kill(nid)


def test_a_put_on_one_node_reads_on_every_node(cluster):
    c1 = cluster.client("n1")
    c1.make_bucket("mpb")
    body = _body(20_000, 1)
    c1.put_object("mpb", "obj1", body)
    for nid in IDS:
        assert cluster.client(nid).get_object("mpb", "obj1").body == body
    listed = cluster.client("n3").list_objects("mpb")["objects"]
    assert [(o["key"], o["size"]) for o in listed] == [("obj1", 20_000)]


def test_a_user_added_on_one_node_is_allowed_on_another(cluster):
    c1 = cluster.client("n1")
    c1.make_bucket("peerbkt")
    c1.put_object("peerbkt", "doc", b"coherent")
    user = cluster.client("n2", "peeruser", "peersecret123")
    with pytest.raises(S3ClientError):
        user.get_object("peerbkt", "doc")
    adm = AdminClient(f"http://127.0.0.1:{cluster.s3[0]}", "minioadmin",
                      "minioadmin")
    adm.add_user("peeruser", "peersecret123", ["readonly"])
    deadline = time.monotonic() + 10
    while True:         # the reload is asynchronous, but prompt
        try:
            assert user.get_object("peerbkt", "doc").body == b"coherent"
            break
        except S3ClientError:
            assert time.monotonic() < deadline
            time.sleep(0.1)


def test_a_killed_and_wiped_node_is_healed_when_it_starts(cluster):
    c1 = cluster.client("n1")
    c1.make_bucket("healb")
    body = _body(20_000, 2)
    c1.put_object("healb", "healme", body)
    cluster.kill("n3")
    for nid in ("n1", "n2"):
        assert cluster.client(nid).get_object("healb", "healme").body == body
    for d in cluster.dirs["n3"]:
        shutil.rmtree(d)
    cluster.start("n3")
    cluster.wait("n3")
    metas = [os.path.join(d, "healb", "healme", "xl.meta")
             for d in cluster.dirs["n3"]]
    deadline = time.monotonic() + 60
    while not all(os.path.exists(m) for m in metas):
        assert time.monotonic() < deadline, "node 3 was not healed"
        time.sleep(0.2)
    assert cluster.client("n3").get_object("healb", "healme").body == body

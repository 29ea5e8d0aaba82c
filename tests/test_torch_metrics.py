"""The port's Prometheus scrape against ``minio_tpu``'s.

Both servers (``_torch_control.servers``) take the same S3 request
sequence; the counters each scrape gained over it must be equal, sample
for sample, with the ``backend`` label left out (``cuda``, ``cpu`` or
``mesh`` in the port, ``numpy`` in the reference) and drive labels
reduced to the drive's number.  Histograms compare by sample count
(their sums are timings).  The reference runs its codec's plain path
(its native GF library's fused ``encode-framed`` op is switched off),
which names a PUT's op ``encode`` as its device backends and the port
do.  The registry itself, the codec's op accounting (the card's parked
CUDA events included) and the scrape's families are checked on their
own."""

import re
import types

import numpy as np
import pytest
import torch

from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.ops import codec as ref_codec
from minio_tpu.ops import gf8_native
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.ops import codec as port_codec
from minio_tpu_torch.parallel.mesh import make_mesh

from ._torch_control import THRESHOLD, both, client, servers
from ._torch_versions import body

SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$')
LABEL = re.compile(r'([a-zA-Z_]\w*)="((?:[^"\\]|\\.)*)"')
DRIVE = re.compile(r".*/d(\d+)$")


def parse(text: str) -> tuple[dict, dict]:
    """({(name, labels): value}, {family: type}); ``backend`` dropped,
    a drive label reduced to its number."""
    samples, types_ = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split()
            assert fam not in types_, f"second TYPE line for {fam}"
            types_[fam] = kind
            continue
        if not ln or ln.startswith("#"):
            continue
        m = SAMPLE.match(ln)
        assert m, ln
        labels = []
        for k, v in LABEL.findall(m.group(2) or ""):
            if k == "backend":
                continue
            if k == "drive" and DRIVE.match(v):
                v = DRIVE.match(v).group(1)
            labels.append((k, v))
        key = (m.group(1), tuple(sorted(labels)))
        samples[key] = samples.get(key, 0.0) + float(m.group(3))
    return samples, types_


def counters(text: str) -> dict:
    """The counter samples and the histograms' ``_count`` samples."""
    samples, types_ = parse(text)
    hist = {f for f, k in types_.items() if k == "histogram"}
    return {key: v for key, v in samples.items()
            if types_.get(key[0]) == "counter"
            or (key[0].endswith("_count") and key[0][:-6] in hist)}


def delta(after: dict, before: dict) -> dict:
    out = {k: v - before.get(k, 0.0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(gf8_native, "available", lambda: False)
    try:
        with servers(tmp_path_factory.mktemp("metrics"), mp) as (ref, port):
            yield ref, port
    finally:
        mp.undo()


def _sequence(srv) -> None:
    c = client(srv)
    c.make_bucket("mbk")
    for name, size in (("inline", 1000), ("packed", 300_000),
                       ("part", 1_050_000), ("batches", 1_200_000),
                       ("streamed", THRESHOLD + 70_000)):
        c.put_object("mbk", name, body(size, 1))
        assert c.get_object("mbk", name).body == body(size, 1)
        c.head_object("mbk", name)
    c.list_objects("mbk")
    c.delete_object("mbk", "inline")
    c.request("GET", "/mbk/nosuch", expect=(404,))
    c.request("GET", "/minio/health/live", sign=False)


def test_scrape_counters_equal_the_references(pair):
    ref, port = pair
    before = [counters(ref_metrics.render()), counters(port_metrics.render())]
    for srv in pair:
        _sequence(srv)
        srv.healer.sweep()
    r, p = both(ref, port, "GET", "/minio-tpu/metrics", sign=False)
    assert r.status == p.status == 200
    got, want = (delta(counters(x.body.decode()), b)
                 for x, b in ((p, before[1]), (r, before[0])))
    fams = {name for name, _ in got}
    for must in ("mt_s3_requests_api_total", "mt_s3_requests_total",
                 "mt_s3_rx_bytes_total", "mt_s3_tx_bytes_total",
                 "mt_s3_ttfb_seconds_count", "mt_tpu_ops_total",
                 "mt_tpu_bytes_total", "mt_tpu_kernel_seconds_count",
                 "mt_heal_objects_scanned_total",
                 "mt_put_pipeline_writes_total",
                 "mt_commit_group_batches_total"):
        assert must in fams, must
    # the reference has families the port does not fill yet (ROADMAP)
    assert {k: want.get(k) for k in got} == got
    apis = {dict(k[1])["api"]: v for k, v in got.items()
            if k[0] == "mt_s3_requests_api_total"}
    assert apis == {"MakeBucket": 1, "PutObject": 5, "GetObject": 6,
                    "HeadObject": 5, "ListObjectsV2": 1, "DeleteObject": 1}
    ops = {dict(k[1])["op"]: v for k, v in got.items()
           if k[0] == "mt_tpu_ops_total"}
    # the 1.2 MB and the streamed bodies take two batches each
    assert ops == {"encode": 7}


def test_scrape_families_and_gauges(pair):
    _, port = pair
    text = client(port).request("GET", "/minio-tpu/metrics",
                                sign=False).body.decode()
    samples, types_ = parse(text)
    names = {n for n, _ in samples}
    for fam in ("mt_up", "mt_uptime_seconds", "mt_cluster_disk_online_total",
                "mt_cluster_capacity_raw_total_bytes",
                "mt_node_disk_latency_ops", "mt_node_disk_slow",
                "mt_put_pipeline_queue_depth",
                "mt_put_pipeline_overlap_efficiency",
                "mt_put_pipeline_batch_wall_seconds",
                "mt_s3_api_last_minute_requests",
                "mt_heal_objects_per_second", "mt_heal_cycle_active",
                "mt_drive_op_seconds_count"):
        assert fam in names, fam
    assert samples[("mt_up", ())] == 1
    assert samples[("mt_cluster_disk_online_total", ())] == 8
    # every family the port renders is one the reference names
    ref_text = client(pair[0]).request("GET", "/minio-tpu/metrics",
                                       sign=False).body.decode()
    _, ref_types = parse(ref_text)
    assert {f: ref_types.get(f) for f in types_} == types_
    for (name, labels), v in samples.items():
        if name == "mt_tpu_kernel_seconds_count":
            assert samples[("mt_tpu_ops_total", labels)] == v


def test_heal_counters_equal_the_sweeps_stats(pair):
    _, port = pair
    port.healer.sweep()
    samples, _ = parse(client(port).request(
        "GET", "/minio-tpu/metrics", sign=False).body.decode())
    st = port.healer.stats
    assert samples[("mt_heal_objects_scanned_total", ())] == \
        st.objects_scanned
    assert samples[("mt_heal_objects_healed_total", ())] == \
        st.objects_healed
    assert samples[("mt_heal_cycles_total", ())] == st.cycles >= 1
    assert samples[("mt_heal_mrf_queued_total", ())] == 0


def test_registry_renders_as_the_references(monkeypatch):
    """The same counters and histograms give the same text, uptime
    aside."""
    texts = []
    for mod in (ref_metrics, port_metrics):
        reg = mod.Metrics()
        monkeypatch.setattr(mod, "GLOBAL", reg)
        reg.inc("mt_a_total", {"api": 'x"y\\z\nw'})
        reg.inc("mt_a_total", {"api": "b"}, 2.5)
        reg.inc("mt_big_total", value=float(1 << 40))
        reg.observe("mt_h_seconds", {"api": "b"}, 0.004)
        reg.observe("mt_h_seconds", {"api": "b"}, 20.0)
        reg.observe("mt_k_seconds", {"op": "encode"}, 0.0003,
                    buckets=mod.KERNEL_BUCKETS)
        reg.inc("mt_h_seconds_count", value=3)    # collides: dropped
        texts.append(mod.render())
    # the reference adds process gauges the port has no source for
    mine = ("mt_up", "mt_a_", "mt_big_", "mt_h_", "mt_k_")
    kept = [[ln for ln in t.splitlines()
             if ln.split()[2 if ln.startswith("#") else 0].startswith(mine)
             and not ln.startswith("mt_uptime_seconds ")]
            for t in texts]
    assert kept[1] == kept[0] and len(kept[0]) > 40


def _codec_deltas(monkeypatch, calls) -> list[dict]:
    """Per package, what ``calls(codec)`` added to the mt_tpu_* samples."""
    out = []
    for mod, codec in ((ref_metrics, ref_codec.Erasure(4, 2, 4096,
                                                       backend="numpy")),
                       (port_metrics, port_codec.Erasure(4, 2, 4096,
                                                         device="cpu"))):
        monkeypatch.setattr(mod, "GLOBAL", mod.Metrics())
        calls(codec, mod is port_metrics)
        out.append({k: v for k, v in counters(mod.render()).items()
                    if k[0].startswith("mt_tpu_")})
    return out


def test_codec_ops_count_as_the_references(monkeypatch):
    data = body(3 * 4096 + 1000, 2)
    rng = np.random.default_rng(3)

    def calls(codec, port):
        shards = codec.encode_object(np.frombuffer(data, np.uint8)
                                     if not port else data)
        rows = np.asarray(codec.matrix)[4:]
        stripes = rng.integers(0, 256, (3, 4, 1024), dtype=np.uint8)
        codec.apply_matrix(rows, torch.from_numpy(stripes) if port
                           else stripes)
        blocks = codec.encode_data(data[:4096])
        blocks = [b if not port else b.clone() for b in blocks]
        blocks[0] = blocks[5] = None
        codec.decode_data_blocks(blocks)
    ref, port = _codec_deltas(monkeypatch, calls)
    assert port == ref
    assert port[("mt_tpu_ops_total", (("op", "encode"),))] == 1
    assert port[("mt_tpu_ops_total", (("op", "matmul"),))] == 1
    assert port[("mt_tpu_ops_total", (("op", "decode"),))] == 1


def test_codec_backend_label(monkeypatch):
    monkeypatch.setattr(port_metrics, "GLOBAL", port_metrics.Metrics())
    port_codec.Erasure(4, 2, 4096, device="cpu").encode_object(body(5000))
    mesh = port_codec.Erasure(4, 2, 4096,
                              mesh=make_mesh([torch.device("cpu")]))
    framed = mesh.encode_object_framed(body(5000))
    assert framed.shape[0] == 6
    got = {(dict(k[1])["op"], dict(k[1])["backend"]): v
           for k, v in port_metrics.GLOBAL.snapshot().items()
           if k[0] == "mt_tpu_ops_total"}
    assert got == {("encode", "cpu"): 1, ("encode-framed", "mesh"): 1}


class _Event:
    """A CUDA event stand-in: done once its ``done`` is set."""

    def __init__(self, t_ms: float):
        self.t_ms, self.done = t_ms, False

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        return end.t_ms - self.t_ms


def test_card_ops_settle_when_their_kernels_end(monkeypatch):
    """On a card an op is parked with its two events and counted only
    once its end event has completed, in launch order, without waiting;
    its kernel seconds are the events' elapsed time."""
    reg = port_metrics.Metrics()
    monkeypatch.setattr(port_metrics, "GLOBAL", reg)
    monkeypatch.setattr(port_codec, "_PENDING", type(port_codec._PENDING)())
    evs = [(_Event(0.0), _Event(2.0)), (_Event(2.0), _Event(5.0))]
    for i, (a, b) in enumerate(evs):
        port_codec._PENDING.append(
            ({"op": "encode", "backend": "cuda"}, 100 * (i + 1), 4, "",
             a, b))
    port_codec.settle_observations()
    assert reg.snapshot() == {}
    evs[1][1].done = True           # the later op alone cannot settle
    port_codec.settle_observations()
    assert reg.snapshot() == {}
    evs[0][1].done = True
    port_codec.settle_observations()
    snap = reg.snapshot()
    key = (("backend", "cuda"), ("op", "encode"))
    assert snap[("mt_tpu_ops_total", key)] == 2
    assert snap[("mt_tpu_bytes_total", key)] == 300
    (hist,) = [v for k, v in reg.hist_snapshot().items()
               if k[0] == "mt_tpu_kernel_seconds"]
    assert hist[-2] == 2 and hist[-1] == pytest.approx(0.005)
    assert not port_codec._PENDING


def test_card_op_parks_its_events(monkeypatch):
    """The card branch of ``_observe``: the end event is recorded after
    the launches, both parked, nothing counted until they complete."""
    made = []

    class FakeEvent(_Event):
        def __init__(self, enable_timing=False):
            super().__init__(float(len(made)))
            made.append(self)

        def record(self):
            pass

    monkeypatch.setattr(port_metrics, "GLOBAL", port_metrics.Metrics())
    monkeypatch.setattr(port_codec, "_PENDING", type(port_codec._PENDING)())
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    codec = port_codec.Erasure(4, 2, 4096, device="cpu")
    codec.device = types.SimpleNamespace(type="cuda")
    codec.backend = "cuda"
    start = codec._start()
    codec._observe("matmul", 64, start)
    assert len(port_codec._PENDING) == 1 and made == [start, made[1]]
    assert port_metrics.GLOBAL.snapshot() == {}
    made[1].done = True
    port_metrics.render()                        # a scrape settles it
    assert port_metrics.GLOBAL.snapshot()[
        ("mt_tpu_ops_total", (("backend", "cuda"), ("op", "matmul")))] == 1

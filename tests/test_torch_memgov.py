"""The port's memory governor against ``minio_tpu``'s: the same sizes
parsed, the same charges, refusals and releases leave the same
``stats()``, the same MemoryPressure, the same ``api`` knobs loaded and
the same ``mt_mem_*`` lines; a charge abandoned, also while the
governor's own lock is held on the same thread, is released."""

import gc
import threading

import numpy as np
import pytest

from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.utils import kvconfig as ref_kv
from minio_tpu.utils import memgov as ref_mg
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.utils import kvconfig as port_kv
from minio_tpu_torch.utils import memgov as port_mg

from . import _torch_versions  # noqa: F401 — one torch thread

KINDS = ("commit", "multipart", "listing", "select", "cache", "pipeline")


@pytest.mark.parametrize("text", ["0", "268435456", "256MiB", "1GiB", "1.5G",
                                  "10KB", "3MB", "2GB", "7K", "9M", "12B",
                                  "", "x", " 64KiB ", "-1"])
def test_parse_size_equals_the_references(text):
    assert port_mg.parse_size(text) == ref_mg.parse_size(text)
    assert port_mg.parse_size(text, 5) == ref_mg.parse_size(text, 5)


def _run(mod, seed: int) -> tuple:
    """A seeded sequence of charges, optional charges, releases and
    reconfigurations on a fresh governor; (every step's outcome,
    stats)."""
    rng = np.random.default_rng(seed)
    gov = mod.MemoryGovernor(limit_bytes=int(rng.integers(1, 4)) << 20,
                             retry_after_s=2.5)
    held, out = [], []
    for _ in range(200):
        op = rng.integers(0, 10)
        kind = KINDS[rng.integers(0, len(KINDS))]
        n = int(rng.integers(0, 1 << 20))
        if op < 5:
            try:
                held.append(gov.charge(n, kind))
                out.append(("ok", kind, n))
            except mod.MemoryPressure as e:
                out.append(("shed", e.kind, e.want, e.inuse, e.limit,
                            e.retry_after_s, str(e)))
        elif op < 7:
            c = gov.try_charge(n, kind)
            out.append(("try", c is not None))
            if c is not None:
                held.append(c)
        elif op < 9 and held:
            c = held.pop(int(rng.integers(0, len(held))))
            c.release()
            c.release()                 # idempotent
        else:
            gov.configure(int(rng.integers(0, 4)) << 20)
        out.append((gov.inuse_bytes(), gov.inuse_bytes(kind),
                    gov.transient_bytes(), gov.touched))
    return out, gov.stats()


@pytest.mark.parametrize("seed", range(4))
def test_the_same_charges_give_the_same_stats(seed):
    assert _run(port_mg, seed) == _run(ref_mg, seed)


def test_a_shed_counts_into_the_shed_family():
    key = ("mt_mem_shed_total", (("kind", "commit"),))
    for mod, reg in ((ref_mg, ref_metrics.GLOBAL),
                     (port_mg, port_metrics.GLOBAL)):
        before = reg.snapshot().get(key, 0)
        gov = mod.MemoryGovernor(limit_bytes=10)
        with pytest.raises(mod.MemoryPressure):
            gov.charge(11, "commit")
        assert reg.snapshot()[key] == before + 1
        assert gov.stats()["shed"] == {"commit": 1}


@pytest.mark.parametrize("values", [
    {}, {"mem_limit": "256MiB", "mem_retry_after": "3s"},
    {"mem_limit": "1048576", "mem_retry_after": "500ms"},
    {"mem_limit": "bad", "mem_retry_after": "bad"}],
    ids=["defaults", "sizes", "bytes", "bad"])
def test_load_takes_the_api_knobs_alike(values):
    got = []
    for mod, kv in ((ref_mg, ref_kv), (port_mg, port_kv)):
        cfg = kv.Config()
        for k, v in values.items():
            cfg.set("api", k, v)
        gov = mod.MemoryGovernor()
        gov.load(cfg)
        got.append((gov.limit_bytes, gov.retry_after_s))
    assert got[0] == got[1]


def test_an_abandoned_charge_is_released():
    for mod in (ref_mg, port_mg):
        gov = mod.MemoryGovernor()
        c = gov.charge(1000, "multipart")
        assert gov.inuse_bytes() == 1000
        del c
        gc.collect()
        assert gov.inuse_bytes() == 0 and gov.stats()["peak_bytes"] == 1000


def test_a_release_never_waits_on_the_governors_lock():
    """A GC finalizer may release a charge on a thread that holds the
    governor's lock (inside ``stats()``), or while another thread holds
    it: the port's release takes no lock at all."""
    gov = port_mg.MemoryGovernor()
    first, second = gov.charge(4096, "commit"), gov.charge(10, "commit")
    held, go = threading.Event(), threading.Event()

    def hold():
        with gov._mu:
            held.set()
            go.wait(10)
    t = threading.Thread(target=hold)
    t.start()
    assert held.wait(10)
    first.release()                     # returns while another holds it
    go.set()
    t.join(10)
    with gov._mu:                       # and on the thread that holds it
        second.release()
    assert gov.stats()["inuse"] == {}


@pytest.mark.parametrize("state", ["idle", "charged", "shed"])
def test_mem_families_render_alike(monkeypatch, state):
    lines = []
    for mod, metrics in ((ref_mg, ref_metrics), (port_mg, port_metrics)):
        gov = mod.MemoryGovernor()
        monkeypatch.setattr(mod, "GOVERNOR", gov)
        keep = []
        if state != "idle":
            gov.configure(1 << 20)
            keep += [gov.charge(5000, "commit"), gov.charge(70, "listing")]
        if state == "shed":
            with pytest.raises(mod.MemoryPressure):
                gov.charge(2 << 20, "multipart")
        lines.append(metrics._memgov_gauges())
    assert lines[0] == lines[1]
    assert (lines[1] == []) == (state == "idle")

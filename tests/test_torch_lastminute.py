"""The port's last-minute windows and slow-drive detection against
``minio_tpu``'s: the same seeded samples at the same clock give the same
totals, p50 and p99, per op and per drive, the same ageing out of the
window, and the same slow-drive verdicts over the same windows."""

import types

import numpy as np
import pytest

from minio_tpu.obs import lastminute as ref_lm
from minio_tpu.storage import health as ref_health
from minio_tpu_torch.obs import lastminute as port_lm
from minio_tpu_torch.storage import health as port_health

OPS = ("read_all", "write_all", "rename_data")


def _samples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(OPS[int(rng.integers(len(OPS)))],
             int(rng.integers(1, 10_000_000)), int(rng.integers(0, 1 << 20)),
             1000.0 + float(rng.uniform(0, 90)))
            for _ in range(n)]


def _fill(mod, label: str, samples):
    w = mod.OpWindows(label)
    for op, dur, nbytes, t in sorted(samples, key=lambda s: s[3]):
        w.record(op, dur, nbytes, now_s=t)
    return w


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 50), (2, 300)])
@pytest.mark.parametrize("now", [1000.5, 1050.0, 1089.9, 1100.0, 2000.0])
def test_windows_equal_the_references(seed, n, now):
    s = _samples(seed, n)
    ref, port = _fill(ref_lm, "d", s), _fill(port_lm, "d", s)
    assert port.totals(now) == ref.totals(now)
    assert port.p50_all(now) == ref.p50_all(now)
    assert port.p99_all(now) == ref.p99_all(now)
    for op in ref.windows:
        rw, pw = ref.windows[op], port.windows[op]
        assert pw.total(now) == rw.total(now)
        assert (pw.p50(now), pw.p99(now)) == (rw.p50(now), rw.p99(now))
        assert pw.live_samples(now) == rw.live_samples(now)


def test_an_idle_minute_reads_zero():
    w = port_lm.Window()
    w.record(5_000, 10, now_s=100.0)
    assert w.total(100.0) == (1, 5_000, 10) and w.p50(100.0) == 5_000
    assert w.total(161.0) == (0, 0, 0) and w.p50(161.0) == 0


def _drive(mod, label, p50_ns, count):
    d = types.SimpleNamespace(latency=mod.OpWindows(label))
    for _ in range(count):
        d.latency.record("read_all", p50_ns, 0)
    return d


@pytest.mark.parametrize("lat,multiple,min_samples", [
    ((1000, 1000, 1000, 9000), 4.0, 10),     # one slow drive
    ((1000, 1000, 1000, 3000), 4.0, 10),     # not slow enough
    ((1000, 1000, 1000, 9000), 4.0, 50),     # too few samples
    ((1000, 9000), 4.0, 10),                 # leave-one-out in a pair
    ((1000, 1000, 1000, 9000), 10.0, 10),    # a higher multiple
    ((0, 0, 0, 0), 4.0, 10),                 # no traffic
])
def test_slow_drives_equal_the_references(lat, multiple, min_samples):
    got = []
    for mod, lm in ((ref_health, ref_lm), (port_health, port_lm)):
        disks = [_drive(lm, f"d{i}", ns, 20 if ns else 0)
                 for i, ns in enumerate(lat)]
        got.append(mod.slow_drives(disks, multiple, min_samples))
    assert got[0] == got[1]


def test_slow_drives_per_set_and_knobs():
    sets = [[_drive(port_lm, f"a{i}", 1000 if i else 9000, 20)
             for i in range(4)],
            [_drive(port_lm, f"b{i}", 9000, 20) for i in range(4)]]
    layer = types.SimpleNamespace(
        sets=[types.SimpleNamespace(disks=s) for s in sets])
    assert port_health.disks_by_set(layer) == sets
    v = port_health.slow_drives_for_layer(layer)
    # a0 is slow against its own set; set b is uniformly slow, so none is
    assert [e for e, r in sorted(v.items()) if r["slow"]] == ["a0"]
    from minio_tpu_torch.utils.kvconfig import Config
    cfg = Config()
    cfg.set("drive", "slow_latency_multiple", "0.5")
    cfg.set("drive", "slow_min_samples", "0")
    assert port_health.slow_drive_knobs(cfg) == (1.0, 1)
    assert port_health.slow_drive_knobs(cfg) == \
        ref_health.slow_drive_knobs(_ref_config(cfg))


def _ref_config(port_cfg):
    from minio_tpu.utils.kvconfig import Config as RefConfig
    ref = RefConfig()
    for key, value in port_cfg.get_subsys("drive").items():
        ref.set("drive", key, value)
    return ref


def test_drive_windows_keys_by_label():
    a, b = _drive(port_lm, "x", 10, 1), _drive(port_lm, "y", 10, 1)
    got = port_lm.drive_windows([a, None, b, types.SimpleNamespace()])
    assert sorted(got) == ["x", "y"]

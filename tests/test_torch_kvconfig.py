"""The port's kvconfig and the commit plane's live config against
``minio_tpu``'s: the same defaults for every key the port registers, the
same lookup order (environment, then a set value, then the default), the
same refusals, the same durations and the same clamps.  The effect of
each key on a live server is in ``test_torch_admin.py``."""

import pytest

from minio_tpu.storage import commit as ref_commit
from minio_tpu.utils import kvconfig as ref_kv
from minio_tpu_torch.storage import commit as port_commit
from minio_tpu_torch.utils import kvconfig as port_kv

PORT_KEYS = {"heal": ["bitrotscan", "max_sleep"],
             "drive": ["slow_latency_multiple", "slow_min_samples"],
             "pipeline": ["depth", "queue_depth"],
             "commit": ["max_batch", "pack_threshold", "segment_max_bytes"]}


def test_registers_only_the_keys_the_port_reads():
    cfg = port_kv.Config()
    assert cfg.subsystems() == sorted(PORT_KEYS)
    for subsys, keys in PORT_KEYS.items():
        assert sorted(cfg.get_subsys(subsys)) == sorted(keys)


@pytest.mark.parametrize("subsys", sorted(PORT_KEYS))
def test_defaults_equal_the_references(subsys):
    ref = ref_kv.Config().get_subsys(subsys)
    port = port_kv.Config().get_subsys(subsys)
    assert port == {k: ref[k] for k in port}


@pytest.mark.parametrize("subsys,key", [(s, k) for s, ks in PORT_KEYS.items()
                                        for k in ks])
def test_lookup_order_env_then_set_then_default(monkeypatch, subsys, key):
    env = f"MT_{subsys.upper()}_{key.upper()}"
    monkeypatch.delenv(env, raising=False)
    for mod in (ref_kv, port_kv):
        cfg = mod.Config()
        default = cfg.get(subsys, key)
        cfg.set(subsys, key, "7")
        assert cfg.get(subsys, key) == "7"
        monkeypatch.setenv(env, "9")
        assert cfg.get(subsys, key) == "9"
        assert cfg.get_subsys(subsys)[key] == "9"
        monkeypatch.delenv(env)
        assert cfg.get(subsys, key) == "7"
        assert mod.Config().get(subsys, key) == default


@pytest.mark.parametrize("call", [
    lambda c: c.get("nosuch", "x"),
    lambda c: c.get("heal", "nosuch"),
    lambda c: c.set("nosuch", "x", "1"),
    lambda c: c.set("heal", "nosuch", "1"),
    lambda c: c.get_subsys("nosuch"),
], ids=["get-subsys", "get-key", "set-subsys", "set-key", "get-all"])
def test_unknown_subsystems_and_keys_are_refused_alike(call):
    errs = []
    for mod in (ref_kv, port_kv):
        with pytest.raises(KeyError) as e:
            call(mod.Config())
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_keys_the_port_leaves_out_are_refused():
    cfg = port_kv.Config()
    for subsys, key in (("pipeline", "md5_lanes"), ("pipeline", "md5_backend"),
                        ("pipeline", "mesh_batch_bytes"), ("heal", "max_io"),
                        ("commit", "enable"), ("commit", "group_window_us"),
                        ("api", "requests_max")):
        with pytest.raises(KeyError):
            cfg.set(subsys, key, "1")


@pytest.mark.parametrize("text", ["10s", "2m", "500ms", "0", "1.5", "", "x",
                                  "3h", " 4s "])
def test_parse_duration_equals_the_references(text):
    assert port_kv.parse_duration(text) == ref_kv.parse_duration(text)
    assert port_kv.parse_duration(text, 1.0) == \
        ref_kv.parse_duration(text, 1.0)


def test_register_subsys(monkeypatch):
    monkeypatch.setattr(port_kv, "_REGISTRY", dict(port_kv._REGISTRY))
    port_kv.register_subsys("extra", {"k": "v"})
    cfg = port_kv.Config()
    assert cfg.get("extra", "k") == "v"
    assert "extra" in cfg.subsystems()


@pytest.mark.parametrize("values", [
    {},
    {"max_batch": "4", "pack_threshold": "200000",
     "segment_max_bytes": "2097152"},
    {"max_batch": "0", "pack_threshold": "-5", "segment_max_bytes": "1000"},
    {"max_batch": "8", "pack_threshold": "bad"},
], ids=["defaults", "set", "clamped", "bad-value"])
def test_commit_config_loads_as_the_references(monkeypatch, values):
    """The same knobs after the same load, the reference's clamps
    included (a segment is at least 1 MiB), and a bad value leaves the
    last good set."""
    got = []
    for kv, commit in ((ref_kv, ref_commit), (port_kv, port_commit)):
        conf = commit.CommitConfig()
        cfg = kv.Config()
        for k, v in values.items():
            cfg.set("commit", k, v)
        conf.load(cfg)
        got.append((conf.max_batch, conf.pack_threshold,
                    conf.segment_max_bytes))
    assert got[0] == got[1]

"""The port's etcd client (``utils/etcd.py``) and IAM on etcd
(``iam/sys.py`` ``attach_etcd``) against ``minio_tpu``'s, each on its own
``tests/etcd_stub.py``.

The client computes the same prefix ranges and leaves the same keys and
answers after the same calls, failing over alike.  In the layer, the same
IAM mutations (``test_torch_iam._mutate``, with the draws pinned) leave
the same keys and values under ``[<path_prefix>/]config/iam/``, write no
``config/iam.json`` to the drives, and each package loads the other's
state with the same verdicts.  Over HTTP, two servers built with
``MT_ETCD_ENDPOINTS`` answer the same admin identity calls and leave the
same keys; rebuilt on the same drives, and on each other's etcd, their
users still read what they wrote."""

import json
import os

import numpy as np
import pytest

from minio_tpu.iam import policy as ref_pol
from minio_tpu.iam.sys import IAMSys as RefIAM
from minio_tpu.utils import etcd as ref_etcd
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.iam import policy as port_pol
from minio_tpu_torch.iam.sys import IAMSys as PortIAM
from minio_tpu_torch.utils import etcd as port_etcd

from .etcd_stub import StubEtcd
from ._torch_control import AK, PER, SK, both, client, servers
from ._torch_iam import pin_random
from ._torch_ident import no_state_left, stub_running
from ._torch_versions import close, port_layer, ref_layer
from .test_torch_iam import ALPHA_RW, _mutate, _verdicts


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with no_state_left():
        yield


@pytest.fixture(scope="module")
def _stubs():
    r, p = StubEtcd(), StubEtcd()
    with stub_running(r) as r_ep, stub_running(p) as p_ep:
        yield r, r_ep, p, p_ep


@pytest.fixture
def stubs(_stubs):
    """(reference's stub, its endpoint, port's stub, its endpoint), both
    empty."""
    for stub in (_stubs[0], _stubs[2]):
        stub.kv.clear()
    return _stubs


def test_prefix_range_end_alike():
    rng = np.random.default_rng(7)
    cases = [b"", b"a", b"\xff", b"a\xff\xff", b"\xff\xff",
             b"config/iam/"] + [rng.bytes(int(rng.integers(1, 6)))
                                for _ in range(24)]
    for p in cases:
        assert port_etcd.prefix_range_end(p) == ref_etcd.prefix_range_end(p)


def _calls(c) -> list:
    out = [c.put("a/1", b"one"), c.put(b"a/2", "two"), c.put("b", b"\xff"),
           c.put_if_absent("a/3", "three"), c.put_if_absent("a/3", "x"),
           c.get("a/1"), c.get("nope"), c.get_prefix("a/"),
           c.get_prefix(b""), c.delete("a/2"), c.delete("a/2"),
           c.delete_prefix("a/"), c.get_prefix("a/"), c.status()]
    return out


def test_client_calls_alike(stubs):
    r, r_ep, p, p_ep = stubs
    dead = "127.0.0.1:1"
    got = _calls(port_etcd.EtcdClient([dead, p_ep]))
    assert got == _calls(ref_etcd.EtcdClient(f"{dead}, {r_ep}"))
    assert p.kv == r.kv == {b"b": b"\xff"}
    errs = []
    for mod in (port_etcd, ref_etcd):
        c = mod.EtcdClient(dead, timeout=1.0)
        with pytest.raises(mod.EtcdError) as ei:
            c.get("x")
        errs.append((c.status(), str(ei.value).split(":")[0]))
        with pytest.raises(mod.EtcdError):
            mod.EtcdClient(" , ")
    assert errs[0] == errs[1] == (False, "all etcd endpoints failed")

    class Cfg:
        def __init__(self, eps):
            self.eps = eps

        def get(self, subsys, key):
            return self.eps
    for eps in ("", p_ep, f"http://{p_ep}/,{dead}"):
        pc = port_etcd.from_config(Cfg(eps))
        rc = ref_etcd.from_config(Cfg(eps))
        assert (pc and pc._eps) == (rc and rc._eps)


@pytest.mark.parametrize("prefix", ["", "tenant-a/"])
def test_iam_on_etcd_leaves_the_same_keys(tmp_path, monkeypatch, stubs,
                                          prefix):
    r, r_ep, p, p_ep = stubs
    pin_random(monkeypatch)
    ref_l, port_l = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        ref = RefIAM(ref_l, AK, SK)
        ref.attach_etcd(ref_etcd.EtcdClient(r_ep), prefix)
        port = PortIAM(port_l, AK, SK)
        port.attach_etcd(port_etcd.EtcdClient(p_ep), prefix)
        drawn = _mutate(ref, ref_pol)
        assert _mutate(port, port_pol) == drawn
        assert p.kv == r.kv
        assert f"{prefix}config/iam/users/u1".encode() in p.kv
        assert f"{prefix}config/iam/users/u4".encode() not in p.kv
        assert f"{prefix}config/iam/policies/tmp".encode() not in p.kv
        for tag in ("ref", "port"):
            assert not any(os.path.exists(tmp_path / tag / f"d{i}" /
                                          ".mt.sys/config/iam.json")
                           for i in range(6))
        keys = [AK, "u1", "u2", "u3", "u4", drawn[0][0], "sa-fixed",
                drawn[1][0], "nobody"]
        # each package loads the other's keys
        for cls, ep, lay, writer in ((PortIAM, r_ep, port_l, ref),
                                     (RefIAM, p_ep, ref_l, port)):
            reader = cls(lay, AK, SK)
            reader.attach_etcd((port_etcd if cls is PortIAM else ref_etcd)
                               .EtcdClient(ep), prefix)
            assert _verdicts(reader, keys) == _verdicts(writer, keys)
            assert reader.list_policies() == writer.list_policies()
            assert reader.list_ldap_policies() == writer.list_ldap_policies()
        # a removal deletes exactly its key, a mapping adds one
        for iam in (ref, port):
            iam.remove_user("u2")
            iam.set_ldap_policy("cn=g,dc=x", ["readonly"])
        assert p.kv == r.kv
        assert f"{prefix}config/iam/users/u2".encode() not in p.kv
    finally:
        close(ref_l, port_l)


def _etcd_servers(root, mp, ref_ep: str, port_ep: str):
    """``_torch_control.servers`` with each package's server on its own
    etcd: the endpoint is read once, when a server is built."""
    orig = port_main.build_server

    def build_port(*a, **kw):
        mp.setenv("MT_ETCD_ENDPOINTS", port_ep)
        return orig(*a, **kw)
    mp.setenv("MT_ETCD_ENDPOINTS", ref_ep)
    mp.setattr(port_main, "build_server", build_port)
    return servers(root, mp)


def test_servers_keep_iam_on_etcd_across_restarts(tmp_path, stubs):
    r, r_ep, p, p_ep = stubs
    admin = "/minio-tpu/admin/v1/"
    with pytest.MonkeyPatch.context() as mp:
        with _etcd_servers(tmp_path, mp, r_ep, p_ep) as (ref, port):
            for method, route, query, body in (
                    ("PUT", "policy/alpha-rw", "",
                     json.dumps(ALPHA_RW).encode()),
                    ("POST", "add-user", "",
                     b'{"accessKey": "eve", "secretKey": "eve-secret-key",'
                     b' "policies": ["alpha-rw"]}'),
                    ("POST", "add-user-to-group",
                     "accessKey=eve&group=g1", b""),
                    ("GET", "list-users", "", b"")):
                rr, pp = both(ref, port, method, admin + route, query, body)
                assert (pp.status, pp.body) == (rr.status, rr.body)
            for srv in (ref, port):
                client(srv).make_bucket("alpha")
                client(srv, "eve", "eve-secret-key").put_object(
                    "alpha", "k", b"eve-data")
        assert p.kv == r.kv
        assert b"config/iam/users/eve" in p.kv
        for tag in ("ref", "port"):
            assert not any(os.path.exists(tmp_path / tag / f"d{i}" /
                                          ".mt.sys/config/iam.json")
                           for i in range(2 * PER))
        # the same drives and etcd, then each on the other's etcd
        for ref_ep, port_ep in ((r_ep, p_ep), (p_ep, r_ep)):
            with _etcd_servers(tmp_path, mp, ref_ep, port_ep) as (ref, port):
                for srv in (ref, port):
                    got = client(srv, "eve", "eve-secret-key").get_object(
                        "alpha", "k", expect=())
                    assert (got.status, got.body) == (200, b"eve-data")
                    assert client(srv, "eve", "eve-secret-key").request(
                        "GET", "/", expect=()).status == 403

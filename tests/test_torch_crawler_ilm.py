"""The port's crawler applies what falls due with time alone (ROADMAP
Queue 3 items 49 and 44), against ``minio_tpu``'s, which does not.

Item 49: one 100-byte ``cur/a`` under a ``<Days>1</Days>`` Expiration
(or Transition) rule on ``cur/``, the tracker marked for it as
``srv.notify`` marks a PUT, then six ``Crawler.run_cycle`` calls a day
apart on the lifecycle's clock: the rule is first due in the third
cycle, when the bucket has not changed since the cycle before.  The
port applies it there; the reference skips the rule pass of a bucket its
tracker saw no change in, and keeps the object ([ref] cases).

Item 44: a restore of ``Days`` 1, then two crawler cycles a day apart on
the tiering clock.  The port's server crawler puts the stub back over
the lapsed copy (``restub_fn``, wired by ``build_server``), so its GET
answers InvalidObjectState as before the restore; the reference's
crawler leaves the restored copy ([ref] case)."""

import datetime
import os
import time
import types

import pytest

from minio_tpu.background import crawler as ref_cr
from minio_tpu.background import tracker as ref_tr
from minio_tpu.bucket import lifecycle as ref_lc
from minio_tpu.objectlayer import tiering as ref_tier
from minio_tpu.objectlayer.bucket_meta import BucketMetadataSys as RefMeta
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.background import tracker as port_tr
from minio_tpu_torch.bucket import lifecycle as port_lc
from minio_tpu_torch.objectlayer import tiering as port_tier
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys
from minio_tpu_torch.s3.client import S3ClientError
from minio_tpu_torch.server_main import build_server

from ._torch_control import AK, SK, client
from ._torch_versions import body, close, is_port, pin, port_layer, ref_layer

DAY = 24 * 3600
CYCLES = 6
RULES = {
    "expiration": "<Expiration><Days>1</Days></Expiration>",
    "transition": "<Transition><Days>1</Days><StorageClass>COLD"
                  "</StorageClass></Transition>",
}


def lifecycle(action: str) -> str:
    return ("<LifecycleConfiguration><Rule><ID>cur</ID><Status>Enabled"
            "</Status><Filter><Prefix>cur/</Prefix></Filter>"
            f"{RULES[action]}</Rule></LifecycleConfiguration>")


class _Clock(datetime.datetime):
    NOW: datetime.datetime

    @classmethod
    def now(cls, tz=None):
        return cls.NOW if tz is None else cls.NOW.astimezone(tz)


def pin_lifecycle_clock(mp) -> type:
    """Both lifecycle modules read ``clock.NOW`` as their wall clock;
    returns the clock class, whose ``NOW`` a test moves."""
    clock = type("Clock", (_Clock,), {
        "NOW": datetime.datetime.now(datetime.timezone.utc)})
    fake = types.SimpleNamespace(datetime=clock,
                                 timedelta=datetime.timedelta,
                                 timezone=datetime.timezone)
    for mod in (ref_lc, port_lc):
        mp.setattr(mod, "datetime", fake)
    return clock


def _cycles(lay, root, action: str, clock) -> tuple:
    """``cur/a`` under the rule, the tracker marked as a PUT marks it, six
    cycles a day apart; (the index of each cycle's expiries and
    transitions, the object's size and whether it is a stub at the end,
    or None when it is gone)."""
    port = is_port(lay)
    cr, tr, tier = (port_cr, port_tr, port_tier) if port else \
        (ref_cr, ref_tr, ref_tier)
    meta = BucketMetadataSys(lay) if port else RefMeta(lay)
    lay.make_bucket("ilm")
    oi = lay.put_object("ilm", "cur/a", body(100, 4))
    meta.set_config("ilm", "lifecycle", lifecycle(action))
    tsys = tier.TransitionSys(lay)
    tsys.add_tier(tier.DirTier("COLD", f"{root}-tier"))
    crawler = cr.Crawler(lay, bucket_meta=meta, interval_s=3600,
                         transition_fn=tier.transition_fn(tsys),
                         tracker=tr.DataUpdateTracker(bits=1 << 12))
    crawler.tracker.mark("ilm", "cur/a")
    t0 = datetime.datetime.fromtimestamp(oi.mod_time / 1e9,
                                         datetime.timezone.utc)
    seen = []
    for i in range(CYCLES):
        # a minute short of i days: due first at i = 2
        clock.NOW = t0 + datetime.timedelta(days=i, minutes=-1)
        res = crawler.run_cycle()
        if res.expired or res.transitioned:
            seen.append((i, [e[1] for e in res.expired],
                         [t[1] for t in res.transitioned]))
    try:
        left = lay.get_object_info("ilm", "cur/a")
    except Exception:  # noqa: BLE001 — either package's ObjectNotFound
        return seen, None
    return seen, (left.size, tier.is_transitioned(left.user_defined))


@pytest.mark.parametrize("action", ["expiration", "transition"])
def test_a_due_rule_is_applied_in_an_unchanged_bucket(tmp_path, monkeypatch,
                                                      action):
    """The first cycle in which the rule is due applies it on the port,
    though the tracker saw no change since the cycle before."""
    pin(monkeypatch)
    clock = pin_lifecycle_clock(monkeypatch)
    lay = port_layer(tmp_path / "port")
    try:
        seen, left = _cycles(lay, tmp_path / "port", action, clock)
    finally:
        close(lay)
    if action == "expiration":
        assert seen == [(2, ["cur/a"], [])] and left is None
    else:
        # a later cycle passes the stub to ``transition_fn`` again, which
        # leaves it as it is (as the reference's does in a changed bucket)
        assert seen[0] == (2, [], ["cur/a"]) and left == (0, True)
        assert len(os.listdir(f"{tmp_path / 'port'}-tier")) == 1


@pytest.mark.parametrize("action", ["expiration", "transition"])
def test_ref_never_applies_a_rule_due_in_an_unchanged_bucket(
        tmp_path, monkeypatch, action):
    """[ref] item 49: the reference evaluates the rules in the first two
    cycles only (the tracker's mark is in the cycle before the second),
    so the object stays as it was written."""
    pin(monkeypatch)
    clock = pin_lifecycle_clock(monkeypatch)
    lay = ref_layer(tmp_path / "ref")
    try:
        seen, left = _cycles(lay, tmp_path / "ref", action, clock)
    finally:
        close(lay)
    assert seen == [] and left == (100, False)


# -- item 44: lapsed restores -------------------------------------------------

def pin_tier_clock(mp, start: float) -> types.SimpleNamespace:
    """Both tiering modules read ``clock.now`` as their wall clock."""
    clock = types.SimpleNamespace(now=start)
    fake = types.SimpleNamespace(time=lambda: clock.now,
                                 strftime=time.strftime, gmtime=time.gmtime)
    for mod in (ref_tier, port_tier):
        mp.setattr(mod, "time", fake)
    return clock


def test_the_crawler_puts_the_stub_back_over_a_lapsed_restore(
        tmp_path, monkeypatch):
    """On the port's server, a restore of one day, then two crawler
    cycles a day apart: the second puts the stub back (no hand call to
    the sweep), the version is the empty stub without a restore again,
    and GET answers InvalidObjectState as before the restore."""
    clock = pin_tier_clock(monkeypatch, time.time())
    monkeypatch.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    srv = build_server(dirs, "127.0.0.1:0", AK, SK, block_size=4096,
                       device="cpu")
    srv.start()
    try:
        c = client(srv)
        AdminClient(srv.endpoint, AK, SK).add_tier(
            {"type": "dir", "name": "COLD", "path": str(tmp_path / "tier")})
        c.make_bucket("rst")
        data = body(3000, 5)
        c.put_object("rst", "obj", data)
        oi = srv.layer.get_object_info("rst", "obj")
        oi.transition_tier = "COLD"
        srv.transition.transition("rst", oi)
        with pytest.raises(S3ClientError) as e:
            c.get_object("rst", "obj")
        assert e.value.code == "InvalidObjectState"
        c.request("POST", "/rst/obj", "restore",
                  b"<RestoreRequest><Days>1</Days></RestoreRequest>",
                  expect=(202,))
        assert c.get_object("rst", "obj").body == data
        kept = srv.crawler.run_cycle().restubbed
        clock.now += DAY + 60
        put_back = srv.crawler.run_cycle().restubbed
        assert kept == [] and put_back == [("rst", "obj", "")]
        with pytest.raises(S3ClientError) as e:
            c.get_object("rst", "obj")
        assert e.value.code == "InvalidObjectState"
        stub = srv.layer.get_object_info("rst", "obj")
        assert stub.size == 0 and port_tier.is_transitioned(
            stub.user_defined)
        assert port_tier.META_RESTORE_EXPIRY not in stub.user_defined
        assert srv.crawler.run_cycle().restubbed == []
    finally:
        srv.stop()


def test_ref_crawler_leaves_a_lapsed_restore(tmp_path, monkeypatch):
    """[ref] item 44: the reference's crawler has no sweep, so two cycles
    a day apart leave the restored copy on the drives."""
    pin(monkeypatch)
    clock = pin_tier_clock(monkeypatch, time.time())
    lay = ref_layer(tmp_path / "ref")
    try:
        lay.make_bucket("rst")
        data = body(3000, 5)
        lay.put_object("rst", "obj", data)
        tsys = ref_tier.TransitionSys(lay)
        tsys.add_tier(ref_tier.DirTier("COLD", str(tmp_path / "tier")))
        oi = lay.get_object_info("rst", "obj")
        oi.transition_tier = "COLD"
        tsys.transition("rst", oi)
        assert tsys.restore("rst", "obj", 1) is True
        crawler = ref_cr.Crawler(lay, bucket_meta=RefMeta(lay),
                                 interval_s=3600,
                                 transition_fn=ref_tier.transition_fn(tsys))
        crawler.run_cycle()
        clock.now += DAY + 60
        crawler.run_cycle()
        info, back = lay.get_object("rst", "obj")
        assert back == data and info.size == len(data)
        assert ref_tier.restore_expiry(info.user_defined) and \
            not ref_tier.restore_valid(info.user_defined)
    finally:
        close(lay)

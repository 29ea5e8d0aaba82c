"""The port's OPA webhook (``secure/opa.py``) and IAM's authorizer against
``minio_tpu``'s, on an HTTP stub like ``tests/test_secure.py``'s that
allows only ``s3:GetObject``.

In the module: the same PolicyArgs documents (``auth_args``) from inputs
drawn from a numpy seed, the same webhook from the same ``policy_opa``
values, and, per answer shape (``result``, ``result.allow``, a bare
boolean, garbage, a 500, a stall past the timeout, a dead port), the same
verdict, the same posts, the same backoffs under a pinned ``random`` and
the same ``mt_policy_webhook_total`` counts.  Over HTTP, both servers
armed through ``SetConfigKV policy_opa``: the same posted ``input``
documents, a user's GET allowed and PUT denied, root and unknown keys
never sent to the webhook, a session policy bounding the webhook's
allow, denial when the webhook stalls, is down or answers garbage, the
same counts, and local policy back when ``url`` is emptied."""

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.secure import opa as ref_opa
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.secure import opa as port_opa

from ._torch_control import AK, SK, client, servers
from ._torch_ident import counted, counter, no_state_left

FAMILY = "mt_policy_webhook_total"
DEAD = "http://127.0.0.1:1/x"


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with no_state_left():
        yield


class _Opa(BaseHTTPRequestHandler):
    """``/<shape>/<tag>``: ``allow`` answers {"result": <GetObject?>},
    ``obj`` {"result": {"allow": ...}}, ``bare`` a bare boolean,
    ``garbage`` no JSON, ``fail`` a 500, ``slow`` sleeps past the
    client's timeout first.  Every post is recorded with its tag."""
    protocol_version = "HTTP/1.0"

    def log_message(self, *a):
        pass

    def do_POST(self):
        doc = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        shape, tag = self.path.strip("/").split("/")
        self.server.seen.append((tag, shape, doc,
                                 self.headers.get("Authorization", "")))
        ok = doc["input"]["action"] == "s3:GetObject"
        if shape == "slow":
            time.sleep(0.4)
        status, body = 200, {"allow": {"result": ok},
                             "obj": {"result": {"allow": ok}},
                             "bare": ok, "slow": {"result": ok},
                             "fail": {"result": True}}.get(shape)
        body = b"<not-json>" if shape == "garbage" else json.dumps(body) \
            .encode()
        if shape == "fail":
            status = 500
        try:
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass            # the client stopped waiting (``slow``)


@pytest.fixture(scope="module")
def opa():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Opa)
    httpd.seen = []
    t = threading.Thread(target=httpd.serve_forever, name="opa-stub")
    t.start()
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(10)


def _args(rng) -> list:
    actions = ("s3:GetObject", "s3:PutObject", "s3:ListBucket",
               "s3:DeleteObject")
    out = []
    for _ in range(4):
        bucket = ("", "b1", "bkt-x")[int(rng.integers(0, 3))]
        key = "/".join("k" + str(int(v)) for v in
                       rng.integers(0, 9, int(rng.integers(0, 3))))
        resource = f"{bucket}/{key}" if bucket and key else bucket
        ctx = None if rng.random() < 0.5 else \
            {"aws:SourceIp": [f"10.0.0.{int(rng.integers(0, 9))}"]}
        out.append(("ak" + str(int(rng.integers(0, 99))),
                    actions[int(rng.integers(0, 4))], resource, ctx,
                    bool(rng.random() < 0.5)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_auth_args_alike(seed):
    for a in _args(np.random.default_rng(seed)):
        assert port_opa.auth_args(*a) == ref_opa.auth_args(*a)


def test_webhook_from_config_alike():
    for values in ({}, {"url": "  "}, {"url": "http://x/"},
                   {"url": "http://x/", "timeout": "700ms",
                    "retry_attempts": "3", "auth_token": "t"},
                   {"url": "http://x/", "timeout": "bad",
                    "retry_attempts": "x"},
                   {"url": "http://x/", "timeout": "0s",
                    "retry_attempts": "0"}):
        class Cfg:
            @staticmethod
            def get(subsys, key, v=values):
                if key not in v and key != "url":
                    raise KeyError(key)
                return v.get(key, "")
        hooks = [mod.OpaWebhook.from_config(Cfg) for mod in (port_opa,
                                                             ref_opa)]
        assert [h and (h.url, h.auth_token, h.timeout_s, h.retry.attempts,
                       h.retry.base_s, h.retry.cap_s) for h in hooks] == \
            [h and (h.url, h.auth_token, h.timeout_s, h.retry.attempts,
                    h.retry.base_s, h.retry.cap_s) for h in hooks[::-1]]


@pytest.mark.parametrize("shape", ["allow", "obj", "bare", "garbage",
                                   "fail", "slow", "dead"])
def test_webhook_decides_alike(opa, shape):
    httpd, url = opa
    args = [port_opa.auth_args(*a)
            for a in _args(np.random.default_rng(len(shape)))] + \
        [port_opa.auth_args("ak", "s3:GetObject", "b1/k", None, False)]
    out = []
    for tag, mod, mtr in (("port", port_opa, port_metrics),
                          ("ref", ref_opa, ref_metrics)):
        before = counter(mtr, FAMILY)
        hook = mod.OpaWebhook(DEAD if shape == "dead" else
                              f"{url}/{shape}/{tag}", auth_token="tok",
                              timeout_s=0.1, attempts=2)
        slept = []
        hook.retry.rng = random.Random(5)
        hook.retry.sleep = slept.append
        t0 = time.monotonic()
        verdicts = [hook.is_allowed(a) for a in args]
        took = time.monotonic() - t0
        posts = [(sh, doc, auth) for t, sh, doc, auth in httpd.seen
                 if t == tag]
        del httpd.seen[:]
        out.append((verdicts, posts, slept, counted(mtr, FAMILY, before)))
        # two attempts of at most 0.1 s for each of five decisions,
        # and the backoffs (recorded, not slept)
        assert took < 5 * 2 * 0.1 + 1.0
    assert out[0] == out[1]
    denied = shape in ("garbage", "fail", "slow", "dead")
    assert out[0][0] == [not denied and a["action"] == "s3:GetObject"
                         for a in args]


# -- the authorizer on the servers ---------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        with servers(tmp_path_factory.mktemp("opa"), mp) as (ref, port):
            for srv in (ref, port):
                assert srv.iam.authorizer is None
                root = client(srv)
                root.make_bucket("opabkt")
                root.put_object("opabkt", "k", b"data")
                AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK) \
                    .add_user("alice", "alice-secret-12", ["readwrite"])
            yield ref, port


def _arm(srv, url: str, **knobs) -> None:
    adm = AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)
    for k, v in knobs.items():
        adm.set_config_kv("policy_opa", k, v)
    adm.set_config_kv("policy_opa", "url", url)


def _steps(srv, url: str, tag: str) -> list:
    """The requests of one server; (what each answered, its seconds)."""
    alice = client(srv, "alice", "alice-secret-12")
    root = client(srv)
    rows = []

    def row(name, resp, t0):
        rows.append((name, resp.status, time.monotonic() - t0))
    _arm(srv, f"{url}/allow/{tag}", auth_token="opatok", timeout="2s",
         retry_attempts="2")
    rows.append(("armed", srv.iam.authorizer is not None, 0.0))
    for name, c, method, path, body in (
            ("alice-get", alice, "GET", "/opabkt/k", b""),
            ("alice-put", alice, "PUT", "/opabkt/denied", b"y"),
            ("alice-list", alice, "GET", "/opabkt", b""),
            ("root-put", root, "PUT", "/opabkt/adm", b"z")):
        t0 = time.monotonic()
        row(name, c.request(method, path, body=body, expect=()), t0)
    # a session bounded to ListBucket: its GET never reaches the webhook
    sess = alice.assume_role(900, {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Action": ["s3:ListBucket"],
         "Resource": ["arn:aws:s3:::*"]}]})
    t0 = time.monotonic()
    row("session-get", sess.get_object("opabkt", "k", expect=()), t0)
    t0 = time.monotonic()
    row("session-list", sess.request("GET", "/opabkt", expect=()), t0)
    rows.append(("ghost", srv.iam.is_allowed("ghost", "s3:GetObject",
                                             "opabkt/k"), 0.0))
    for shape, knobs in (("slow", {"timeout": "200ms",
                                   "retry_attempts": "2"}),
                         ("dead", {}), ("garbage", {})):
        _arm(srv, DEAD if shape == "dead" else f"{url}/{shape}/{tag}",
             **knobs)
        t0 = time.monotonic()
        row(f"alice-get-{shape}", alice.get_object("opabkt", "k",
                                                   expect=()), t0)
    _arm(srv, "")
    rows.append(("disarmed", srv.iam.authorizer is None, 0.0))
    t0 = time.monotonic()
    row("alice-put-local", alice.request("PUT", "/opabkt/post", body=b"w",
                                         expect=()), t0)
    return rows


def test_servers_authorise_through_the_webhook_alike(pair, opa):
    httpd, url = opa
    out = []
    for srv, tag, mtr in ((pair[0], "ref", ref_metrics),
                          (pair[1], "port", port_metrics)):
        before = counter(mtr, FAMILY)
        rows = _steps(srv, url, tag)
        # a session's access key is drawn: masked
        posts = [(sh, {**doc["input"], "account": "<session>"}
                  if doc["input"]["account"].startswith("STS")
                  else doc["input"], auth)
                 for t, sh, doc, auth in httpd.seen if t == tag]
        out.append(([r[:2] for r in rows], posts,
                    counted(mtr, FAMILY, before)))
        # a stalled webhook denies within timeout x retry_attempts
        # (plus the backoff, at most 0.05 s)
        stalled = dict((r[0], r[2]) for r in rows)["alice-get-slow"]
        assert stalled < 2 * 0.2 + 0.05 + 1.0
    del httpd.seen[:]
    assert out[1] == out[0]
    assert out[0][0] == [
        ("armed", True), ("alice-get", 200), ("alice-put", 403),
        ("alice-list", 403), ("root-put", 200), ("session-get", 403),
        ("session-list", 403), ("ghost", False), ("alice-get-slow", 403),
        ("alice-get-dead", 403), ("alice-get-garbage", 403),
        ("disarmed", True), ("alice-put-local", 200)]
    posts = out[0][1]
    assert all(p[2] == "Bearer opatok" for p in posts)
    assert {p[1]["account"] for p in posts} == {"alice", "<session>"}
    counts = out[0][2]
    assert counts == {(("verdict", "allow"),): 1.0,
                      (("verdict", "deny"),): 3.0,
                      (("verdict", "error"),): 3.0}

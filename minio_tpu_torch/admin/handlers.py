"""The admin API and the metrics scrape (``minio_tpu/admin/handlers.py``,
cmd/admin-router.go:38), for the routes whose subsystems the port has.

``/minio-tpu/metrics`` is the Prometheus scrape: public, GET only.  The
admin routes live under ``/minio-tpu/admin/v1/`` on the S3 listener and
admit an identity that IAM allows ``admin:*`` (the root credential, or a
user, service account or session with such a policy); any other gets
AccessDenied.  They answer JSON:

  GET  info                     server info (``_server_info``)
  GET  config[/<subsys>]        the live kvconfig, all or one subsystem
  PUT  config/<subsys>/<key>    set a key (the body is the value; sealed
                                onto the drives), then reload what reads
                                it
  POST heal/<bucket>[/<prefix>] heal the bucket and every version of
                                every object under the prefix
                                (``?scan=deep``, ``?remove=true``)
  GET  heal-status              the heal sweep's counters
  GET  storageinfo              per-drive capacity, state and slow flag;
                                on a pools layer the pools' rows too
  POST service?action=stop|restart
  GET  kms-key-status           a data key made and unsealed through the
                                key service (``crypto/kms.py``)
  GET  tier                     the remote tiers, credentials redacted
  PUT  tier                     {"type": "dir", "name", "path"} or
                                {"type": "s3", "name", "endpoint",
                                "bucket", "access_key", "secret_key",
                                "prefix", "region"}: add a tier (409 for a
                                name in use), persisted in
                                ``tiers/tiers.json``
  POST add-user                 {"accessKey", "secretKey", "policies"}
  GET  list-users
  POST remove-user?accessKey=   (its service accounts go too)
  POST set-user-status?accessKey=&status=enabled|disabled
  POST set-user-policy?accessKey=&policies=a,b  (an unknown key holding
                                '=' maps an LDAP DN when LDAP is set)
  POST add-service-account      {"parent", "accessKey", "secretKey"}
  GET  list-service-accounts[?parent=]
  POST delete-service-account?accessKey=
  GET  list-groups
  POST add-user-to-group?accessKey=&group=
  POST set-group-policy         {"group", "policies"}
  GET  policy                   the policy names
  GET|PUT|DELETE policy/<name>  one policy document
  GET  datausageinfo            the crawler's last persisted usage (404
                                before the first cycle)
  GET  data-usage               that usage and the hard quota's view of it
                                (snapshot plus the writes since)
  GET  get-bucket-quota?bucket=
  POST set-bucket-quota?bucket= {"quota": bytes, "quotatype": "hard"}
  POST clear-bucket-quota?bucket=
  GET  background-status        the heal sweep's, the crawler's, the
                                replication plane's and the
                                rebalancer's progress (mrf null: the
                                port has none; replication null until a
                                remote target is set or loaded)
  GET  pool-status              each pool's index, id, status, geometry,
                                free bytes and, after a crawler cycle, its
                                usedBytes and objects
  POST pool-add                 {"dirs", "setCount", "setDriveCount",
                                "kwargs"}: attach a pool
  POST pool-decommission?pool=  drain a pool (by index or id)
  POST pool-decommission-abort?pool=
  GET  rebalance-status         the rebalancer's state and counters
  GET  targets                  each event target's delivery state,
                                queue, store and counters
                                (``obs/egress.py`` ``status``)
  POST targets/replay           drain every target's store now;
                                {"replayed": {"type/name": n}}
  POST set-remote-target        {"sourceBucket", "arn", "endpoint",
                                "target_bucket", "access_key",
                                "secret_key", "region"}: the bucket's
                                replication target (persisted in
                                ``replication/targets.json``); starts
                                the replication plane
  GET  list-remote-targets      {bucket: target}
  POST remove-remote-target?bucket=
  GET  replication-stats        queued, replicated, replicaBytes,
                                failed, deletesReplicated
  GET  bandwidth                per bucket: limitInBytesPerSecond,
                                totalBytesMoved
  POST set-bandwidth-limit?bucket=&limit=  bytes/s; 0 lifts it

On a cluster member (``cluster.run_node``) ``targets``,
``targets/replay`` and ``background-status`` add a ``peers`` list, each
peer's answer or ``{"node", "error"}``, unless ``?local=true``; and
``/minio-tpu/metrics?scope=cluster`` merges every node's scrape into one
document, each sample labelled ``server``, with ``mt_node_scrape_ok``
per node (a peer that fails is marked 0 and counted in
``mt_node_scrape_errors_total``; the fan-out runs once per
``CLUSTER_SCRAPE_TTL_S``, since the route takes no credentials).

An unknown user or policy answers 404, another IAM refusal 400, a
malformed request 400, a pool route on a layer without pools 400 "not a
pooled deployment", a refused pool change 400, a replication route
that needs the plane before it runs 400 "replication not enabled", the
removal of a target a bucket does not have 404.  Every other admin route
answers the S3 NotImplemented error.  The reference's heal route lists only latest
versions and stops at 10,000 objects
(``minio_tpu/admin/handlers.py:1427-1454``); this one pages and heals
every version, as the heal sweep does.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ..background.crawler import load_usage
from ..background.heal import iter_versions
from ..bucket.quota import Quota
from ..events.brokers import NOTIFY_SUBSYSTEMS
from ..iam import policy as iampol
from ..iam.sys import IAMError, NoSuchPolicy, NoSuchUser
from ..objectlayer import interface as ol
from ..objectlayer import tiering
from ..objectlayer.pools import is_pooled
from ..utils.kvconfig import parse_storage_class
from . import metrics

ADMIN_PREFIX = "/minio-tpu/admin/v1"
METRICS_PATH = "/minio-tpu/metrics"

_START = time.time()

# kvconfig subsystem -> the server hook that pushes its keys into what
# reads them (the drive knobs are read at every scrape); a notify_*
# subsystem rebuilds its event target
_RELOADS = {"api": "reload_api_config",
            "pipeline": "reload_pipeline_config",
            "commit": "reload_commit_config",
            "heal": "reload_background_config",
            "scanner": "reload_background_config",
            "rebalance": "reload_background_config",
            "policy_opa": "reload_policy_config",
            "rpc": "reload_rpc_config",
            **{sub: "reload_egress_config" for sub in NOTIFY_SUBSYSTEMS}}


def handle(h, srv, path: str, query: dict, payload: bytes) -> bool:
    """Answer a metrics or admin request; False when ``path`` is
    neither.  ``h`` is the HTTP handler (``_send``, ``command``,
    ``access_key``), ``srv`` the S3Server."""
    from ..s3.server import S3Error
    if path == METRICS_PATH:
        qm = {k: v[0] for k, v in query.items()}
        body = _metrics_cluster(srv, qm) if qm.get("scope") == "cluster" \
            else render_local(srv)
        h._send(200, body.encode(),
                content_type="text/plain; version=0.0.4")
        return True
    if not path.startswith(ADMIN_PREFIX + "/"):
        return False
    if not srv.iam.is_allowed(h.access_key, iampol.ADMIN_ALL):
        raise S3Error("AccessDenied")
    route = path[len(ADMIN_PREFIX) + 1:]
    q1 = {k: v[0] for k, v in query.items()}

    def send_json(doc, status=200) -> bool:
        h._send(status, json.dumps(doc).encode(),
                content_type="application/json")
        return True

    try:
        if route == "info" and h.command == "GET":
            return send_json(_server_info(srv))
        if route.startswith("config"):
            return _config(h, srv, route, payload, send_json)
        if route == "heal-status" and h.command == "GET":
            healer = srv.healer
            return send_json({
                "sweep": healer.stats.to_dict() if healer else None,
                "mrf": None})
        if route.startswith("heal") and h.command == "POST":
            return _heal(srv, route, q1, send_json)
        if route == "storageinfo" and h.command == "GET":
            return send_json(_storage_info(srv))
        if route == "datausageinfo" and h.command == "GET":
            info = load_usage(srv.layer)
            if info is None:
                return send_json({"error": "no usage data yet"}, 404)
            return send_json(json.loads(info.to_json()))
        if route == "data-usage" and h.command == "GET":
            info = load_usage(srv.layer)
            return send_json({
                "persisted": json.loads(info.to_json())
                if info is not None else None,
                "cache": srv.usage.snapshot_doc()})
        if route == "targets" and h.command == "GET":
            return send_json(_with_peers(
                srv, q1, {"node": srv.node_name,
                          "targets": srv.egress.status()},
                "target_status", 5.0))
        if route == "targets/replay" and h.command == "POST":
            # not idempotent: a replayed call would deliver again what
            # the first drained
            return send_json(_with_peers(
                srv, q1, {"node": srv.node_name,
                          "replayed": srv.egress.replay_all()},
                "target_replay", 30.0, idempotent=False))
        if route == "background-status" and h.command == "GET":
            return send_json(_with_peers(
                srv, q1, {**background_status(srv), "node": srv.node_name},
                "background_status", 5.0))
        pool_route = _POOL_ROUTES.get((h.command, route))
        if pool_route is not None:
            return pool_route(srv, q1, payload, send_json)
        quota_route = _QUOTA_ROUTES.get((h.command, route))
        if quota_route is not None:
            return quota_route(srv, q1, payload, send_json)
        repl_route = _REPLICATION_ROUTES.get((h.command, route))
        if repl_route is not None:
            return repl_route(srv, q1, payload, send_json)
        if route == "service" and h.command == "POST":
            return _service(srv, q1, send_json)
        if route == "kms-key-status" and h.command == "GET":
            return _kms_key_status(srv, send_json)
        if route == "tier" and h.command in ("GET", "PUT"):
            return _tier(h, srv, payload, send_json)
        if route.startswith("policy"):
            return _policy(h, srv, route, payload, send_json)
        iam_route = _IAM_ROUTES.get((h.command, route))
        if iam_route is not None:
            return iam_route(h, srv, q1, payload, send_json)
    except (KeyError, json.JSONDecodeError) as e:
        return send_json({"error": f"bad request: {e}"}, 400)
    except (NoSuchUser, NoSuchPolicy) as e:
        return send_json({"error": str(e)}, 404)
    except IAMError as e:
        return send_json({"error": str(e)}, 400)
    raise S3Error("NotImplemented")


# -- identities (cmd/admin-handlers-users.go) ----------------------------------

def _ok(send_json) -> bool:
    return send_json({"status": "ok"})


def _add_user(h, srv, q1, payload, send_json) -> bool:
    doc = json.loads(payload)
    srv.iam.add_user(doc["accessKey"], doc["secretKey"],
                     doc.get("policies", []))
    return _ok(send_json)


def _list_users(h, srv, q1, payload, send_json) -> bool:
    return send_json({u.access_key: {"status": u.status,
                                     "policies": u.policies}
                      for u in srv.iam.list_users()})


def _remove_user(h, srv, q1, payload, send_json) -> bool:
    srv.iam.remove_user(q1["accessKey"])
    return _ok(send_json)


def _set_user_status(h, srv, q1, payload, send_json) -> bool:
    status = q1.get("status")
    if status not in ("enabled", "disabled"):
        return send_json({"error": "status must be enabled|disabled"}, 400)
    srv.iam.set_user_status(q1["accessKey"], status == "enabled")
    return _ok(send_json)


def _set_user_policy(h, srv, q1, payload, send_json) -> bool:
    """An unknown access key that looks like a DN (it holds ``=``) maps
    the LDAP user or group DN when LDAP is configured
    (cmd/admin-handlers-users.go, the LDAP sys type)."""
    target = q1["accessKey"]
    pols = [p for p in q1.get("policies", "").split(",") if p]
    try:
        srv.iam.attach_policy(target, pols)
    except NoSuchUser:
        if "=" not in target or srv.ldap is None:
            raise
        srv.iam.set_ldap_policy(target, pols)
    return _ok(send_json)


def _add_service_account(h, srv, q1, payload, send_json) -> bool:
    doc = json.loads(payload) if payload else {}
    sa = srv.iam.new_service_account(doc.get("parent", h.access_key),
                                     doc.get("accessKey"),
                                     doc.get("secretKey"))
    return send_json({"accessKey": sa.access_key,
                      "secretKey": sa.secret_key})


def _list_service_accounts(h, srv, q1, payload, send_json) -> bool:
    return send_json({u.access_key: {"parent": u.parent_user}
                      for u in srv.iam.list_service_accounts(
                          q1.get("parent"))})


def _delete_service_account(h, srv, q1, payload, send_json) -> bool:
    ak = q1.get("accessKey", "")
    try:
        u = srv.iam.get_user(ak)
    except NoSuchUser:
        return send_json({"error": "no such account"}, 404)
    if not u.parent_user or u.expiration:
        # a user here would take all its service accounts with it
        return send_json({"error": f"{ak!r} is not a service account"},
                         400)
    srv.iam.remove_user(ak)
    return _ok(send_json)


def _list_groups(h, srv, q1, payload, send_json) -> bool:
    return send_json(srv.iam.list_groups())


def _add_user_to_group(h, srv, q1, payload, send_json) -> bool:
    srv.iam.add_user_to_group(q1["accessKey"], q1["group"])
    return _ok(send_json)


def _set_group_policy(h, srv, q1, payload, send_json) -> bool:
    doc = json.loads(payload)
    srv.iam.set_group_policy(doc["group"], doc["policies"])
    return _ok(send_json)


_IAM_ROUTES = {
    ("POST", "add-user"): _add_user,
    ("GET", "list-users"): _list_users,
    ("POST", "remove-user"): _remove_user,
    ("POST", "set-user-status"): _set_user_status,
    ("POST", "set-user-policy"): _set_user_policy,
    ("POST", "add-service-account"): _add_service_account,
    ("GET", "list-service-accounts"): _list_service_accounts,
    ("POST", "delete-service-account"): _delete_service_account,
    ("GET", "list-groups"): _list_groups,
    ("POST", "add-user-to-group"): _add_user_to_group,
    ("POST", "set-group-policy"): _set_group_policy,
}


# -- bucket quotas (cmd/admin-bucket-handlers.go) ------------------------------

def _get_bucket_quota(srv, q1, payload, send_json) -> bool:
    raw = srv.bucket_meta.get_config(q1["bucket"], "quota")
    return send_json(json.loads(raw) if raw else {})


def _set_bucket_quota(srv, q1, payload, send_json) -> bool:
    """madmin SetBucketQuota; a malformed document is refused here, not
    on every later PUT."""
    bucket = q1.get("bucket", "")
    try:
        srv.layer.get_bucket_info(bucket)
        Quota.parse(payload)
    except (ol.ObjectLayerError, ValueError) as e:
        return send_json({"error": str(e)}, 400)
    srv.bucket_meta.set_config(bucket, "quota", payload.decode())
    return _ok(send_json)


def _clear_bucket_quota(srv, q1, payload, send_json) -> bool:
    bucket = q1.get("bucket", "")
    try:
        srv.layer.get_bucket_info(bucket)
    except ol.ObjectLayerError as e:
        return send_json({"error": str(e)}, 400)
    srv.bucket_meta.set_config(bucket, "quota", None)
    return _ok(send_json)


_QUOTA_ROUTES = {
    ("GET", "get-bucket-quota"): _get_bucket_quota,
    ("POST", "set-bucket-quota"): _set_bucket_quota,
    ("POST", "clear-bucket-quota"): _clear_bucket_quota,
}


# -- server pools (cmd/admin-handlers-pools.go) -------------------------------

def _not_pooled(send_json) -> bool:
    return send_json({"error": "not a pooled deployment"}, 400)


def _pool_arg(q1: dict):
    """``?pool=``: an index (all digits) or a pool id (a uuid)."""
    p = q1["pool"]
    return int(p) if p.isdigit() else p


def _merge_pool_usage(srv, pools: list) -> None:
    """The crawler's per-pool usage into pool-status rows, by pool id;
    a deployment that never ran a cycle has none."""
    try:
        info = load_usage(srv.layer)
    except Exception:  # noqa: BLE001 — a system volume below quorum
        return
    pu = info.pools_usage if info is not None else None
    if not pu:
        return
    for row in pools:
        u = pu.get(row.get("id", ""))
        if u:
            row["usedBytes"] = u.get("bytes", 0)
            row["objects"] = u.get("objects", 0)


def _pool_status(srv, q1, payload, send_json) -> bool:
    if not is_pooled(srv.layer):
        return _not_pooled(send_json)
    pools = srv.layer.pool_status()
    _merge_pool_usage(srv, pools)
    return send_json({"pools": pools})


def _pool_add(srv, q1, payload, send_json) -> bool:
    """Attach a pool under traffic; the rebalancer is woken."""
    if not is_pooled(srv.layer):
        return _not_pooled(send_json)
    doc = json.loads(payload)
    try:
        idx = srv.layer.attach_pool(doc["dirs"], int(doc["setCount"]),
                                    int(doc["setDriveCount"]),
                                    **doc.get("kwargs", {}))
    except ValueError as e:
        return send_json({"error": str(e)}, 400)
    if srv.rebalancer is not None:
        srv.rebalancer.kick()
    return send_json({"status": "ok", "pool": idx})


def _pool_decommission(srv, q1, payload, send_json) -> bool:
    """Mark a pool draining and wake the rebalancer to drain it."""
    if not is_pooled(srv.layer):
        return _not_pooled(send_json)
    try:
        idx = srv.layer.start_decommission(_pool_arg(q1))
    except ValueError as e:
        return send_json({"error": str(e)}, 400)
    if srv.rebalancer is not None:
        srv.rebalancer.kick()
    return send_json({"status": "draining", "pool": idx})


def _pool_decommission_abort(srv, q1, payload, send_json) -> bool:
    if not is_pooled(srv.layer):
        return _not_pooled(send_json)
    try:
        idx = srv.layer.abort_decommission(_pool_arg(q1))
    except ValueError as e:
        return send_json({"error": str(e)}, 400)
    return send_json({"status": "active", "pool": idx})


def _rebalance_status(srv, q1, payload, send_json) -> bool:
    rb = srv.rebalancer
    return send_json(rb.status() if rb is not None else None)


_POOL_ROUTES = {
    ("GET", "pool-status"): _pool_status,
    ("POST", "pool-add"): _pool_add,
    ("POST", "pool-decommission"): _pool_decommission,
    ("POST", "pool-decommission-abort"): _pool_decommission_abort,
    ("GET", "rebalance-status"): _rebalance_status,
}


# -- bucket replication (cmd/admin-bucket-handlers.go remote targets,
# -- cmd/admin-handlers.go bandwidth) -----------------------------------------

def _not_enabled(send_json) -> bool:
    return send_json({"error": "replication not enabled"}, 400)


def _set_remote_target(srv, q1, payload, send_json) -> bool:
    from ..background.replication import ReplicationTarget
    doc = json.loads(payload)
    bucket = doc.pop("sourceBucket")
    srv.start_replication().set_target(bucket, ReplicationTarget(**doc))
    return _ok(send_json)


def _list_remote_targets(srv, q1, payload, send_json) -> bool:
    repl = srv.replication
    return send_json({b: t.to_dict() for b, t in repl.targets().items()}
                     if repl else {})


def _remove_remote_target(srv, q1, payload, send_json) -> bool:
    repl = srv.replication
    if repl is None:
        return _not_enabled(send_json)
    bucket = q1["bucket"]
    if repl.get_target(bucket) is None:
        return send_json({"error": f"no remote target for {bucket!r}"}, 404)
    repl.remove_target(bucket)
    return _ok(send_json)


def _replication_stats(srv, q1, payload, send_json) -> bool:
    repl = srv.replication
    return send_json(repl.stats.to_dict() if repl else {})


def _bandwidth(srv, q1, payload, send_json) -> bool:
    repl = srv.replication
    return send_json(repl.monitor.report() if repl else {})


def _set_bandwidth_limit(srv, q1, payload, send_json) -> bool:
    repl = srv.replication
    if repl is None:
        return _not_enabled(send_json)
    repl.monitor.set_limit(q1["bucket"], int(q1.get("limit", "0")))
    return _ok(send_json)


_REPLICATION_ROUTES = {
    ("POST", "set-remote-target"): _set_remote_target,
    ("GET", "list-remote-targets"): _list_remote_targets,
    ("POST", "remove-remote-target"): _remove_remote_target,
    ("GET", "replication-stats"): _replication_stats,
    ("GET", "bandwidth"): _bandwidth,
    ("POST", "set-bandwidth-limit"): _set_bandwidth_limit,
}


def _with_peers(srv, q1: dict, out: dict, method: str, timeout_s: float,
                idempotent: bool = True) -> dict:
    """``out`` with ``peers``: each peer's answer to ``peer.<method>``,
    or ``{"node", "error"}``; on a cluster member, unless
    ``?local=true``."""
    if srv.peers is not None and q1.get("local") != "true":
        out["peers"] = [
            {"node": ep, "error": err} if err else r
            for ep, r, err in srv.peers.call_all(
                method, timeout_s=timeout_s, idempotent=idempotent)]
    return out


def render_local(srv, node: str | None = None) -> str:
    """This server's scrape (with ``node``, every sample labelled
    ``server``): the plain route, the local part of the cluster scrape
    and the peer call all render it here."""
    return metrics.render(srv.layer, healer=srv.healer, config=srv.config,
                          api_stats=srv.api_stats, crawler=srv.crawler,
                          rebalancer=srv.rebalancer, egress=srv.egress,
                          replication=srv.replication, node=node)


CLUSTER_SCRAPE_TTL_S = 2.0


def _metrics_cluster(srv, q1: dict) -> str:
    """``metrics?scope=cluster``: every peer's scrape (at once, bounded by
    ``?timeout``, 1-15 s, default 10) and this node's merged into one
    document.  One fan-out at a time and its answer kept for
    ``CLUSTER_SCRAPE_TTL_S``: the route is public."""
    cache = srv.__dict__.setdefault(
        "_cluster_scrape", {"mu": threading.Lock(), "ts": 0.0, "text": ""})
    with cache["mu"]:
        now = time.monotonic()
        if cache["text"] and now - cache["ts"] < CLUSTER_SCRAPE_TTL_S:
            return cache["text"]
        try:
            timeout_s = min(max(float(q1.get("timeout", 10) or 10), 1.0),
                            15.0)
        except ValueError:
            timeout_s = 10.0
        docs, status = [], []
        if srv.peers is not None and srv.peers.clients:
            for ep, reply, err in srv.peers.call_all("metrics_render",
                                                     timeout_s=timeout_s):
                doc, name = None, ep
                if isinstance(reply, dict):
                    doc, name = reply.get("doc"), reply.get("node", ep)
                if err or not isinstance(doc, str):
                    metrics.GLOBAL.inc("mt_node_scrape_errors_total",
                                       {"peer": ep})
                    status.append((name, 0))
                else:
                    docs.append(doc)
                    status.append((name, 1))
        text = metrics.merge_expositions(
            [render_local(srv, node=srv.node_name)] + docs)
        lines = ["# TYPE mt_node_scrape_ok gauge"]
        for server, ok in [(srv.node_name, 1)] + status:
            lines.append(f'mt_node_scrape_ok{{server="'
                         f'{metrics._escape_label(server)}"}} {ok}')
        text += "\n".join(lines) + "\n"
        cache["ts"], cache["text"] = time.monotonic(), text
        return text


def background_status(srv) -> dict:
    """The background loops' live progress (madmin BgHealState, ``mc
    admin scanner status``)."""
    healer, crawler, rb = srv.healer, srv.crawler, srv.rebalancer
    repl = srv.replication
    return {
        "healing": {"progress": healer.progress.snapshot(),
                    "stats": healer.stats.to_dict()}
        if healer is not None else None,
        "scanner": {"progress": crawler.progress.snapshot(),
                    "cycles": crawler.cycles}
        if crawler is not None else None,
        "replication": {"progress": repl.progress.snapshot(),
                        "stats": repl.stats.to_dict(),
                        "bandwidth": repl.monitor.report()}
        if repl is not None else None,
        "mrf": None,
        "rebalance": rb.status() if rb is not None else None,
    }


def _policy(h, srv, route: str, payload: bytes, send_json) -> bool:
    """``policy``: the names; ``policy/<name>``: one document, read,
    put or deleted (a canned policy cannot be deleted)."""
    from ..s3.server import S3Error
    parts = route.split("/", 1)
    if len(parts) == 1:
        if h.command == "GET":
            return send_json({"policies": srv.iam.list_policies()})
        raise S3Error("MethodNotAllowed")
    name = parts[1]
    if h.command == "GET":
        return send_json(json.loads(srv.iam.get_policy(name).to_json()))
    if h.command == "PUT":
        srv.iam.set_policy(name, iampol.Policy.from_json(payload))
        return _ok(send_json)
    if h.command == "DELETE":
        srv.iam.delete_policy(name)
        return _ok(send_json)
    raise S3Error("MethodNotAllowed")


def _server_info(srv) -> dict:
    """madmin ServerInfo (cmd/admin-handlers.go ServerInfoHandler)."""
    dinfo = []
    for d in metrics._collect_disks(srv.layer):
        try:
            info = d.disk_info()
            dinfo.append({"state": "ok", "endpoint": info.endpoint,
                          "total": info.total, "free": info.free,
                          "disk_id": info.disk_id})
        except Exception as e:  # noqa: BLE001 — an offline drive
            dinfo.append({"state": "faulty", "error": str(e)})
    try:
        buckets = [b.name for b in srv.layer.list_buckets()]
    except Exception:  # noqa: BLE001 — a layer below quorum still answers
        buckets = []
    return {
        "mode": "distributed-erasure-tpu",
        "region": srv.region,
        "uptime_seconds": round(time.time() - _START, 1),
        "drives": dinfo,
        "buckets": buckets,
        "backend_version": 1,
    }


def _config(h, srv, route: str, payload: bytes, send_json) -> bool:
    from ..s3.server import S3Error
    parts = route.split("/")
    cfg = srv.config
    if h.command == "GET" and len(parts) == 1:
        return send_json({s: cfg.get_subsys(s) for s in cfg.subsystems()})
    if h.command == "GET" and len(parts) == 2:
        return send_json(cfg.get_subsys(parts[1]))
    if h.command == "PUT" and len(parts) == 3:
        value = payload.decode()
        if parts[1] == "storage_class" and value:
            # judged against the set size now: a bad class would fail
            # every later write that names it
            from ..s3.handlers_object import _set_drive_count
            try:
                parse_storage_class(value,
                                    _set_drive_count(srv.layer) or 16)
            except ValueError as e:
                return send_json({"error": str(e)}, 400)
        cfg.set(parts[1], parts[2], value)
        hook = _RELOADS.get(parts[1])
        if hook is not None:
            getattr(srv, hook)()
        return send_json({"status": "ok"})
    raise S3Error("MethodNotAllowed")


def _kms_key_status(srv, send_json) -> bool:
    """GET kms-key-status (madmin KMSKeyStatus): a data key made and
    unsealed through the server's key service."""
    try:
        key, sealed = srv.kms.generate_key({"probe": "admin"})
        ok = srv.kms.unseal_key(sealed, {"probe": "admin"}) == key
        return send_json({"key_id": srv.kms.key_id, "encryption_ok": ok,
                          "decryption_ok": ok})
    except Exception as e:  # noqa: BLE001 — any failure of the service
        return send_json({"key_id": srv.kms.key_id, "error": str(e)}, 500)


def _tier(h, srv, payload: bytes, send_json) -> bool:
    """GET tier (madmin ListTiers: no credential leaves the server) and
    PUT tier (madmin AddTier).  A name in use is refused, 409: replacing
    its tier would strand every stub that names it."""
    tsys = srv.transition
    if h.command == "GET":
        return send_json(json.loads(tsys.to_json(redact=True)))
    doc = json.loads(payload)
    name = doc.get("name", "")
    if not name:
        return send_json({"error": "tier name required"}, 400)
    if name in tsys.tiers:
        return send_json({"error": f"tier {name!r} already exists"}, 409)
    try:
        tier = tiering.tier_from_doc(doc)
    except KeyError as e:
        return send_json({"error": f"missing tier config field {e}"}, 400)
    except ValueError:
        return send_json({"error": "unknown tier type"}, 400)
    tsys.add_tier(tier)
    tsys.save()
    return _ok(send_json)


def _heal(srv, route: str, q1: dict, send_json) -> bool:
    """POST heal/<bucket>[/<prefix>]: heal the bucket, then every version
    of every object under the prefix, paged; per-version results."""
    parts = route.split("/", 2)
    bucket = parts[1] if len(parts) > 1 else ""
    prefix = parts[2] if len(parts) > 2 else ""
    if not bucket:
        return send_json({"error": "bucket required"}, 400)
    deep = q1.get("scan") == "deep"
    remove = q1.get("remove") == "true"
    layer = srv.layer
    healed_sets = layer.heal_bucket(bucket)
    results = []
    for oi in iter_versions(layer, bucket, prefix):
        row = {"object": oi.name, "version_id": oi.version_id}
        try:
            r = layer.heal_object(bucket, oi.name,
                                  version_id=oi.version_id, deep=deep,
                                  remove_dangling=remove)
            row.update(before_ok=r.before_ok, after_ok=r.after_ok,
                       healed=r.healed_disks,
                       dangling_purged=r.dangling_purged)
        except Exception as e:  # noqa: BLE001 — one version's failure
            row["error"] = str(e)
        results.append(row)
    return send_json({"bucket": bucket, "bucket_sets_healed": healed_sets,
                      "objects": results})


def _storage_info(srv) -> dict:
    """madmin StorageInfo: per-drive capacity and state, with the slow
    flag for each drive that has last-minute traffic."""
    from ..storage.health import slow_drive_knobs, slow_drives_for_layer
    mult, mins = slow_drive_knobs(srv.config)
    verdicts = slow_drives_for_layer(srv.layer, multiple=mult,
                                     min_samples=mins)
    disks = []
    for si, d in metrics._collect_disks_with_set(srv.layer):
        try:
            info = d.disk_info()
        except Exception as e:  # noqa: BLE001 — an offline drive
            disks.append({"set": si, "endpoint": d.endpoint(),
                          "state": "offline", "error": str(e)})
            continue
        entry = {"set": si, "endpoint": d.endpoint(), "state": "ok",
                 "total": info.total, "used": info.used, "free": info.free}
        v = verdicts.get(d.endpoint())
        if v is not None:
            entry["slow"] = v["slow"]
        disks.append(entry)
    out = {"disks": disks, "backend": "erasure-tpu"}
    if is_pooled(srv.layer):
        pools = srv.layer.pool_status()
        _merge_pool_usage(srv, pools)
        out["pools"] = pools
    return out


def _service(srv, q1: dict, send_json) -> bool:
    """madmin ServiceAction (cmd/admin-handlers.go ServiceHandler): the
    reply goes out first, then ``stop`` stops the server (its
    ``serve_forever`` returns) and ``restart`` re-executes
    ``python -m minio_tpu_torch`` with the same arguments."""
    action = q1.get("action", "")
    if action not in ("stop", "restart"):
        return send_json({"error": f"unknown action {action!r}"}, 400)

    def later():
        time.sleep(0.2)
        if action == "restart":
            # through -m: __main__.py cannot run as a plain script
            os.execv(sys.executable, [sys.executable, "-m",
                                      "minio_tpu_torch", *sys.argv[1:]])
        srv.stop()

    threading.Thread(target=later, daemon=True,
                     name="mt-admin-service").start()
    return send_json({"status": "ok", "action": action})

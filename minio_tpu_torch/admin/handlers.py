"""The admin API and the metrics scrape (``minio_tpu/admin/handlers.py``,
cmd/admin-router.go:38), for the routes whose subsystems the port has.

``/minio-tpu/metrics`` is the Prometheus scrape: public, GET only.  The
admin routes live under ``/minio-tpu/admin/v1/`` on the S3 listener and
need the root credential (the port has no IAM yet, ROADMAP Queue 1 item
14): any other identity gets AccessDenied.  They answer JSON:

  GET  info                     server info (``_server_info``)
  GET  config[/<subsys>]        the live kvconfig, all or one subsystem
  PUT  config/<subsys>/<key>    set a key (the body is the value), then
                                reload what reads it
  POST heal/<bucket>[/<prefix>] heal the bucket and every version of
                                every object under the prefix
                                (``?scan=deep``, ``?remove=true``)
  GET  heal-status              the heal sweep's counters
  GET  storageinfo              per-drive capacity, state and slow flag
  POST service?action=stop|restart

Every other admin route answers the S3 NotImplemented error.  The
reference's heal route lists only latest versions and stops at 10,000
objects (``minio_tpu/admin/handlers.py:1427-1454``); this one pages and
heals every version, as the heal sweep does.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ..background.heal import iter_versions
from . import metrics

ADMIN_PREFIX = "/minio-tpu/admin/v1"
METRICS_PATH = "/minio-tpu/metrics"

_START = time.time()

# kvconfig subsystem -> the server hook that pushes its keys into what
# reads them (the drive knobs are read at every scrape)
_RELOADS = {"pipeline": "reload_pipeline_config",
            "commit": "reload_commit_config",
            "heal": "reload_background_config"}


def handle(h, srv, path: str, query: dict, payload: bytes) -> bool:
    """Answer a metrics or admin request; False when ``path`` is
    neither.  ``h`` is the HTTP handler (``_send``, ``command``,
    ``access_key``), ``srv`` the S3Server."""
    from ..s3.server import S3Error
    if path == METRICS_PATH:
        body = metrics.render(srv.layer, healer=srv.healer,
                              config=srv.config, api_stats=srv.api_stats)
        h._send(200, body.encode(),
                content_type="text/plain; version=0.0.4")
        return True
    if not path.startswith(ADMIN_PREFIX + "/"):
        return False
    if not h.access_key or h.access_key != srv.access_key:
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
        if route == "service" and h.command == "POST":
            return _service(srv, q1, send_json)
    except (KeyError, json.JSONDecodeError) as e:
        return send_json({"error": f"bad request: {e}"}, 400)
    raise S3Error("NotImplemented")


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
        cfg.set(parts[1], parts[2], payload.decode())
        hook = _RELOADS.get(parts[1])
        if hook is not None:
            getattr(srv, hook)()
        return send_json({"status": "ok"})
    raise S3Error("MethodNotAllowed")


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
    return {"disks": disks, "backend": "erasure-tpu"}


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

"""Server bootstrap and CLI (``minio_tpu/server_main.py``,
cmd/server-main.go:389 serverMain).

``python -m minio_tpu_torch server /data1 ... /dataN`` serves S3 over
the N drives as the reference lays them out: sets of the largest size in
4..16 that divides N (or ``--set-drive-count``), every drive's
format.json loaded or written, each drive behind a health proxy, a drive
monitor that reconnects returning drives and heals their set, the
background heal sweep, the crawler (data usage, lifecycle expiry and
transitions to the server's tiers, stubs put back over lapsed restores,
the hard quotas' usage) with its data-update tracker, bucket
replication to the remote targets the drives hold, the request plane's
limits and deadlines, IAM (users, service accounts, STS sessions,
policies) loaded from the drives, and the control plane: the live
kvconfig (``MT_<SUBSYS>_<KEY>`` environment overrides), the admin API
and the Prometheus scrape.  ``config.json`` and ``iam.json`` are sealed
at rest under the root secret, with AES-GCM from the system libcrypto;
without it the server does not start.  Erasure coding and bitrot hashing
run on the card (``--device cuda``, the default, which raises without
one) or, when asked, on the CPU through the kernels' plain versions
(``--device cpu``).

``python -m minio_tpu_torch node --node-id n1 n1=host:port=/d1,/d2
n2=...`` starts one member of a cluster (``cluster.run_node``): its
drives and lock table served over the internode RPC on ``host:port``,
the erasure sets over every node's drives in the order given (the same
on every node), S3 on ``--address``.  The RPC secret comes from
``--secret`` or ``MT_CLUSTER_SECRET``; without one, a default serves
only loopback endpoints.  With ``MT_TLS_ENABLE=on`` and
``MT_TLS_CERTS_DIR`` (``public.crt``/``private.key``, ``internode/``,
``CAs/``) both planes run over TLS: the internode RPC under mutual TLS,
every peer dialled at ``https://``, and S3 served over ``https``.  The
gateway subcommand is not served.
"""

from __future__ import annotations

import argparse
import os
import sys

from .background.crawler import Crawler
from .background.heal import BackgroundHealer
from .background.replication import load_targets
from .background.tracker import DataUpdateTracker
from .device import resolve
from .objectlayer.erasure_object import DEFAULT_BLOCK_SIZE
from .objectlayer.sets import ErasureSets
from .objectlayer.tiering import transition_fn
from .s3.server import S3Server
from .secure import configcrypt
from .secure.certs import CertManager, TLSConfigError
from .utils.kvconfig import Config

# set sizing (cmd/endpoint-ellipses.go:44 setSizes{4..16})
SET_SIZES = list(range(16, 3, -1))


def choose_set_drive_count(n: int, override: int | None = None) -> int:
    """The largest valid set size that divides the drive count
    (getSetIndexes, cmd/endpoint-ellipses.go:132), or ``override`` when
    it divides it; 1-3 drives form one set."""
    if override:
        if n % override != 0:
            raise ValueError(f"drive count {n} not divisible by "
                             f"set size {override}")
        return override
    if n < 4:
        return n
    for size in SET_SIZES:
        if n % size == 0:
            return size
    raise ValueError(f"no valid erasure set size for {n} drives "
                     "(need a divisor in 4..16)")


def build_server(dirs: list[str], address: str = "127.0.0.1:9000",
                 access_key: str | None = None,
                 secret_key: str | None = None,
                 block_size: int | None = None, region: str = "us-east-1",
                 device: str = "cuda",
                 set_drive_count: int | None = None) -> S3Server:
    """``ErasureSets`` over ``dirs`` (parity by set size) with its drive
    monitor running, behind an S3Server bound to ``address`` with IAM
    and the kvconfig read from the drives, the crawler
    (``MT_CRAWL_INTERVAL_S``, default 60 s) and the heal sweep
    (``MT_HEAL_INTERVAL_S``, ``MT_HEAL_DEEP_EVERY``) attached, a
    data-update tracker shared by the crawler and the listing caches,
    and the kvconfig's api, pipeline, commit, heal and scanner knobs
    applied; not started, but for the replication workers, started when
    the drives hold remote targets.  Raises RuntimeError when libcrypto cannot be
    bound (nothing is sealed in the clear)."""
    access_key = access_key or os.environ.get("MT_ROOT_USER", "minioadmin")
    secret_key = secret_key or os.environ.get("MT_ROOT_PASSWORD",
                                              "minioadmin")
    sdc = choose_set_drive_count(
        len(dirs), set_drive_count
        or int(os.environ.get("MT_ERASURE_SET_DRIVE_COUNT", 0)) or None)
    resolve(device)                 # no card: refuse before formatting
    configcrypt.require_encryption()
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    layer = ErasureSets.from_dirs(
        dirs, len(dirs) // sdc, sdc,
        block_size=block_size or DEFAULT_BLOCK_SIZE, device=device)
    srv = None
    try:
        layer.start_drive_monitor()
        host, _, port = address.rpartition(":")
        srv = S3Server(layer, access_key=access_key, secret_key=secret_key,
                       region=region, host=host or "0.0.0.0",
                       port=int(port))
        srv.iam.load()
    except BaseException:
        if srv is not None:
            srv.httpd.server_close()
        layer.close()
        raise
    tracker = DataUpdateTracker()
    srv.attach_tracker(tracker)
    srv.crawler = Crawler(
        layer, bucket_meta=srv.bucket_meta,
        interval_s=float(os.environ.get("MT_CRAWL_INTERVAL_S", "60")),
        transition_fn=transition_fn(srv.transition), tracker=tracker,
        restub_fn=srv.transition.put_stub_back)
    srv.healer = BackgroundHealer(
        layer, interval_s=float(os.environ.get("MT_HEAL_INTERVAL_S", "3600")),
        deep_every=int(os.environ.get("MT_HEAL_DEEP_EVERY", "8")))
    srv.attach_background(srv.crawler, srv.healer)
    if load_targets(layer):
        # replication goes on after a restart (the reference builds it
        # only on a set-remote-target call)
        srv.start_replication()
    srv.reload_pipeline_config()
    srv.reload_commit_config()
    return srv


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="minio_tpu_torch",
        description="S3 object storage over erasure sets on a CUDA card")
    sub = parser.add_subparsers(dest="command", required=True)
    ps = sub.add_parser("server", help="start the object storage server")
    ps.add_argument("dirs", nargs="+", help="drive directories")
    ps.add_argument("--address", default="0.0.0.0:9000")
    ps.add_argument("--access-key", default=None,
                    help="root access key (env MT_ROOT_USER)")
    ps.add_argument("--secret-key", default=None,
                    help="root secret key (env MT_ROOT_PASSWORD)")
    ps.add_argument("--set-drive-count", type=int, default=None,
                    help="drives per erasure set (env "
                         "MT_ERASURE_SET_DRIVE_COUNT; default: the largest "
                         "of 4..16 that divides the drive count)")
    ps.add_argument("--block-size", type=int, default=None)
    ps.add_argument("--region", default="us-east-1")
    ps.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    pn = sub.add_parser("node", help="start one distributed cluster node")
    pn.add_argument("--node-id", required=True)
    pn.add_argument("--secret", default=None,
                    help="internode RPC secret (env MT_CLUSTER_SECRET)")
    pn.add_argument("--address", default="127.0.0.1:0",
                    help="S3 front address")
    pn.add_argument("--set-drive-count", type=int, default=None)
    pn.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    pn.add_argument("peers", nargs="+",
                    help="layout: id=host:rpcport=dir1,dir2 per node, in "
                         "the same order on every node")
    args = parser.parse_args(argv)
    if args.command == "node":
        return _node(parser, args)
    try:
        srv = build_server(args.dirs, args.address, args.access_key,
                           args.secret_key, args.block_size, args.region,
                           args.device, args.set_drive_count)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"minio_tpu_torch: {e}", file=sys.stderr)
        return 1
    layer = srv.layer
    er = layer.sets[0]
    try:
        print(f"minio_tpu_torch server: {len(args.dirs)} drives, "
              f"{layer.set_count} set(s) x {layer.set_drive_count} drives "
              f"of {er.data_blocks} data + {er.parity} parity, block "
              f"{er.block_size} B, device {er.device}", flush=True)
        print(f"S3 endpoint: {srv.endpoint.split('://')[0]}://"
              f"{args.address.rpartition(':')[0] or '0.0.0.0'}:{srv.port}",
              flush=True)
        srv.start_background()
        srv.serve_forever()         # until ^C or admin service?action=stop
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def _node(parser, args) -> int:
    """The ``node`` subcommand: run one member until its admin stop or
    ^C."""
    from .cluster import NodeSpec, run_node
    secret = args.secret or os.environ.get("MT_CLUSTER_SECRET", "")
    try:
        # the ``tls`` subsystem (MT_TLS_ENABLE, MT_TLS_CERTS_DIR) puts
        # both planes under TLS; ``run_node`` then dials every peer at
        # https:// (ROADMAP Queue 3 record 63)
        tls = CertManager.from_config(Config())
    except (TLSConfigError, OSError) as e:
        print(f"minio_tpu_torch: {e}", file=sys.stderr)
        return 1
    specs = []
    for p in args.peers:
        nid, endpoint, dirs = p.split("=", 2)
        drive_dirs = [d for d in dirs.split(",") if d]
        if nid == args.node_id:
            for d in drive_dirs:
                os.makedirs(d, exist_ok=True)
        specs.append(NodeSpec(nid, drive_dirs,
                              endpoint=f"http://{endpoint}"))
    if not secret:
        # the RPC plane reads and writes every shard: a well-known secret
        # is refused unless every endpoint is on loopback
        if any(not s.endpoint.startswith(("http://127.", "http://localhost"))
               for s in specs):
            parser.error("distributed nodes require --secret or "
                         "MT_CLUSTER_SECRET (refusing a default secret on "
                         "non-loopback endpoints)")
        secret = "cluster-secret"
    try:
        resolve(args.device)        # no card: refuse before anything
        configcrypt.require_encryption()
        node, srv = run_node(
            args.node_id, specs, secret, args.address, args.set_drive_count,
            access_key=os.environ.get("MT_ROOT_USER", "minioadmin"),
            secret_key=os.environ.get("MT_ROOT_PASSWORD", "minioadmin"),
            tls=tls, device=args.device)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"minio_tpu_torch: {e}", file=sys.stderr)
        return 1
    shost = args.address.rpartition(":")[0] or "127.0.0.1"
    scheme = srv.endpoint.split("://")[0]
    print(f"minio_tpu_torch node {args.node_id}: rpc={node.rpc.endpoint} "
          f"s3={scheme}://{shost}:{srv.port} device {args.device}",
          flush=True)
    try:
        srv.shutdown.wait()         # admin service?action=stop, or ^C
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

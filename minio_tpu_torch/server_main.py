"""Server bootstrap and CLI (``minio_tpu/server_main.py``,
cmd/server-main.go:389 serverMain).

``python -m minio_tpu_torch server /data1 ... /dataN`` serves S3 over
the N drives as the reference lays them out: sets of the largest size in
4..16 that divides N (or ``--set-drive-count``), every drive's
format.json loaded or written, each drive behind a health proxy, a drive
monitor that reconnects returning drives and heals their set, the
background heal sweep, and the control plane: the live kvconfig
(``MT_<SUBSYS>_<KEY>`` environment overrides), the admin API and the
Prometheus scrape.  Erasure coding and bitrot hashing run on the card
(``--device cuda``, the default, which raises without one) or, when
asked, on the CPU through the kernels' plain versions (``--device
cpu``).  The reference's crawler, IAM, gateway and node subcommands are
not served.
"""

from __future__ import annotations

import argparse
import os
import sys

from .background.heal import BackgroundHealer
from .device import resolve
from .objectlayer.erasure_object import DEFAULT_BLOCK_SIZE
from .objectlayer.sets import ErasureSets
from .s3.server import S3Server
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
    monitor running, behind an S3Server bound to ``address`` with the
    heal sweep attached (``MT_HEAL_INTERVAL_S``, ``MT_HEAL_DEEP_EVERY``)
    and the kvconfig's pipeline, commit and heal knobs applied; not
    started."""
    access_key = access_key or os.environ.get("MT_ROOT_USER", "minioadmin")
    secret_key = secret_key or os.environ.get("MT_ROOT_PASSWORD",
                                              "minioadmin")
    sdc = choose_set_drive_count(
        len(dirs), set_drive_count
        or int(os.environ.get("MT_ERASURE_SET_DRIVE_COUNT", 0)) or None)
    resolve(device)                 # no card: refuse before formatting
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    layer = ErasureSets.from_dirs(
        dirs, len(dirs) // sdc, sdc,
        block_size=block_size or DEFAULT_BLOCK_SIZE, device=device)
    try:
        layer.start_drive_monitor()
        host, _, port = address.rpartition(":")
        srv = S3Server(layer, access_key=access_key, secret_key=secret_key,
                       region=region, host=host or "0.0.0.0",
                       port=int(port), config=Config())
    except BaseException:
        layer.close()
        raise
    srv.healer = BackgroundHealer(
        layer, interval_s=float(os.environ.get("MT_HEAL_INTERVAL_S", "3600")),
        deep_every=int(os.environ.get("MT_HEAL_DEEP_EVERY", "8")))
    srv.reload_pipeline_config()
    srv.reload_commit_config()
    srv.reload_background_config()
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
    args = parser.parse_args(argv)
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
        print("S3 endpoint: http://"
              f"{args.address.rpartition(':')[0] or '0.0.0.0'}:{srv.port}",
              flush=True)
        srv.healer.start()
        srv.serve_forever()         # until ^C or admin service?action=stop
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

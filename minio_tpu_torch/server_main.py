"""Server bootstrap and CLI (``minio_tpu/server_main.py``,
cmd/server-main.go:389 serverMain).

``python -m minio_tpu_torch server /data1 ... /dataN`` serves S3 over one
erasure set of all N drives, its erasure coding and bitrot hashing on the
card (``--device cuda``, the default, which raises without one) or, when
asked, on the CPU through the kernels' plain versions (``--device
cpu``).  A drive count that the reference splits into several erasure
sets is not served yet (ROADMAP Queue 1 item 5, ErasureSets); nor are
the reference's background crawler and healer, or its gateway and node
subcommands.
"""

from __future__ import annotations

import argparse
import os
import sys

from .objectlayer.erasure_object import DEFAULT_BLOCK_SIZE, ErasureObjects
from .s3.server import S3Server
from .storage.xl_storage import XLStorage

# set sizing (cmd/endpoint-ellipses.go:44 setSizes{4..16})
SET_SIZES = list(range(16, 3, -1))


def choose_set_drive_count(n: int) -> int:
    """The largest valid set size that divides the drive count
    (getSetIndexes, cmd/endpoint-ellipses.go:132); 1-3 drives form one
    set."""
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
                 device: str = "cuda") -> S3Server:
    """One erasure set over ``dirs`` (parity by set size) behind an
    S3Server bound to ``address``; not started."""
    access_key = access_key or os.environ.get("MT_ROOT_USER", "minioadmin")
    secret_key = secret_key or os.environ.get("MT_ROOT_PASSWORD",
                                              "minioadmin")
    sdc = choose_set_drive_count(len(dirs))
    if sdc != len(dirs):
        raise NotImplementedError(
            f"{len(dirs)} drives make {len(dirs) // sdc} erasure sets of "
            f"{sdc}; the port serves one set (ROADMAP Queue 1 item 5, "
            "ErasureSets)")
    disks = []
    for d in dirs:
        os.makedirs(d, exist_ok=True)
        disks.append(XLStorage(d))
    layer = ErasureObjects(disks, block_size=block_size or DEFAULT_BLOCK_SIZE,
                           device=device)
    host, _, port = address.rpartition(":")
    try:
        return S3Server(layer, access_key=access_key, secret_key=secret_key,
                        region=region, host=host or "0.0.0.0",
                        port=int(port))
    except BaseException:
        layer.close()
        raise


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="minio_tpu_torch",
        description="S3 object storage over one erasure set on a CUDA card")
    sub = parser.add_subparsers(dest="command", required=True)
    ps = sub.add_parser("server", help="start the object storage server")
    ps.add_argument("dirs", nargs="+", help="drive directories")
    ps.add_argument("--address", default="0.0.0.0:9000")
    ps.add_argument("--access-key", default=None,
                    help="root access key (env MT_ROOT_USER)")
    ps.add_argument("--secret-key", default=None,
                    help="root secret key (env MT_ROOT_PASSWORD)")
    ps.add_argument("--block-size", type=int, default=None)
    ps.add_argument("--region", default="us-east-1")
    ps.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    try:
        srv = build_server(args.dirs, args.address, args.access_key,
                           args.secret_key, args.block_size, args.region,
                           args.device)
    except (RuntimeError, NotImplementedError, ValueError) as e:
        print(f"minio_tpu_torch: {e}", file=sys.stderr)
        return 1
    er = srv.layer
    print(f"minio_tpu_torch server: {len(args.dirs)} drives, one set of "
          f"{er.data_blocks} data + {er.parity} parity, block "
          f"{er.block_size} B, device {er.device}", flush=True)
    print(f"S3 endpoint: http://{args.address.rpartition(':')[0] or '0.0.0.0'}"
          f":{srv.port}", flush=True)
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

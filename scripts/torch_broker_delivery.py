"""Seconds of one delivery through each of the port's broker targets.

    python3 scripts/torch_broker_delivery.py [--records 20]

For each kind, ``--records`` deliveries of one event record through the
target's ``_deliver`` (a connection, the protocol's exchange, the close)
against the frame-parsing stub ``chip_smoke.py`` phase 19 uses, in this
process: once with the wire clients' sockets as the port opens them
(Nagle's algorithm off, ``events/wire.py connect``) and once with it left
on, as ``minio_tpu``'s clients leave it (ROADMAP Queue 3 record 58).
Prints one JSON line: per kind and setting the median, smallest and
largest milliseconds.  A host measurement: it says nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402
from minio_tpu_torch.events import brokers, sqlwire, wire  # noqa: E402
from minio_tpu_torch.utils.kvconfig import Config  # noqa: E402

RECORD = {"eventVersion": "2.0", "eventSource": "minio:s3",
          "eventName": "ObjectCreated:Put",
          "eventTime": "2026-07-30T12:00:00.000Z",
          "s3": {"bucket": {"name": "bench"},
                 "object": {"key": "dir/obj.bin", "size": 16 << 20,
                            "eTag": "e" * 32}}}


def nagle_on(host: str, port: int, timeout: float) -> socket.socket:
    return socket.create_connection((host, port), timeout=timeout)


def times_ms(kind: str, stub_cls, records: int) -> list:
    stub = stub_cls().start()
    try:
        cfg = Config()
        for key, value in cs.broker_settings(kind, stub.port, "").items():
            cfg.set(f"notify_{kind}", key, value)
        t = brokers.target_from_config(kind, cfg)
        out = []
        for _ in range(records):
            t0 = time.perf_counter()
            t._deliver(RECORD)
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    finally:
        stub.stop()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=20)
    args = ap.parse_args()
    stubs = cs.broker_stubs()
    result: dict = {}
    for setting, connect in (("nagle_off", wire.connect),
                             ("nagle_on", nagle_on)):
        for mod in (wire, sqlwire):
            mod.connect = connect
        for kind in cs.BR_KINDS:
            ms = sorted(times_ms(kind, stubs[kind], args.records))
            result.setdefault(kind, {})[setting] = {
                "median_ms": ms[len(ms) // 2], "min_ms": ms[0],
                "max_ms": ms[-1]}
    print(json.dumps({"records": args.records, "per_kind": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

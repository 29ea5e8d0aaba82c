"""``chip_smoke.py``'s phase 18 (bucket replication) alone, on the card.

    python3 scripts/replication_phase.py

Builds the kernels, then the 32-drive server of ``chip_smoke.py``'s
phases 9 and 14 (two sets of 12 + 4, 10 MiB blocks) on the card as the
replication source, and runs ``chip_smoke.phase_replication`` on it
once (it builds and stops its own 16-drive destination).  Prints the
card's name and power limit, the phase's line, and one JSON line of the
launches and readings.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    from minio_tpu_torch.server_main import build_server
    os.environ["MT_CRAWL_INTERVAL_S"] = str(24 * 3600)
    card = card_name_and_power_limit()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261018)
    root = tempfile.mkdtemp(prefix="repl-phase-")
    srv = build_server([f"{root}/d{i}" for i in range(2 * (cs.K + cs.M))],
                       "127.0.0.1:0", cs.S3_KEY, cs.S3_SECRET, cs.BLOCK,
                       device="cuda")
    srv.start()
    try:
        launches, readings = cs.phase_replication(srv, card, gen)
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"card": card, "launches": launches,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 9 of ``chip_smoke.py`` (and phase 10 on its server) with the
``minio_tpu_torch`` package of a given tree, so that a parent and a
change can be timed on one card in one call.

    git archive <parent> minio_tpu_torch | tar -x -C .chip/parent
    for t in .chip/parent . . .chip/parent; do
        python3 scripts/sets_phase_bench.py --tree $t; done

The workload is this checkout's ``chip_smoke.py``: phase 9's 32-drive
server (2 sets x 16, 12 + 4, 10 MiB blocks), its bodies and steps, and
phase 10 on that server; only ``minio_tpu_torch`` comes from the tree.
Phase 12 is not run.  Needs a card; prints one JSON line of phase 9's
readings (GiB/s, objects/s, seconds per step) and phase 10's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE,
                    help="directory holding the minio_tpu_torch to run")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, HERE]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import minio_tpu_torch
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    if os.path.dirname(os.path.dirname(minio_tpu_torch.__file__)) != tree:
        raise RuntimeError(f"imported {minio_tpu_torch.__file__}, not the "
                           f"package of {tree}")
    os.environ["MT_CRAWL_INTERVAL_S"] = str(24 * 3600)
    cs.phase_listing = lambda *a: ({k: 0 for k in cs.KERNELS}, {})
    card = card_name_and_power_limit()
    _build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    bodies = cs.make_bodies(gen)
    single = dict.fromkeys(("put_256MiB_gib_s", "get_256MiB_gib_s",
                            "degraded_get_s", "burst_objects_per_s"), 0.0)
    _, readings, (_, control, _) = cs.phase_sets(bodies, card, gen, single)
    keep = ("put_16MiB_gib_s", "put_256MiB_gib_s", "get_gib_s",
            "get_256MiB_gib_s", "degraded_get_s", "heal_sweep_s",
            "burst_objects_per_s", "phase_s", "step_s")
    print(json.dumps({"tree": args.tree, "card": card,
                      **{k: readings[k] for k in keep},
                      "control": {k: control[k] for k in
                                  ("scrape_ms", "sweep_s", "phase_s")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time one tree's minio_tpu_torch erasure set on a CUDA card.

    python3 scripts/torch_path_bench.py --tree DIR [--repeat N] [--clear-pool]

Imports ``minio_tpu_torch`` from DIR (a checkout, or an unpacked
``git archive`` of another commit) and the workload from this checkout's
``chip_smoke.py`` (its set, wipe and burst), builds the tree's kernels,
and on a fresh set under a temporary directory times: the PUT of one
seeded 256 MiB object, its degraded GET with the drives of four data
shards wiped, the same GET again with its stages timed (drive reads;
stacking and the host-to-device copy; verify, Kernel B; rebuild and the
copy back, Kernel A; the rest: quorum metadata and joining the body),
the heal of those four shards, and the burst of 8 threads each PUTting
32 objects of 512 KiB (then every body is read back).  ``--clear-pool``
empties the tree's pinned framed-buffer pool and the CUDA host cache
after the PUT, before the GETs.  Prints the card's name and power limit
and one JSON line of seconds (with any ``MALLOC_*`` glibc tunables the
process was started with).  Run two trees in separate processes on
one card, in the order parent, change, change, parent, to compare them.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This checkout's chip_smoke.py, without putting the checkout on
    sys.path (``minio_tpu_torch`` must come from the tree under test)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_stages(er, eo, bitrot, torch, name: str) -> dict:
    """One GET of ``name`` with its stages timed (each synchronised with
    the card at its end); seconds per stage."""
    t = {"read": 0.0, "verify": 0.0, "read_verify": 0.0, "assemble": 0.0}
    reading = []                 # set while the shard reads run

    def timed(key, fn):
        def run(*a, **kw):
            if key == "read" and not reading:
                return fn(*a, **kw)          # a metadata fan-out
            reading.append(key == "read_verify")
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                t[key] += time.perf_counter() - t0
                reading.pop()
        return run

    fanout, read_verified = er._fanout, er._read_verified
    assemble, verify = eo._assemble, bitrot.verify_frames
    er._fanout = timed("read", fanout)
    er._read_verified = timed("read_verify", read_verified)
    eo._assemble = timed("assemble", assemble)
    bitrot.verify_frames = timed("verify", verify)
    try:
        t0 = time.perf_counter()
        er.get_object("smoke", name)
        total = time.perf_counter() - t0
    finally:
        er._fanout, er._read_verified = fanout, read_verified
        eo._assemble, bitrot.verify_frames = assemble, verify
    return {"total_s": total, "reads_s": t["read"],
            "stack_h2d_s": t["read_verify"] - t["read"] - t["verify"],
            "verify_s": t["verify"], "rebuild_d2h_s": t["assemble"],
            "rest_s": total - t["read_verify"] - t["assemble"]}


def clear_pool(torch) -> None:
    from minio_tpu_torch.utils import bufpool
    bufpool.GLOBAL = bufpool.BufPool()
    import gc
    gc.collect()
    # the host allocator's cached pinned blocks go back (where torch has it)
    getattr(torch._C, "_host_emptyCache", lambda: None)()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--clear-pool", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    import minio_tpu_torch
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.hashing import bitrot
    from minio_tpu_torch.objectlayer import erasure_object as eo
    from minio_tpu_torch.ops import _build
    assert minio_tpu_torch.__file__.startswith(tree), minio_tpu_torch.__file__
    card = card_name_and_power_limit()
    _build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261017)
    big = smoke.rand_bytes((256 << 20,), gen).cpu().numpy().tobytes()
    digest = hashlib.sha256(big).digest()
    bodies = smoke.burst_bodies()
    runs = []
    for _ in range(args.repeat):
        root = tempfile.mkdtemp(prefix="path-bench-")
        try:
            er = smoke.new_set(root)
            t0 = time.perf_counter()
            er.put_object("smoke", "big", big)
            torch.cuda.synchronize()
            put_s = time.perf_counter() - t0
            smoke.wipe(root, "big", smoke.victims_of(er, "big"))
            if args.clear_pool:
                clear_pool(torch)
            t0 = time.perf_counter()
            _, got = er.get_object("smoke", "big")
            get_s = time.perf_counter() - t0
            smoke.check(hashlib.sha256(got).digest() == digest,
                        "degraded GET")
            del got
            stages = get_stages(er, eo, bitrot, torch, "big")
            t0 = time.perf_counter()
            er.heal_object("smoke", "big")
            torch.cuda.synchronize()
            heal_s = time.perf_counter() - t0
            burst_s = smoke.put_burst(er, bodies)
            smoke.read_back(er, bodies)
            er.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        runs.append({"put_256MiB_s": put_s, "degraded_get_256MiB_s": get_s,
                     "degraded_get_stages": stages,
                     "heal_4_shards_s": heal_s, "burst_s": burst_s,
                     "burst_objects_per_s": len(bodies) / burst_s})
    print(card)
    malloc_env = {k: v for k, v in os.environ.items()
                  if k.startswith("MALLOC_")}
    print(json.dumps({"tree": tree, "clear_pool": args.clear_pool,
                      "malloc_env": malloc_env, "card": card,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

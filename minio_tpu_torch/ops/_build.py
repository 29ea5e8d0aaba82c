"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled on first use with nvcc into its own shared
library under ``minio_tpu_torch/build/`` and loaded with ctypes: a plain
C interface, pointers and the stream passed as ``c_void_p``.  The library
name carries a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel is never served from a stale build.  A
failed build raises; nothing falls back.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("gf8_apply", "hh256", "rs_fused")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclass
class Counts:
    """Launches of one kernel and calls of its plain version; a run
    reads them to show which engine its path went through."""
    launches: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):      # shared device code
        tag.update(header.read_bytes())
    return src, BUILD / f"lib{name}-{tag.hexdigest()[:12]}.so"


def build(names=SOURCES) -> None:
    """Compile the named sources that have no current library, one nvcc
    process per source, all started together.  Raises on any failure."""
    with _lock:
        _build_locked(names)


def _build_locked(names) -> None:
    todo = [(n, *_target(n)) for n in names]
    todo = [t for t in todo if not t[2].exists()]
    if not todo:
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, src, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

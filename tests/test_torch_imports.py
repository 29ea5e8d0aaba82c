"""The port stands alone: it imports neither jax nor anything of minio_tpu,
and its entry points never fall back to the CPU when no card is there."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "minio_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, importlib, minio_tpu_torch\n"
        "for m in pkgutil.walk_packages(minio_tpu_torch.__path__, "
        "'minio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'minio_tpu' "
        "or n.startswith('minio_tpu.'))\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('minio_tpu_torch.')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_reference_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "minio_tpu"), \
                f"{path.name} imports {name}"


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops.codec import Erasure
    from minio_tpu_torch.storage.xl_storage import XLStorage
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    disks = []
    for i in range(4):
        (tmp_path / f"d{i}").mkdir()
        disks.append(XLStorage(str(tmp_path / f"d{i}")))
    with pytest.raises(RuntimeError, match="is_available"):
        ErasureObjects(disks)
    with pytest.raises(RuntimeError, match="is_available"):
        Erasure(2, 2, 4096)

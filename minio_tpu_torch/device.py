"""Device resolution and card identity.

Every entry point of the port takes an explicit ``device``; the default is
``"cuda"``, and asking for a card that is not there raises instead of
running on the CPU.  Tests pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import subprocess
import warnings

import numpy as np
import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``device``; raises RuntimeError for a CUDA
    device when torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(data, device: torch.device) -> torch.Tensor:
    """Bytes-like or tensor -> flat uint8 tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).to(device)
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    with warnings.catch_warnings():
        # read-only source: torch warns, but nothing writes through it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(buf).to(device)


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it
    (the line every timing is written beside)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

"""The device every entry point runs on.

`resolve("cuda")` raises when no card is present: the port never carries
on on the CPU by itself. Only an explicit `cpu` runs the kernels' plain
PyTorch versions (the CPU tests do that).
"""

from __future__ import annotations

import subprocess

import torch

from .errors import DeviceError


def resolve(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError("device", "device 'cuda' requested but no "
                                        "CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceError("device", f"unsupported device {str(device)!r} "
                                    "(expected 'cuda' or 'cpu')")
    return dev


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    'unknown' when nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def free_bytes(dev: torch.device) -> int:
    """Free device memory now; on the CPU a fixed small budget, so the
    plain versions run in small batches (the JAX package's CPU default)."""
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[0])
    return 64 << 20

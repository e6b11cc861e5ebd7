"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device(name)``, refusing a CUDA device that is not there: the
    port never falls back to the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs its kernels on the card; pass "
            "--device cpu (device='cpu') to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {name!r}")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a host
    clock read after it measures the work, not its enqueue."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

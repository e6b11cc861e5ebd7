"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import os

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


def check_fits(what: str, need_bytes: int, dev: torch.device) -> None:
    """Raises a plain MemoryError, before anything is allocated, when
    ``need_bytes`` (a lower bound of what the run holds) exceeds the memory
    of ``dev``: the card's, or the host's physical memory for the CPU. The
    registered full-size kimi-k2 (1 T parameters) fits no card, and its run
    should say so rather than fail part way with an out-of-memory error."""
    have = (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
            else os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    if need_bytes > have:
        raise MemoryError(f"{what} needs at least {need_bytes / 2**30:.1f} GiB, more than the "
                          f"{have / 2**30:.1f} GiB of {dev}: run the reduced config (no --full), "
                          f"or cut the depth or the experts with dataclasses.replace")

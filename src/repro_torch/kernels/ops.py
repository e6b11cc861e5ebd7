"""Dispatch between the CUDA kernels and their plain versions.

The model layer calls these five functions. A CUDA tensor runs the
hand-written kernel, which raises if it cannot build or launch; a CPU
tensor runs the plain torch version. There is no fallback from one to the
other. :func:`plain_versions` forces the plain versions for tensors on the
card too: it exists only to hold the kernels against them on the same
inputs (``chip_smoke.py``); no entry point uses it.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

from repro_torch.kernels import decode_attention, flash_attention as fa, rglru as lru
from repro_torch.kernels import rmsnorm as rn, rwkv6

_FORCE_PLAIN = contextvars.ContextVar("repro_torch_force_plain", default=False)


@contextlib.contextmanager
def plain_versions():
    """Run the plain torch versions even for CUDA tensors (reference runs)."""
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)


def _use_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return not _FORCE_PLAIN.get()
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, not {t.device}")


def rmsnorm(x, scale, eps: float = 1e-6):
    if _use_kernel(x):
        return rn.rmsnorm(x, scale, eps)
    return rn.rmsnorm_ref(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if _use_kernel(q):
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return fa.flash_attention_ref(q, k, v, causal=causal, window=window)


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0):
    if _use_kernel(q):
        return decode_attention.flash_decode(q, k, v, kpos, pos, window=window)
    return decode_attention.flash_decode_ref(q, k, v, kpos, pos, window=window)


def wkv6(r, k, v, wlog, u, state):
    if _use_kernel(r):
        return rwkv6.wkv6(r, k, v, wlog, u, state)
    return rwkv6.wkv6_ref(r, k, v, wlog, u, state)


def rglru(log_a, m, h0):
    if _use_kernel(log_a):
        return lru.rglru(log_a, m, h0)
    return lru.rglru_ref(log_a, m, h0)


_MODULES = {"rmsnorm": rn, "flash_attention": fa, "flash_decode": decode_attention,
            "wkv6": rwkv6, "rglru": lru}


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0

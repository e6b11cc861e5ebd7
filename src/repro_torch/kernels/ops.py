"""Dispatch between the CUDA kernels and their plain versions.

The model layer calls these five functions. A CUDA tensor runs the
hand-written kernel, which raises if it cannot build or launch; a CPU
tensor runs the plain torch version. There is no fallback from one to the
other. :func:`plain_versions` forces the plain versions for tensors on the
card too: it exists only to hold the kernels against them on the same
inputs (``chip_smoke.py``); no entry point uses it.

Under autograd (grad mode on and an input that requires grad),
``rmsnorm`` and ``flash_attention`` run as autograd Functions whose
forward is the forward kernel and whose backward is the hand-written
backward kernel (the plain versions of both on the CPU). ``flash_decode``,
``wkv6`` and ``rglru`` have no backward kernel yet: on their kernel path
they raise rather than hand back an output with no gradient (training
rwkv6 and recurrentgemma is ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

from repro_torch.kernels import decode_attention, flash_attention as fa, rglru as lru
from repro_torch.kernels import rmsnorm as rn, rwkv6

_FORCE_PLAIN = contextvars.ContextVar("repro_torch_force_plain", default=False)

NO_BACKWARD = ("has no backward kernel yet: training rwkv6 and recurrentgemma needs the wkv6 "
               "and rglru_scan backward kernels (ROADMAP.md Queue 1, item 9)")


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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_grad(name: str, *ts) -> None:
    if _needs_grad(*ts):
        raise NotImplementedError(f"{name} {NO_BACKWARD}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, kernel):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.kernel = eps, kernel
        return rn.rmsnorm(x, scale, eps) if kernel else rn.rmsnorm_ref(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        bwd = rn.rmsnorm_bwd if ctx.kernel else rn.rmsnorm_bwd_ref
        dx, dscale = bwd(x, scale, dy.to(x.dtype), ctx.eps)
        return dx, dscale, None, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, kernel):
        fwd = fa.flash_attention if kernel else fa.flash_attention_ref
        out, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.kernel = causal, window, kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = fa.flash_attention_bwd if ctx.kernel else fa.flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, dout.to(q.dtype), lse, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None, None


def rmsnorm(x, scale, eps: float = 1e-6):
    kernel = _use_kernel(x)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps, kernel)
    if kernel:
        return rn.rmsnorm(x, scale, eps)
    return rn.rmsnorm_ref(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    kernel = _use_kernel(q)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, kernel)
    if kernel:
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return fa.flash_attention_ref(q, k, v, causal=causal, window=window)


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0):
    if _use_kernel(q):
        _refuse_grad("flash_decode", q, k, v)
        return decode_attention.flash_decode(q, k, v, kpos, pos, window=window)
    return decode_attention.flash_decode_ref(q, k, v, kpos, pos, window=window)


def wkv6(r, k, v, wlog, u, state):
    if _use_kernel(r):
        _refuse_grad("wkv6", r, k, v, wlog, u, state)
        return rwkv6.wkv6(r, k, v, wlog, u, state)
    return rwkv6.wkv6_ref(r, k, v, wlog, u, state)


def rglru(log_a, m, h0):
    if _use_kernel(log_a):
        _refuse_grad("rglru", log_a, m, h0)
        return lru.rglru(log_a, m, h0)
    return lru.rglru_ref(log_a, m, h0)


# counter name -> (module, attribute)
_COUNTERS = {"rmsnorm": (rn, "launches"), "flash_attention": (fa, "launches"),
             "flash_decode": (decode_attention, "launches"), "wkv6": (rwkv6, "launches"),
             "rglru": (lru, "launches"), "rmsnorm_bwd": (rn, "bwd_launches"),
             "flash_attention_bwd": (fa, "bwd_launches")}


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)

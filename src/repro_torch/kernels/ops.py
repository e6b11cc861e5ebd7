"""Dispatch between the CUDA kernels and their plain versions.

The model layer calls these five functions. A CUDA tensor runs the
hand-written kernel, which raises if it cannot build or launch; a CPU
tensor runs the plain torch version. There is no fallback from one to the
other. :func:`plain_versions` forces the plain versions for tensors on the
card too: it exists only to hold the kernels against them on the same
inputs (``chip_smoke.py``); no entry point uses it. It holds for the whole
process, so that the backward, which autograd runs on a thread of its
own for CUDA tensors (recomputing the checkpointed blocks there), takes
the plain versions as well.

Under autograd (grad mode on and an input that requires grad),
``rmsnorm``, ``flash_attention``, ``wkv6`` and ``rglru`` run as autograd
Functions whose forward is the forward kernel and whose backward is the
hand-written backward kernel (the plain versions of both on the CPU).
``flash_decode`` has no backward kernel: it runs only in decode steps,
which are never trained, and on its kernel path it raises rather than
hand back an output with no gradient (ROADMAP Queue 1, item 9).

A fake tensor (the dry run's, ``launch/dryrun.py``) takes the kernels'
shape-only path (:mod:`repro_torch.kernels.fake`) before the device test:
a fake ``cuda`` tensor has no storage for a kernel to read, and the plain
version would hold what the kernel never holds. That path returns empty
outputs of the kernel's shapes and counts its FLOPs and bytes.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import decode_attention, fake, flash_attention as fa, rglru as lru
from repro_torch.kernels import rmsnorm as rn, rwkv6

#: open ``plain_versions`` blocks (process-wide: autograd's threads see it)
_force_plain = 0

NO_BACKWARD = ("has no backward kernel: it runs only in decode steps, which are never trained "
               "(ROADMAP.md Queue 1, item 9)")


@contextlib.contextmanager
def plain_versions():
    """Run the plain torch versions even for CUDA tensors (reference runs)."""
    global _force_plain
    _force_plain += 1
    try:
        yield
    finally:
        _force_plain -= 1


def _use_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return not _force_plain
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, not {t.device}")


def _impl(t: torch.Tensor) -> str:
    """"fake" for a fake tensor, else "kernel" or "plain" (``_use_kernel``)."""
    if isinstance(t, FakeTensor):
        return "fake"
    return "kernel" if _use_kernel(t) else "plain"


# entry point -> {impl: function}: forward and backward
_FWD = {"rmsnorm": {"kernel": rn.rmsnorm, "plain": rn.rmsnorm_ref, "fake": fake.rmsnorm},
        "flash_attention": {"kernel": fa.flash_attention, "plain": fa.flash_attention_ref,
                            "fake": fake.flash_attention},
        "flash_decode": {"kernel": decode_attention.flash_decode,
                         "plain": decode_attention.flash_decode_ref, "fake": fake.flash_decode},
        "wkv6": {"kernel": rwkv6.wkv6, "plain": rwkv6.wkv6_ref, "fake": fake.wkv6},
        "rglru": {"kernel": lru.rglru, "plain": lru.rglru_ref, "fake": fake.rglru}}
_BWD = {"rmsnorm": {"kernel": rn.rmsnorm_bwd, "plain": rn.rmsnorm_bwd_ref,
                    "fake": fake.rmsnorm_bwd},
        "flash_attention": {"kernel": fa.flash_attention_bwd, "plain": fa.flash_attention_bwd_ref,
                            "fake": fake.flash_attention_bwd},
        "wkv6": {"kernel": rwkv6.wkv6_bwd, "plain": rwkv6.wkv6_bwd_ref, "fake": fake.wkv6_bwd},
        "rglru": {"kernel": lru.rglru_bwd, "plain": lru.rglru_bwd_ref, "fake": fake.rglru_bwd}}


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_grad(name: str, *ts) -> None:
    if _needs_grad(*ts):
        raise NotImplementedError(f"{name} {NO_BACKWARD}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, impl):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.impl = eps, impl
        return _FWD["rmsnorm"][impl](x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _BWD["rmsnorm"][ctx.impl](x, scale, dy.to(x.dtype), ctx.eps)
        return dx, dscale, None, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, impl):
        out, lse = _FWD["flash_attention"][impl](q, k, v, causal=causal, window=window,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _BWD["flash_attention"][ctx.impl](q, k, v, out, dout.to(q.dtype), lse,
                                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, wlog, u, state, impl):
        ctx.save_for_backward(r, k, v, wlog, u, state)
        ctx.impl = impl
        return _FWD["wkv6"][impl](r, k, v, wlog, u, state)

    @staticmethod
    def backward(ctx, dy, dstate_T):  # dstate_T: zeros where the final state is dropped
        r, k, v, wlog, u, state = ctx.saved_tensors
        grads = _BWD["wkv6"][ctx.impl](r, k, v, wlog, u, state, dy.to(r.dtype), dstate_T)
        return (*grads, None)


class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, m, h0, impl):
        h_seq, h_final = _FWD["rglru"][impl](log_a, m, h0)
        ctx.save_for_backward(log_a, h0, h_seq)
        ctx.impl = impl
        return h_seq, h_final

    @staticmethod
    def backward(ctx, dh_seq, dh_final):  # dh_final: zeros where the final h is dropped
        log_a, h0, h_seq = ctx.saved_tensors
        f32 = torch.float32
        dlog_a, dm, dh0 = _BWD["rglru"][ctx.impl](
            log_a.contiguous(), h_seq, h0.to(f32).contiguous(), dh_seq.to(f32).contiguous(),
            dh_final.to(f32).contiguous())
        return dlog_a, dm, dh0.to(h0.dtype), None


def rmsnorm(x, scale, eps: float = 1e-6):
    impl = _impl(x)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps, impl)
    return _FWD["rmsnorm"][impl](x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k / v: (B, K, Sk, hd), Sk != S only when not
    causal and not windowed (a cross-attention; its backward gives dK and
    dV of Sk rows)."""
    impl = _impl(q)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, impl)
    return _FWD["flash_attention"][impl](q, k, v, causal=causal, window=window)


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0):
    impl = _impl(q)
    if impl == "kernel":
        _refuse_grad("flash_decode", q, k, v)
    return _FWD["flash_decode"][impl](q, k, v, kpos, pos, window=window)


def wkv6(r, k, v, wlog, u, state):
    impl = _impl(r)
    if _needs_grad(r, k, v, wlog, u, state):
        return _WKV6.apply(r, k, v, wlog, u, state, impl)
    return _FWD["wkv6"][impl](r, k, v, wlog, u, state)


def rglru(log_a, m, h0):
    impl = _impl(log_a)
    if _needs_grad(log_a, m, h0):
        return _RGLRU.apply(log_a, m, h0, impl)
    return _FWD["rglru"][impl](log_a, m, h0)


# counter name -> (module, attribute)
_COUNTERS = {"rmsnorm": (rn, "launches"), "flash_attention": (fa, "launches"),
             "flash_decode": (decode_attention, "launches"), "wkv6": (rwkv6, "launches"),
             "rglru": (lru, "launches"), "rmsnorm_bwd": (rn, "bwd_launches"),
             "flash_attention_bwd": (fa, "bwd_launches"), "wkv6_bwd": (rwkv6, "bwd_launches"),
             "rglru_bwd": (lru, "bwd_launches")}


# the float32 routes' share of two of those counts
_F32_COUNTERS = {"flash_attention": (fa, "f32_launches"),
                 "flash_attention_bwd": (fa, "f32_bwd_launches")}


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def f32_launch_counts() -> Dict[str, int]:
    """Launches of the flash-attention kernels' float32 routes since the last
    reset (a part of :func:`launch_counts`' counts)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _F32_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_COUNTERS.values(), *_F32_COUNTERS.values()):
        setattr(mod, attr, 0)

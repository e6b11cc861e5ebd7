"""Fused RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` (forward and
backward) and their plain versions.

The forward replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas
kernel). Memory-bound on the H100: one read and one write of the rows; the
kernel gives each row one warp, which holds the row in registers between
the float32 mean square and the scaled write, and moves 16 bytes per load
and store (see the note in the source).

The backward has no Pallas counterpart (the reference takes ``jax.grad``
of its jnp norm): ``rmsnorm_bwd`` gives dx and dscale, dscale summed over
the rows in a fixed order (per-block partials, then a second pass), so it
is bit-identical from run to run. ``ops.rmsnorm`` binds the two in an
autograd Function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernels since the last reset (see ``ops.launch_counts``)
launches = 0
bwd_launches = 0

#: most blocks of the backward; each writes one float32 partial row of dscale
BWD_MAX_BLOCKS = 512
BWD_MAX_D = 16384

_fn = None  # the ctypes entry point, resolved at the first launch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """CUDA kernel. x: (..., d) float32/bfloat16 on the card; scale: (d,)
    float32. Returns x's shape and dtype."""
    global launches, _fn
    if not x.is_cuda:
        raise ValueError("rmsnorm: the CUDA kernel takes a CUDA tensor")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale must be float32 ({d},) on {x.device}")
    scale = scale.contiguous()
    code = _build.dtype_code(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    vectorized = int(d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    if _fn is None:
        _fn = _build.lib().rt_rmsnorm
    err = _fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps, code,
              vectorized, _build.stream_arg(x.device))
    _build.check(err, "rmsnorm")
    launches += 1
    return out


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the same function in torch ops."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def bwd_blocks(rows: int):
    """(blocks, rows a block) of the backward for ``rows`` rows: at most
    BWD_MAX_BLOCKS blocks of consecutive rows, every row covered."""
    per = -(-rows // min(rows, BWD_MAX_BLOCKS))
    return -(-rows // per), per


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """CUDA kernel. x, dy: (..., d) float32/bfloat16 on the card, one dtype;
    scale: (d,) float32. Returns (dx in x's dtype and shape, dscale (d,)
    float32)."""
    global bwd_launches
    if not (x.is_cuda and dy.device == x.device):
        raise ValueError("rmsnorm_bwd: the CUDA kernel takes CUDA tensors on one device")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"rmsnorm_bwd: scale must be float32 ({d},) on {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {dy.dtype} {tuple(dy.shape)} is not x's "
                         f"{x.dtype} {tuple(x.shape)}")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: width {d} > {BWD_MAX_D}")
    code = _build.dtype_code(x)
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    rows = x.numel() // d
    blocks, per = bwd_blocks(rows)
    dx = torch.empty_like(x)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    err = _build.lib().rt_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                      part.data_ptr(), dscale.data_ptr(), rows, d, blocks, per,
                                      eps, code, _build.stream_arg(x.device))
    _build.check(err, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """Plain version of the backward: the kernel's formulas in torch ops,
    r = rsqrt(mean(x^2) + eps), g = dy * scale,
    dx = r * g - x * r^3 * mean(g * x), dscale = sum over rows of dy * x * r."""
    d = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, d)
    gf = dy.to(torch.float32).reshape(-1, d)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.to(torch.float32)
    dx = r * gs - xf * (r * r * r) * torch.mean(gs * xf, dim=-1, keepdim=True)
    dscale = torch.sum(gf * xf * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale

"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas kernel).
Memory-bound on the H100: one read and one write of the rows; the kernel
gives each row one warp, which holds the row in registers between the
float32 mean square and the scaled write, and moves 16 bytes per load and
store (see the note in the source).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel since the last reset (see ``ops.launch_counts``)
launches = 0

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

"""Prefill flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (the
Pallas kernel); the plain version is ``repro/kernels/ref.py::attention_ref``
in torch. Causal / sliding-window GQA attention over positions 0..S-1,
forward only, with a float32 running max, sum and accumulator. bfloat16
runs on the tensor cores (wgmma), with the probabilities rounded to
bfloat16 for P·V as SDPA does; float32 runs on FMA and keeps them in
float32. The kernel reads q, k and v through their strides (the head_dim
axis must be contiguous), so callers may pass transposed views.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30

#: launches of the CUDA kernel since the last reset (see ``ops.launch_counts``)
launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)


def _check(q, k, v):
    B, H, S, hd = q.shape
    K = k.shape[1]
    if k.shape != (B, K, S, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,H,S,hd)/(B,K,S,hd) with H % K == 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v must share a dtype")
    return B, H, K, S, hd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """CUDA kernel. q: (B, H, S, hd); k/v: (B, K, S, hd). Returns (B, H, S, hd)
    in q's dtype, as a view of a (B, S, H, hd) buffer: the model's next
    step, the output projection, reads that layout without a copy."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, hd = _check(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis must have stride 1")
        # the bfloat16 kernel copies 16-byte chunks of each row
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"flash_attention: bfloat16 {name} needs a 16-byte aligned base "
                             f"and batch/head/sequence strides that are multiples of 8, got "
                             f"strides {t.stride()}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = _build.strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *out.stride()[:3])
    err = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, K, S, hd, strides,
        int(bool(causal)), int(window), 1.0 / math.sqrt(hd), _build.dtype_code(q),
        _build.stream_arg(q.device),
    )
    _build.check(err, "flash_attention")
    launches += 1
    return out


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version: naive full-matrix attention (``ref.attention_ref``)."""
    B, H, K, S, hd = _check(q, k, v)
    g = H // K
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) / math.sqrt(hd)
    qpos = torch.arange(S, dtype=torch.int32, device=q.device)[:, None]
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)

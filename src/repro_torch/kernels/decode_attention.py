"""Flash decode: the CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.

Replaces ``src/repro/kernels/decode_attention.py::flash_decode`` (the
Pallas kernel); the plain version is its ``flash_decode_ref`` in torch. One
query token per row against a ring-buffer KV cache; a slot is valid iff
``kpos >= 0 & kpos <= pos`` (and ``kpos > pos - window`` when windowed).
The kernel reads k/v through their strides, so the model passes its
``(B, W, n, hd)`` cache as a ``(B, n, W, hd)`` view and nothing is copied.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30

#: launches of the CUDA kernel since the last reset (see ``ops.launch_counts``)
launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16  # query heads per KV head the kernel holds in registers


def _check(q, k, v, kpos):
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    if k.shape != (B, K, S, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,H,hd)/(B,K,S,hd) with H % K == 0")
    if kpos.shape != (B, S) or kpos.dtype != torch.int32:
        raise ValueError(f"flash_decode: kpos must be int32 {(B, S)}, got "
                         f"{kpos.dtype} {tuple(kpos.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_decode: q, k and v must share a dtype")
    return B, H, K, S, hd


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0) -> torch.Tensor:
    """CUDA kernel. q: (B, H, hd); k/v: (B, K, S, hd) (any strides with a
    contiguous head_dim); kpos: (B, S) int32 (-1 = empty); pos: the decode
    position, a Python int. Returns (B, H, hd) in q's dtype."""
    global launches
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, kpos))):
        raise ValueError("flash_decode: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, hd = _check(q, k, v, kpos)
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS} or "
                         f"{H // K} query heads per KV head > {MAX_GROUP}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_decode: {name}'s head_dim axis must have stride 1")
    lib = _build.lib()
    n_split = lib.rt_flash_decode_splits(S)
    g = H // K
    part_acc = torch.empty((B * K * n_split * g * hd,), dtype=torch.float32, device=dev)
    part_m = torch.empty((B * K * n_split * g,), dtype=torch.float32, device=dev)
    part_l = torch.empty((B * K * n_split * g,), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    strides = _build.strides_arg(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
                                 *kpos.stride(), *out.stride()[:2])
    err = lib.rt_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), B, H, K, S, hd, strides,
        int(pos), int(window), 1.0 / math.sqrt(hd), _build.dtype_code(q),
        _build.stream_arg(dev),
    )
    _build.check(err, "flash_decode")
    launches += 1
    return out


def flash_decode_ref(q, k, v, kpos, pos: int, *, window: int = 0) -> torch.Tensor:
    """Plain version: masked full softmax over the cache."""
    B, H, K, S, hd = _check(q, k, v, kpos)
    g = H // K
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)  # (B,H,S,hd)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhd,bhsd->bhs", q.to(torch.float32), kk) / math.sqrt(hd)
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    s = torch.where(valid[:, None, :], s,
                    torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vv).to(q.dtype)

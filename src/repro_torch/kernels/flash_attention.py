"""Prefill flash attention: the CUDA kernels ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (backward) and their plain
versions.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (the
Pallas kernel); the plain version is ``repro/kernels/ref.py::attention_ref``
in torch. Causal / sliding-window GQA attention over positions 0..S-1,
forward only, with a float32 running max, sum and accumulator. bfloat16
runs on the tensor cores (wgmma), with the probabilities rounded to
bfloat16 for P·V as SDPA does; float32 runs on FMA and keeps them in
float32. The kernel reads q, k and v through their strides (the head_dim
axis must be contiguous), so callers may pass transposed views. Asked for
it, the forward also writes each row's log-sum-exp (``lse``, float32
``(B, H, S)``), the backward's input.

The backward (``flash_attention_bwd``) has no Pallas counterpart: the
reference trains by ``jax.grad`` of its jnp attention. It gives dQ, dK and
dV, bit-identical from run to run (no atomics; every sum in a fixed
order). bfloat16 runs on the tensor cores: a dK/dV kernel per (64 keys,
query head, batch) writing float32 per-head partials to a scratch buffer
that a second pass sums over each group in head order, and a dQ kernel per
(64 query rows, head, batch); P and dS enter the products as a bf16 high
and low part. float32 runs on FMA, dK/dV summed over a group inside one
block. ``ops.flash_attention`` binds it to the forward in an autograd
Function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30

#: launches of the CUDA kernels since the last reset (see ``ops.launch_counts``)
launches = 0
bwd_launches = 0

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


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bfloat16 kernels' TMA tensor maps can read ``t`` in
    place: a 16-byte aligned base and batch, head and sequence strides that
    are multiples of 8 elements (16 bytes)."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when :func:`tma_ready`, else a fresh contiguous copy
    (a new allocation is aligned; a contiguous view of an offset base may
    not be)."""
    return t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, return_lse: bool = False):
    """CUDA kernel. q: (B, H, S, hd); k/v: (B, K, S, hd). Returns (B, H, S, hd)
    in q's dtype, as a view of a (B, S, H, hd) buffer: the model's next
    step, the output projection, reads that layout without a copy. With
    ``return_lse``, returns (out, lse (B, H, S) float32)."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, hd = _check(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis must have stride 1")
        # the bfloat16 kernel copies 16-byte chunks of each row
        if q.dtype == torch.bfloat16 and not tma_ready(t):
            raise ValueError(f"flash_attention: bfloat16 {name} needs a 16-byte aligned base "
                             f"and batch/head/sequence strides that are multiples of 8, got "
                             f"strides {t.stride()}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    strides = _build.strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *out.stride()[:3])
    err = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, K, S, hd, strides,
        int(bool(causal)), int(window), 1.0 / math.sqrt(hd), _build.dtype_code(q),
        _build.stream_arg(q.device),
    )
    _build.check(err, "flash_attention")
    launches += 1
    return out if lse is None else (out, lse)


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    """CUDA kernel. q, o, dout: (B, H, S, hd); k/v: (B, K, S, hd), one dtype;
    lse: (B, H, S) float32 from the forward. Returns (dq, dk, dv) in the
    inputs' dtype, each a view of a (B, S, heads, hd) buffer (the layout of
    the model's projections). The bfloat16 kernels read q, k, v and dout
    through TMA tensor maps: any of the four that a map cannot read in place
    (:func:`tma_ready`) is copied first, and the route does not change. o is
    read by element strides, as on the float32 route."""
    global bwd_launches
    if not all(t.is_cuda and t.device == q.device for t in (k, v, o, dout, lse)):
        raise ValueError("flash_attention_bwd: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, hd = _check(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or not (o.dtype == dout.dtype == q.dtype):
        raise ValueError(f"flash_attention_bwd: o {o.dtype} {tuple(o.shape)} and dout "
                         f"{dout.dtype} {tuple(dout.shape)} must be q's {q.dtype} "
                         f"{tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(B, H, S)}")
    q, k, v, o, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, dout))
    part = None
    if q.dtype == torch.bfloat16:
        q, k, v, dout = (tma_copy(t) for t in (q, k, v, dout))
        # the per-head float32 dV and dK partials that the second pass sums
        part = torch.empty((2, B, H, S, hd), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, S, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = _build.strides_arg(*(s for t in (q, k, v, o, dout, dq, dk, dv)
                                   for s in t.stride()[:3]))
    err = _build.lib().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), None if part is None else part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, K, S, hd, strides, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        _build.dtype_code(q), _build.stream_arg(q.device),
    )
    _build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    qpos = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    kpos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """Plain version: naive full-matrix attention (``ref.attention_ref``);
    with ``return_lse``, also each row's log-sum-exp of its masked scores."""
    B, H, K, S, hd = _check(q, k, v)
    g = H // K
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) / math.sqrt(hd)
    mask = _mask(S, causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_bwd_ref(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    """Plain version of the backward: the kernel's formulas on full score
    matrices in float32 (P = exp(s - lse) on the visible pairs, D =
    rowsum(dO * O), dS = P * (dO·Vᵀ - D)), dK and dV summed over each
    group's query heads."""
    B, H, K, S, hd = _check(q, k, v)
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf, of, gf = q.to(f32), o.to(f32), dout.to(f32)
    kk = torch.repeat_interleave(k, g, dim=1).to(f32)
    vv = torch.repeat_interleave(v, g, dim=1).to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    mask = _mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), dtype=f32,
                                                                   device=q.device))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vv)
    ds = p * (dp - torch.sum(gf * of, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(B, K, g, S, hd).sum(dim=2)
    dv = dv.reshape(B, K, g, S, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

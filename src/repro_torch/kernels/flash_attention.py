"""Prefill flash attention: the CUDA kernels ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (backward) and their plain
versions.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` (the
Pallas kernel); the plain version is ``repro/kernels/ref.py::attention_ref``
in torch. Causal / sliding-window GQA attention over positions 0..S-1,
with a float32 running max, sum and accumulator; not causal
(an encoder's self-attention), k and v may hold their own number of keys
Sk (a cross-attention over an encoder's memory; the Pallas kernel takes
one S, so that shape is held against the reference's ``_sdpa``). Both types
run on the tensor cores: bfloat16 on wgmma, with the probabilities
rounded to bfloat16 for P·V as SDPA does; float32 on mma.sync as 3×TF32
(each operand split into a TF32 high and low part, three products), which
keeps float32's own error and the probabilities' float32 values. The
kernel reads q, k and v through their strides (the head_dim axis must be
contiguous), so callers may pass transposed views. Asked for it, the
forward also writes each row's log-sum-exp (``lse``, float32
``(B, H, S)``), the backward's input.

The backward (``flash_attention_bwd``) has no Pallas counterpart: the
reference trains by ``jax.grad`` of its jnp attention. It gives dQ (S
rows), dK and dV (Sk rows: a cross-attention's too), bit-identical from
run to run (no atomics; every sum in a fixed order). Both types run on the
tensor cores, a dK/dV kernel per (64 keys, query head, batch) and a dQ
kernel per (64 query rows, head, batch), with float32 per-head dK/dV
partials in a scratch buffer that a second pass sums over each group in
head order. bfloat16 runs on wgmma, P and dS entering
the products as a bf16 high and low part; float32 on mma.sync as 3×TF32,
like the forward. ``ops.flash_attention`` binds it to the forward in an
autograd Function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30

#: launches of the CUDA kernels since the last reset (see ``ops.launch_counts``)
launches = 0
bwd_launches = 0
#: the float32 routes' share of them (see ``ops.f32_launch_counts``)
f32_launches = 0
f32_bwd_launches = 0

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
#: the float32 routes' head dims: not kimi-k2's 112, which the bfloat16
#: routes pad to two 64-column blocks and the float32 routes' tiles do not
#: divide (ROADMAP.md Queue 1, item 9.11)
F32_HEAD_DIMS = (16, 32, 64, 96, 128, 256)


def _check(q, k, v, causal: bool = True, window: int = 0):
    """(B, H, K, S, Sk, hd) of q (B, H, S, hd) and k / v (B, K, Sk, hd).
    Sk != S (a cross-attention) only when not causal and not windowed."""
    B, H, S, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, K, Sk, hd) or v.shape != k.shape or H % K or Sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,H,S,hd)/(B,K,Sk,hd) with H % K == 0")
    if Sk != S and (causal or window):
        raise ValueError(f"flash_attention: {Sk} keys for {S} queries is a cross-attention, "
                         f"which is neither causal nor windowed (causal={causal}, "
                         f"window={window})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v must share a dtype")
    return B, H, K, S, Sk, hd


def _check_route(q, what: str) -> None:
    """The float32 kernels take F32_HEAD_DIMS only; a head dim they lack
    raises (the plain version is never taken for a CUDA tensor)."""
    hd = q.shape[-1]
    if q.dtype == torch.float32 and hd not in F32_HEAD_DIMS:
        raise ValueError(f"{what}: the float32 route has no head_dim {hd} (it runs "
                         f"{F32_HEAD_DIMS}; the bfloat16 route runs {HEAD_DIMS}): not ported "
                         f"yet (ROADMAP.md Queue 1, item 9.11)")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte copies can read ``t`` in place (the
    bfloat16 kernels' TMA tensor maps, the float32 kernels' cp.async): a
    16-byte aligned base and batch, head and sequence strides that are
    multiples of 16 bytes (8 bfloat16 or 4 float32 elements)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % step == 0 for s in t.stride()[:3])


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when :func:`tma_ready`, else a fresh contiguous copy
    (a new allocation is aligned; a contiguous view of an offset base may
    not be)."""
    return t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, return_lse: bool = False):
    """CUDA kernel. q: (B, H, S, hd); k/v: (B, K, Sk, hd), Sk = S unless
    not causal and not windowed. Returns (B, H, S, hd) in q's dtype, as a
    view of a (B, S, H, hd) buffer: the model's next step, the output
    projection, reads that layout without a copy. With ``return_lse``,
    returns (out, lse (B, H, S) float32)."""
    global launches, f32_launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, Sk, hd = _check(q, k, v, causal, window)
    _check_route(q, "flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis must have stride 1")
        # the bfloat16 kernel copies 16-byte chunks of each row
        if q.dtype == torch.bfloat16 and not tma_ready(t):
            raise ValueError(f"flash_attention: bfloat16 {name} needs a 16-byte aligned base "
                             f"and batch/head/sequence strides that are multiples of 8, got "
                             f"strides {t.stride()}")
    if q.dtype == torch.float32:  # the same kernel, on aligned copies where needed
        q, k, v = (tma_copy(t) for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    strides = _build.strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                 *out.stride()[:3])
    err = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, K, S, Sk, hd, strides,
        int(bool(causal)), int(window), 1.0 / math.sqrt(hd), _build.dtype_code(q),
        _build.stream_arg(q.device),
    )
    _build.check(err, "flash_attention")
    launches += 1
    if q.dtype == torch.float32:
        f32_launches += 1
    return out if lse is None else (out, lse)


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    """CUDA kernel. q, o, dout: (B, H, S, hd); k/v: (B, K, Sk, hd), one
    dtype, Sk = S unless not causal and not windowed (``_check``); lse: (B,
    H, S) float32 from the forward. Returns (dq, dk, dv) in the inputs'
    dtype, dq (B, H, S, hd) and dk / dv (B, K, Sk, hd), each a view of a
    (B, rows, heads, hd) buffer (the layout of the model's projections).
    The kernels read q, k, v and dout with 16-byte
    copies (bfloat16: TMA tensor maps; float32: cp.async): any of the four
    that they cannot read in place (:func:`tma_ready`; autograd's dout is
    often a strided view) is copied first, and the route does not change.
    o is read by element strides."""
    global bwd_launches, f32_bwd_launches
    if not all(t.is_cuda and t.device == q.device for t in (k, v, o, dout, lse)):
        raise ValueError("flash_attention_bwd: the CUDA kernel takes CUDA tensors on one device")
    B, H, K, S, Sk, hd = _check(q, k, v, causal, window)
    _check_route(q, "flash_attention_bwd")
    if o.shape != q.shape or dout.shape != q.shape or not (o.dtype == dout.dtype == q.dtype):
        raise ValueError(f"flash_attention_bwd: o {o.dtype} {tuple(o.shape)} and dout "
                         f"{dout.dtype} {tuple(dout.shape)} must be q's {q.dtype} "
                         f"{tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(B, H, S)}")
    q, k, v, o, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, dout))
    q, k, v, dout = (tma_copy(t) for t in (q, k, v, dout))
    # the per-head float32 dV and dK partials that the second pass sums
    part = torch.empty((2, B, H, Sk, hd), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = _build.strides_arg(*(s for t in (q, k, v, o, dout, dq, dk, dv)
                                   for s in t.stride()[:3]))
    err = _build.lib().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, K, S, Sk, hd, strides, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        _build.dtype_code(q), _build.stream_arg(q.device),
    )
    _build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    if q.dtype == torch.float32:
        f32_bwd_launches += 1
    return dq, dk, dv


def _mask(S: int, causal: bool, window: int, device, Sk: int = 0) -> torch.Tensor:
    """(S, Sk) visible pairs of queries 0..S-1 and keys 0..Sk-1 (Sk = S
    when 0)."""
    Sk = Sk or S
    qpos = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    kpos = torch.arange(Sk, dtype=torch.int32, device=device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """Plain version: naive full-matrix attention (``ref.attention_ref``; the
    reference's ``_sdpa`` for Sk != S); with ``return_lse``, also each
    row's log-sum-exp of its masked scores."""
    B, H, K, S, Sk, hd = _check(q, k, v, causal, window)
    g = H // K
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) / math.sqrt(hd)
    mask = _mask(S, causal, window, q.device, Sk)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_bwd_ref(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    """Plain version of the backward: the kernel's formulas on full score
    matrices in float32 (P = exp(s - lse) on the visible pairs, D =
    rowsum(dO * O), dS = P * (dO·Vᵀ - D)), dK and dV (Sk rows) summed
    over each group's query heads."""
    B, H, K, S, Sk, hd = _check(q, k, v, causal, window)
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf, of, gf = q.to(f32), o.to(f32), dout.to(f32)
    kk = torch.repeat_interleave(k, g, dim=1).to(f32)
    vv = torch.repeat_interleave(v, g, dim=1).to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    mask = _mask(S, causal, window, q.device, Sk)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), dtype=f32,
                                                                   device=q.device))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vv)
    ds = p * (dp - torch.sum(gf * of, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(B, K, g, Sk, hd).sum(dim=2)
    dv = dv.reshape(B, K, g, Sk, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

"""The kernels' shape-only path, for fake tensors (the dry run).

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``) has a shape,
a dtype and a device, and no storage: a fake ``cuda`` tensor reports
``device.type == "cuda"`` but has no address a kernel could read. Each
function here returns empty outputs (and, for the backward, the gradients)
with the kernel's shapes, dtypes and layouts, and reports the kernel's
FLOPs and bytes to the open counter (:mod:`repro_torch.roofline.counter`)
by the formulas of the bound that ``chip_smoke.py`` prints beside each
kernel row (``PERF.md`` §6): each input read once and each output written
once, and the operations of the kernel's arithmetic. It never runs the
plain version, which would hold what the kernel never holds (at a 32k
prompt a (B, H, S, S) score tensor).
"""
from __future__ import annotations

import torch

from repro_torch.roofline import counter

F32 = torch.float32


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs that ``flash_attention``'s mask keeps a (b, h)."""
    w = min(window, S) if window else S
    if not causal:  # query q keeps the keys above q - w: all but max(0, q - w + 1)
        return S * S - (S - w) * (S - w + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def rmsnorm(x, scale, eps: float = 1e-6):
    out = torch.empty_like(x)
    counter.kernel("rmsnorm", 4 * x.numel(), 2 * _bytes(x) + _bytes(scale))
    return out


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    dx = torch.empty_like(x)
    dscale = torch.empty(scale.shape, dtype=F32, device=x.device)
    counter.kernel("rmsnorm_bwd", 10 * x.numel(), 3 * _bytes(x) + 2 * _bytes(scale))
    return dx, dscale


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, return_lse: bool = False):
    B, H, S, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=F32, device=q.device) if return_lse else None
    counter.kernel("flash_attention", 4 * hd * visible_pairs(S, causal, window) * B * H,
                   2 * _bytes(q) + _bytes(k, v) + (_bytes(lse) if return_lse else 0))
    return out if lse is None else (out, lse)


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    B, H, S, hd = q.shape
    K = k.shape[1]
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, S, K, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    counter.kernel("flash_attention_bwd", 10 * hd * visible_pairs(S, causal, window) * B * H,
                   _bytes(q, k, v, o, dout, lse, dq, dk, dv))
    return dq, dk, dv


def flash_decode(q, k, v, kpos, pos: int, *, window: int = 0):
    """The kernel reads the valid slots only; a fake ``kpos`` has no values,
    so each row counts the slots a ring of the cache's length holds at
    ``pos`` (every position up to ``pos``, within the window)."""
    B, H, hd = q.shape
    K, W = k.shape[1], k.shape[2]
    n_valid = B * min(pos + 1, W, window or W)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    counter.kernel("flash_decode", 4 * hd * H * n_valid,
                   2 * _bytes(q) + 2 * n_valid * K * hd * k.element_size() + _bytes(kpos))
    return out


def wkv6(r, k, v, wlog, u, state):
    B, H, S, N = r.shape
    y = torch.empty((B, S, H, N), dtype=r.dtype, device=r.device).transpose(1, 2)
    state_out = torch.empty((B, H, N, N), dtype=F32, device=r.device)
    counter.kernel("wkv6", 4 * r.numel() * N,
                   _bytes(r, k, v, wlog, u) + 2 * _bytes(state) + _bytes(r))
    return y, state_out


def wkv6_bwd(r, k, v, wlog, u, state, dy, dstate_T):
    B, H, S, N = r.shape

    def like_y(dtype):
        return torch.empty((B, S, H, N), dtype=dtype, device=r.device).transpose(1, 2)

    grads = (like_y(r.dtype), like_y(r.dtype), like_y(r.dtype), like_y(F32),
             torch.empty((H, N), dtype=F32, device=r.device),
             torch.empty((B, H, N, N), dtype=F32, device=r.device))
    counter.kernel("wkv6_bwd", 10 * r.numel() * N,
                   2 * _bytes(r, k, v, dy, wlog) + _bytes(u, state, dstate_T, u, state))
    return grads


def rglru(log_a, m, h0):
    B, S, W = log_a.shape
    h_seq = torch.empty((B, S, W), dtype=F32, device=log_a.device)
    h_final = torch.empty((B, W), dtype=F32, device=log_a.device)
    counter.kernel("rglru", 3 * log_a.numel(),
                   _bytes(log_a, m, h0) + 4 * log_a.numel() + _bytes(h_final))
    return h_seq, h_final


def rglru_bwd(log_a, h_seq, h0, dh_seq, dh_final):
    B, S, W = log_a.shape
    dlog_a, dm = (torch.empty((B, S, W), dtype=log_a.dtype, device=log_a.device)
                  for _ in range(2))
    dh0 = torch.empty((B, W), dtype=F32, device=log_a.device)
    counter.kernel("rglru_bwd", 5 * log_a.numel(),
                   _bytes(log_a, h_seq, dh_seq, h0, dh_final, log_a, log_a, h0))
    return dlog_a, dm, dh0

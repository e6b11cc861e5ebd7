"""RG-LRU scan: the CUDA kernel ``csrc/rglru.cu`` and its plain version.

Replaces ``src/repro/kernels/rglru.py::rglru_scan`` (the Pallas kernel):
the per-channel recurrence ``h_t = exp(log_a_t) h_{t-1} + m_t`` from h0,
returning every h_t and the final h in float32. The kernel is bound by
bytes (see the note in the source); the plain version is the log-depth
associative scan of ``repro/models/rglru.py::rglru_scan`` in torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel since the last reset (see ``ops.launch_counts``)
launches = 0


def _check(log_a, m, h0):
    B, S, W = log_a.shape
    if m.shape != log_a.shape or h0.shape != (B, W):
        raise ValueError(f"rglru: log_a {tuple(log_a.shape)}, m {tuple(m.shape)}, "
                         f"h0 {tuple(h0.shape)} are not (B, S, W)/(B, S, W)/(B, W)")
    return B, S, W


def rglru(log_a, m, h0):
    """CUDA kernel. log_a, m: (B, S, W) float32; h0: (B, W) float32.
    Returns (h_seq (B, S, W), h_final (B, W)), float32."""
    global launches
    dev = log_a.device
    if not (log_a.is_cuda and m.device == dev and h0.device == dev):
        raise ValueError("rglru: the CUDA kernel takes CUDA tensors on one device")
    B, S, W = _check(log_a, m, h0)
    if not (log_a.dtype == m.dtype == h0.dtype == torch.float32):
        raise TypeError("rglru: log_a, m and h0 must be float32")
    log_a, m, h0 = log_a.contiguous(), m.contiguous(), h0.contiguous()
    h_seq = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, W), dtype=torch.float32, device=dev)
    err = _build.lib().rt_rglru(
        log_a.data_ptr(), m.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), h_final.data_ptr(),
        B, S, W, _build.stream_arg(dev),
    )
    _build.check(err, "rglru")
    launches += 1
    return h_seq, h_final


def rglru_ref(log_a, m, h0):
    """Plain version: h0 folded into step 0, then a Hillis-Steele scan of
    the pairs (a, m) under (a1, m1) . (a2, m2) = (a1 a2, m1 a2 + m2):
    log2(S) vectorised steps, no loop over tokens."""
    B, S, W = _check(log_a, m, h0)
    a = torch.exp(log_a.to(torch.float32))
    h = m.to(torch.float32).clone()
    h[:, 0] += a[:, 0] * h0.to(torch.float32)
    off = 1
    while off < S:
        h = torch.cat([h[:, :off], h[:, off:] + a[:, off:] * h[:, :-off]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h, h[:, -1].contiguous()

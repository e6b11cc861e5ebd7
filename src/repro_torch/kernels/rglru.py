"""RG-LRU scan: the CUDA kernel ``csrc/rglru.cu`` and its plain version.

Replaces ``src/repro/kernels/rglru.py::rglru_scan`` (the Pallas kernel):
the per-channel recurrence ``h_t = exp(log_a_t) h_{t-1} + m_t`` from h0,
returning every h_t and the final h in float32. log_a and m may be
float32 or bfloat16 (both the same), read in their type and computed in
float32, as the Pallas kernel casts them; h0 is taken in float32. The
kernel is bound by bytes (see the note in the source): a warp per slab of
SLAB channels carries h through the tokens while a ring of asynchronous
copies keeps the slab's next tiles in flight. The plain version is the
log-depth associative scan of ``repro/models/rglru.py::rglru_scan`` in
torch.

The backward (:func:`rglru_bwd`, the same source) is the reference's
gradient, ``jax.grad`` of that scan: the recurrence run in reverse token
order, ``g_t = dh_t + a_{t+1} g_{t+1}`` from the final h's gradient, with
``dm = g``, ``dlog_a_t = g_t a_t h_{t-1}`` (h_{t-1} from the forward's
h_seq) and ``dh0 = a_0 g_0``. Its plain version :func:`rglru_bwd_ref` runs
that reverse recurrence through :func:`rglru_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernels since the last reset (see ``ops.launch_counts``)
launches = 0
bwd_launches = 0

#: input types the kernel reads (log_a and m share one)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: channels a block carries (one warp, a channel per lane)
SLAB = 32
#: bytes of one channel's tokens in a tile of the ring (csrc/rglru.cu's ROW_BYTES)
ROW_BYTES = 128


def tile_tokens(elem: int) -> int:
    """Tokens in a tile of the kernel's ring, for inputs of ``elem`` bytes."""
    return ROW_BYTES // elem


def copy_bytes(W: int, elem: int, *ptrs: int) -> int:
    """The kernel's copy width: 16 bytes where every token row of the
    inputs starts 16-byte aligned (W * elem a multiple of 16 and every base
    pointer aligned), else 4."""
    return 16 if (W * elem) % 16 == 0 and all(p % 16 == 0 for p in ptrs) else 4


def _check(log_a, m, h0):
    B, S, W = log_a.shape
    if m.shape != log_a.shape or h0.shape != (B, W):
        raise ValueError(f"rglru: log_a {tuple(log_a.shape)}, m {tuple(m.shape)}, "
                         f"h0 {tuple(h0.shape)} are not (B, S, W)/(B, S, W)/(B, W)")
    return B, S, W


def kernel_inputs(log_a, m, h0):
    """log_a, m and h0 as the kernel takes them: log_a and m contiguous in
    one of KERNEL_DTYPES, on 4-byte aligned bases (a misaligned bf16 view
    is copied); h0 contiguous float32 (any floating h0 is cast, as the
    Pallas kernel's float32 scratch does). Anything else raises TypeError."""
    if log_a.dtype not in KERNEL_DTYPES or m.dtype != log_a.dtype:
        raise TypeError(f"rglru: log_a and m must share a dtype in {KERNEL_DTYPES}, got "
                        f"{log_a.dtype} and {m.dtype}")
    if not h0.is_floating_point():
        raise TypeError(f"rglru: h0 must be floating, got {h0.dtype}")
    log_a, m = (t.contiguous() for t in (log_a, m))
    log_a, m = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (log_a, m))
    return log_a, m, h0.to(torch.float32).contiguous()


def rglru(log_a, m, h0):
    """CUDA kernel. log_a, m: (B, S, W) float32 or bfloat16; h0: (B, W)
    floating. Returns (h_seq (B, S, W), h_final (B, W)), float32."""
    global launches
    dev = log_a.device
    if not (log_a.is_cuda and m.device == dev and h0.device == dev):
        raise ValueError("rglru: the CUDA kernel takes CUDA tensors on one device")
    B, S, W = _check(log_a, m, h0)
    log_a, m, h0 = kernel_inputs(log_a, m, h0)
    vec = copy_bytes(W, log_a.element_size(), log_a.data_ptr(), m.data_ptr())
    h_seq = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, W), dtype=torch.float32, device=dev)
    err = _build.lib().rt_rglru(
        log_a.data_ptr(), m.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), h_final.data_ptr(),
        B, S, W, _build.dtype_code(log_a), vec, _build.stream_arg(dev),
    )
    _build.check(err, "rglru")
    launches += 1
    return h_seq, h_final


def rglru_bwd(log_a, h_seq, h0, dh_seq, dh_final):
    """CUDA backward of :func:`rglru`. log_a: (B, S, W) float32 or bfloat16,
    as the forward took it; h_seq: the forward's (B, S, W) float32 output;
    h0: (B, W) float32; dh_seq (B, S, W) and dh_final (B, W): the
    gradients of h_seq and h_final, float32. All contiguous, on one device.
    Returns (dlog_a, dm) in log_a's dtype and dh0 float32. One launch."""
    global bwd_launches
    dev = log_a.device
    ts = (log_a, h_seq, h0, dh_seq, dh_final)
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("rglru_bwd: the CUDA kernel takes CUDA tensors on one device")
    B, S, W = log_a.shape
    if h_seq.shape != log_a.shape or dh_seq.shape != log_a.shape or \
            h0.shape != (B, W) or dh_final.shape != (B, W):
        raise ValueError(f"rglru_bwd: log_a {tuple(log_a.shape)}, h_seq {tuple(h_seq.shape)}, "
                         f"dh_seq {tuple(dh_seq.shape)}, h0 {tuple(h0.shape)}, dh_final "
                         f"{tuple(dh_final.shape)} are not (B, S, W) x 3 / (B, W) x 2")
    if log_a.dtype not in KERNEL_DTYPES or any(t.dtype != torch.float32 for t in ts[1:]):
        raise TypeError(f"rglru_bwd: log_a in {KERNEL_DTYPES} and float32 h_seq, h0, dh_seq, "
                        f"dh_final, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_bwd: every tensor must be contiguous")
    if log_a.data_ptr() % 4:  # a bf16 view on an odd element: 4-byte copies need 4
        log_a = log_a.clone()
    vec = copy_bytes(W, log_a.element_size(), log_a.data_ptr(), h_seq.data_ptr(),
                     dh_seq.data_ptr())
    dlog_a, dm = (torch.empty((B, S, W), dtype=log_a.dtype, device=dev) for _ in range(2))
    dh0 = torch.empty((B, W), dtype=torch.float32, device=dev)
    err = _build.lib().rt_rglru_bwd(
        *(t.data_ptr() for t in (log_a, h_seq, h0, dh_seq, dh_final, dlog_a, dm, dh0)),
        B, S, W, _build.dtype_code(log_a), vec, _build.stream_arg(dev),
    )
    _build.check(err, "rglru_bwd")
    bwd_launches += 1
    return dlog_a, dm, dh0


def blocks_per_sm(dtype: torch.dtype, vec: int) -> int:
    """Blocks of the kernel's (dtype, vec) instantiation resident on one SM
    of the current CUDA device (a grid has B * ceil(W / SLAB) blocks)."""
    out = ctypes.c_int(0)
    err = _build.lib().rt_rglru_blocks_per_sm(_build.DTYPE_CODES[str(dtype)], vec,
                                              ctypes.byref(out))
    _build.check(err, "rglru occupancy")
    return out.value


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


def rglru_bwd_ref(log_a, h_seq, h0, dh_seq, dh_final):
    """Plain version of :func:`rglru_bwd`, vectorised: g is the forward's
    recurrence run in reverse token order through :func:`rglru_ref`, on
    the coefficients one token later (log a_{t+1}; 0 after the last token)
    from dh_final; then dm = g, dlog_a = (a g) h_{t-1} and dh0 = a_0 g_0,
    in float32. The same outputs and dtypes."""
    f32 = torch.float32
    la = log_a.to(f32)
    la_next = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    g = rglru_ref(la_next.flip(1), dh_seq.to(f32).flip(1), dh_final.to(f32))[0].flip(1)
    ag = torch.exp(la) * g
    h_prev = torch.cat([h0.to(f32)[:, None], h_seq.to(f32)[:, :-1]], dim=1)
    return (ag * h_prev).to(log_a.dtype), g.to(log_a.dtype), ag[:, 0].contiguous()
